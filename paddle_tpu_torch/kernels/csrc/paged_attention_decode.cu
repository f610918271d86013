// Paged attention at decode (one query token per slot) for Hopper (sm_90a):
// split-K on the CUDA cores, then a deterministic merge.
//
// Replaces the TPU kernel `_paged_kernel` (paddle_tpu/kernels/pallas/
// paged_attention.py:46, launched by `_paged_pallas` at :91) for W = 1.
// Same function: q [S,1,nh,hd] attends to arenas [P,PL,kvh,hd] through the
// page table tables [S,B]; key j is visible iff j <= pos[s]; GQA when
// kvh < nh; a slot that sees no key gives 0. fp32 or bf16, all arithmetic
// in fp32, one rounding of o.
//
// What bounds it on the H100: bytes. Every visible K/V byte is read once
// for rep <= 8 query rows (~1 FLOP per byte, against the ~295 at which bf16
// tensor cores would become the limit), so the floor is the visible K/V
// bytes over 3.35 TB/s.
//
// What the design does about it: keep enough bytes in flight on all 132 SMs,
// and read each byte once.
//  - The grid is (split, kv head, slot). A slot's visible pages are cut into
//    runs of equal length, one per split, computed on the device from pos: as
//    many runs as the slot has split_keys (256) visible keys, at most n_split,
//    which the host picks from S * kvh so that the card holds about 8 blocks
//    per SM; both numbers come from the host, where split_bounds plans the
//    same runs. So a long context spreads over all splits and a short one does
//    not pay for many partials. A split that starts past the slot's last
//    visible page reads nothing and writes an empty partial (m = -1e30, l =
//    0).
//  - One block serves all rep query heads of its kv head (rep <= 8), so each
//    K/V byte is read once. Its registers hold one query row (MHA, the serving
//    model) or eight, of which the first rep are used. Its page ids come from
//    `tables` once per page, into shared memory. q is read where it lies (a
//    slot stride, so the serving step's view into its fused QKV projection
//    needs no copy).
//  - Lanes spread over keys as well as over dims: a key row is read by G lanes
//    with 16-byte loads (bf16 at hd 128: 16 lanes; 32 for a row of 17 to 32
//    chunks, 32 lanes of two chunks for a longer one; a shorter row leaves
//    lanes idle), so a block folds 128 / G keys side by side, and each lane
//    issues the loads of kUnroll keys (K and V) before it uses any: 2 *
//    kUnroll 16-byte loads in flight per thread. Scores are summed over the G
//    lanes by shuffles; the online softmax takes the kUnroll keys at once (one
//    rescale per group of keys, in log2 units with exp2).
//  - The block's groups merge through shared memory, and the block writes its
//    split's partial (o not normalised, m, l) in fp32. A second kernel merges
//    the splits of each (slot, head) in split order (decode_common.cuh,
//    shared with flash_decode.cu): no atomics, bitwise repeatable.
//    `merge_partials_plain` in flash_attention.py is the same merge in
//    PyTorch.

#include "decode_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;  // keys each lane loads before it folds them

// One split of one (slot, kv head): lanes t of group grp (G lanes) own the
// 16-byte chunks c = t + v * G (v < NV) of a key row; R = 1 (rep 1) or 8
// query rows in registers, of which the first rep are used.
// smem: [128 / G][R][hd + 2] floats (each group's acc, m, l), then the
// split's page ids.
template <typename T, int G, int NV, int R>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ tables,
                    const int* __restrict__ pos, float* __restrict__ part_o,
                    float2* __restrict__ part_ml, long long q_stride, int nh,
                    int kvh, int hd, int PL, int B, int n_split,
                    int split_keys, float scale_log2) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KPB = kThreads / G;  // keys folded side by side
  constexpr int E = NV * VEC;        // elements per lane
  extern __shared__ float smf[];
  const int split = blockIdx.x, g = blockIdx.y, s = blockIdx.z;
  const int rep = nh / kvh;
  const int rows = R == 1 ? 1 : rep;  // uniform over the block
  const int grp = threadIdx.x / G, t = threadIdx.x % G;

  // this split's keys [k_first, k_end), as split_bounds computes them
  const int lim = pos[s];
  const int n = lim < 0 ? 0 : min(lim + 1, B * PL);
  const int pages = (n + PL - 1) / PL;
  const int used = max(1, min(n_split, (n + split_keys - 1) / split_keys));
  const int per = (pages + used - 1) / used;
  const int p_first = split * per;
  const int k_first = p_first * PL;
  const int k_end = min(k_first + per * PL, n);
  int* spage = reinterpret_cast<int*>(smf + KPB * R * (hd + 2));
  for (int i = threadIdx.x; i < min(per, pages - p_first); i += kThreads)
    spage[i] = tables[(size_t)s * B + p_first + i];

  float qf[R][E], acc[R][E], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = pt::kNeg;
    l[r] = 0.f;
    const T* qr = q + s * q_stride + (size_t)(g * rep + r) * hd;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (t + c * G) * VEC;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r < rep && col < hd) raw = *reinterpret_cast<const uint4*>(qr + col);
      pt::unpack16<T>(raw, &qf[r][c * VEC]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        qf[r][c * VEC + i] *= scale_log2;
        acc[r][c * VEC + i] = 0.f;
      }
    }
  }
  __syncthreads();

  const size_t key_stride = (size_t)kvh * hd;
  const T* kg = k + (size_t)g * hd;
  const T* vg = v + (size_t)g * hd;
  // uniform over the block, so every lane of a warp takes every shuffle
  for (int base = k_first; base < k_end; base += KPB * kUnroll) {
    uint4 kr[kUnroll][NV], vr[kUnroll][NV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * KPB + grp - k_first;  // key within the split
      const bool ok = j < k_end - k_first;
      const size_t row =
          ok ? (size_t)spage[j / PL] * PL + j % PL : 0;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = (t + c * G) * VEC;
        kr[u][c] = vr[u][c] = make_uint4(0, 0, 0, 0);
        if (ok && col < hd) {
          kr[u][c] = __ldg(reinterpret_cast<const uint4*>(
              kg + row * key_stride + col));
          vr[u][c] = __ldg(reinterpret_cast<const uint4*>(
              vg + row * key_stride + col));
        }
      }
    }
    float sc[R][kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[E];
#pragma unroll
      for (int c = 0; c < NV; ++c) pt::unpack16<T>(kr[u][c], &kf[c * VEC]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows) continue;
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) d = fmaf(qf[r][i], kf[i], d);
        sc[r][u] = d;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) continue;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          sc[r][u] += __shfl_xor_sync(0xffffffffu, sc[r][u], o);
    }

    float p[R][kUnroll];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) continue;
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (base + u * KPB + grp < k_end) mx = fmaxf(mx, sc[r][u]);
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[r][u] = base + u * KPB + grp < k_end ? exp2f(sc[r][u] - mx) : 0.f;
        l[r] += p[r][u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[E];
#pragma unroll
      for (int c = 0; c < NV; ++c) pt::unpack16<T>(vr[u][c], &vf[c * VEC]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows) continue;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[r][i] = fmaf(p[r][u], vf[i], acc[r][i]);
      }
    }
  }

  // park each group's state: [grp][r][hd + 2] = (acc..., m, l)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) continue;
    float* row = smf + ((size_t)grp * R + r) * (hd + 2);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (t + c * G) * VEC;
      if (col < hd)
#pragma unroll
        for (int i = 0; i < VEC; ++i) row[col + i] = acc[r][c * VEC + i];
    }
    if (t == 0) {
      row[hd] = m[r];
      row[hd + 1] = l[r];
    }
  }
  __syncthreads();
  // merge the groups in group order; the block's partial for its split
  for (int idx = threadIdx.x; idx < rep * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd;
    float M = pt::kNeg;
    for (int x = 0; x < KPB; ++x)
      M = fmaxf(M, smf[((size_t)x * R + r) * (hd + 2) + hd]);
    float L = 0.f, A = 0.f;
    for (int x = 0; x < KPB; ++x) {
      const float* row = smf + ((size_t)x * R + r) * (hd + 2);
      const float c = exp2f(row[hd] - M);
      L = fmaf(row[hd + 1], c, L);
      A = fmaf(row[d], c, A);
    }
    const size_t at = ((size_t)s * nh + g * rep + r) * n_split + split;
    part_o[at * hd + d] = A;
    if (d == 0) part_ml[at] = make_float2(M, L);
  }
}

// out[s, 0, h, :] = sum_i o_i exp2(m_i - M) / sum_i l_i exp2(m_i - M) over
// the splits i in order (M = max m_i), 0 where the sum of l is 0.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_o,
                                    const float2* __restrict__ part_ml,
                                    T* __restrict__ out, int hd,
                                    int n_split) {
  const size_t sh = blockIdx.x;  // s * nh + h
  const float2* ml = part_ml + sh * n_split;
  const float* po = part_o + sh * n_split * hd;
  const float M = pt::splits_max(ml, n_split);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float L;
    const float A = pt::splits_sum(ml, po, n_split, hd, d, M, &L);
    out[sh * hd + d] = pt::from_f<T>(L > 0.f ? A / L : 0.f);
  }
}

template <typename T, int G, int NV, int R>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* pos, void* out, float* part_o, float2* part_ml,
           long long qs, int S, int nh, int kvh, int hd, int PL, int B,
           int n_split, int split_keys, float scale, cudaStream_t stream) {
  auto kernel = decode_split_kernel<T, G, NV, R>;
  // a split may own every page of the table
  const size_t smem =
      sizeof(float) * (kThreads / G) * R * (hd + 2) + sizeof(int) * B;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(n_split, kvh, S), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, tables, pos, part_o, part_ml, qs,
      nh, kvh, hd, PL, B, n_split, split_keys, scale * pt::kLog2e);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  decode_merge_kernel<T><<<S * nh, hd < 128 ? hd : 128, 0, stream>>>(
      part_o, part_ml, (T*)out, hd, n_split);
  return (int)cudaGetLastError();
}

// G lanes per key row: the 16-byte chunks of a row (hd / VEC of them),
// rounded up to 16 or 32 lanes; a row of more than 32 chunks (fp32 at
// hd > 128) takes two chunks per lane. R: one query row per kv head, or up
// to eight. Ten instances in all.
template <typename T>
int by_shape(const void* q, const void* k, const void* v, const int* tables,
             const int* pos, void* out, float* po, float2* pml, long long qs,
             int S, int nh, int kvh, int hd, int PL, int B, int n_split,
             int split_keys, float scale, cudaStream_t st) {
  const int chunks = hd / (16 / (int)sizeof(T));
  const bool one = nh == kvh;
#define PT_DECODE(G, NV, R)                                                   \
  launch<T, G, NV, R>(q, k, v, tables, pos, out, po, pml, qs, S, nh, kvh, hd, \
                      PL, B, n_split, split_keys, scale, st)
  if (chunks <= 16) return one ? PT_DECODE(16, 1, 1) : PT_DECODE(16, 1, 8);
  if (chunks <= 32) return one ? PT_DECODE(32, 1, 1) : PT_DECODE(32, 1, 8);
  // only fp32 rows exceed 32 chunks (bf16 at hd 256 is 32)
  if constexpr (sizeof(T) == 4)
    return one ? PT_DECODE(32, 2, 1) : PT_DECODE(32, 2, 8);
  return (int)cudaErrorInvalidValue;
#undef PT_DECODE
}

}  // namespace

// q [S,1,nh,hd] with slot stride q_stride elements (heads packed, a
// multiple of 16 bytes), arenas [P,PL,kvh,hd], out [S,1,nh,hd] contiguous;
// tables [S,B] and pos [S] int32; part_o [S,nh,n_split,hd] and part_ml
// [S,nh,n_split,2] fp32 scratch. hd a multiple of 8 up to 256, nh / kvh <= 8,
// every pointer 16-byte aligned; a slot gets one split per split_keys
// visible keys, at most n_split. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int pt_paged_attention_decode(const void* q, const void* k,
                                         const void* v, const void* tables,
                                         const void* pos, void* out,
                                         void* part_o, void* part_ml,
                                         long long q_stride, int S, int nh,
                                         int kvh, int hd, int PL, int B,
                                         int n_split, int split_keys,
                                         float scale, int dtype,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S * nh == 0) return (int)cudaGetLastError();
  if (hd % 8 || hd > 256 || nh % kvh || nh / kvh > 8 || n_split < 1 ||
      split_keys < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return by_shape<float>(q, k, v, (const int*)tables, (const int*)pos, out,
                           (float*)part_o, (float2*)part_ml, q_stride, S, nh,
                           kvh, hd, PL, B, n_split, split_keys, scale, st);
  return by_shape<__nv_bfloat16>(q, k, v, (const int*)tables,
                                 (const int*)pos, out, (float*)part_o,
                                 (float2*)part_ml, q_stride, S, nh, kvh, hd,
                                 PL, B, n_split, split_keys, scale, st);
}

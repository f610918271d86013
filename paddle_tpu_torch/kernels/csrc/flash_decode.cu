// Single-row flash attention (decode) for Hopper (sm_90a): split-K on the
// CUDA cores, then a deterministic merge.
//
// Replaces the TPU kernel `_fwd_kernel` (paddle_tpu/kernels/flash_attention.py
// :64, launched by `_flash_fwd` at :117, pallas_call at :124) at one query
// row. Same function: q [b,1,h,d] against k, v [b,sk,h,d]; under `causal`
// key j is visible iff j <= offset, otherwise every key is. Returns o in q's
// type and lse fp32 (natural log); a row that sees no key (offset < 0) gives
// o = 0 and lse = -1e30. fp32 or bf16, all arithmetic in fp32, one rounding
// of o; any head dim up to 256 whose rows are whole 16-byte chunks.
//
// What bounds it on the H100: bytes. Each visible K/V byte is read once for
// one query row (~1 FLOP per byte, against the ~295 at which bf16 tensor
// cores would become the limit), so the floor is the visible K/V bytes over
// 3.35 TB/s: 3.1 us for bh 32 x 640 keys x d 128 in bf16.
//
// What the design does about it: keep enough bytes in flight on all 132 SMs,
// read each byte once, and copy nothing.
//  - The grid is (split, bh). The host cuts the visible keys into runs of
//    split_len (a multiple of 32, from bh and the key count alone, for about
//    2 blocks per SM; decode_plan in flash_attention.py), so bh 32 at 640
//    keys runs 224 blocks of 96 keys, where flash_attention.cu runs 32. A
//    split past the last visible key writes an empty partial (m = -1e30,
//    l = 0). More, shorter splits cost more than they gain: each adds a
//    partial to write and merge, and a block's turns are pipelined.
//  - Lanes spread over keys as well as over dims, as in the paged decode
//    kernel: a key row is read by G lanes with 16-byte loads (bf16 at d 128:
//    16 lanes; 8 for rows of up to 8 chunks, 32 for up to 32, 32 lanes of two
//    chunks for fp32 past d 128), a block folds 128 / G keys side by side,
//    and each lane issues the K and V loads of kUnroll keys before it uses
//    any, and those of its next turn before it folds this one. Scores are
//    summed over the G lanes by shuffles; the online softmax takes the
//    kUnroll keys at once, in log2 units with exp2.
//  - q, k, v and o are addressed through their (batch, seq, head) strides, so
//    the paddle layout [b, s, h, d] is read where it lies: a decode step's q
//    is a view into its fused QKV projection and k, v are its cache, and
//    none of them is copied into [bh, s, d]. A stride of 0 over heads (kv
//    heads expanded for GQA) reads the shared row.
//  - The block's groups merge through shared memory and the block writes its
//    split's partial (o not normalised, m, l) in fp32. A second kernel merges
//    each row's splits in split order (decode_common.cuh, shared with the
//    paged decode kernel): no atomics, bitwise repeatable. It is launched as
//    a programmatic dependent of the first (Hopper's griddepcontrol), so its
//    launch overlaps the split kernel's tail and it waits on the device for
//    the partials. flash_decode_plain in flash_attention.py computes the
//    same plan, partials and merge in PyTorch.
//  - A block issues its first keys' K/V loads before it loads q, so the two
//    latencies overlap: at these sizes each block folds a turn or two, and
//    the kernel is a chain of latencies as much as a stream of bytes.

#include "decode_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;  // keys each lane loads before it folds them

// Strides in elements of the four tensors (batch, seq, head; the head dim is
// contiguous). q's seq stride is never used (one row).
struct Strides {
  long long qb, qh, kb, ks, kh, vb, vs, vh, ob, oh;
};

// One split of one (batch, head) row: lane t of group grp (G lanes) owns the
// 16-byte chunks c = t + i * G (i < NV) of a key row.
// smem: [128 / G][hd + 2] floats (each group's acc, m, l).
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ part_o,
                          float2* __restrict__ part_ml, Strides st, int H,
                          int hd, int n_keys, int split_len, int n_split,
                          float scale_log2) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KPB = kThreads / G;  // keys folded side by side
  constexpr int E = NV * VEC;        // elements per lane
  extern __shared__ float smf[];
  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int grp = threadIdx.x / G, t = threadIdx.x % G;
  const int k_first = split * split_len;
  const int k_end = min(k_first + split_len, n_keys);

  // the merge kernel may start launching now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");

  const T* kr0 = k + b * st.kb + h * st.kh;
  const T* vr0 = v + b * st.vb + h * st.vh;
  uint4 kr[kUnroll][NV], vr[kUnroll][NV];
  auto load_keys = [&](int base, uint4 (&kk)[kUnroll][NV],
                       uint4 (&vv)[kUnroll][NV]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * KPB + grp;
      const bool ok = j < k_end;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = (t + c * G) * VEC;
        kk[u][c] = vv[u][c] = make_uint4(0, 0, 0, 0);
        if (ok && col < hd) {
          kk[u][c] = __ldg(reinterpret_cast<const uint4*>(
              kr0 + (long long)j * st.ks + col));
          vv[u][c] = __ldg(reinterpret_cast<const uint4*>(
              vr0 + (long long)j * st.vs + col));
        }
      }
    }
  };
  // the first turn's K/V loads go out before q's, so their latencies
  // overlap
  load_keys(k_first, kr, vr);

  float qf[E], acc[E], m = pt::kNeg, l = 0.f;
  const T* qr = q + b * st.qb + h * st.qh;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int col = (t + c * G) * VEC;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (col < hd) raw = *reinterpret_cast<const uint4*>(qr + col);
    pt::unpack16<T>(raw, &qf[c * VEC]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qf[c * VEC + i] *= scale_log2;
      acc[c * VEC + i] = 0.f;
    }
  }

  // uniform over the block, so every lane of a warp takes every shuffle
  for (int base = k_first; base < k_end; base += KPB * kUnroll) {
    // the next turn's loads go out before this turn's keys are folded
    uint4 kn[kUnroll][NV], vn[kUnroll][NV];
    const bool more = base + KPB * kUnroll < k_end;
    if (more) load_keys(base + KPB * kUnroll, kn, vn);
    float sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[E];
#pragma unroll
      for (int c = 0; c < NV; ++c) pt::unpack16<T>(kr[u][c], &kf[c * VEC]);
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) d = fmaf(qf[i], kf[i], d);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      sc[u] = d;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u * KPB + grp < k_end) mx = fmaxf(mx, sc[u]);
    const float alpha = exp2f(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p =
          base + u * KPB + grp < k_end ? exp2f(sc[u] - mx) : 0.f;
      l += p;
      float vf[E];
#pragma unroll
      for (int c = 0; c < NV; ++c) pt::unpack16<T>(vr[u][c], &vf[c * VEC]);
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          kr[u][c] = kn[u][c];
          vr[u][c] = vn[u][c];
        }
    }
  }

  // park each group's state: [grp][hd + 2] = (acc..., m, l)
  float* row = smf + (size_t)grp * (hd + 2);
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int col = (t + c * G) * VEC;
    if (col < hd)
#pragma unroll
      for (int i = 0; i < VEC; ++i) row[col + i] = acc[c * VEC + i];
  }
  if (t == 0) {
    row[hd] = m;
    row[hd + 1] = l;
  }
  __syncthreads();
  // merge the groups in group order: the block's partial for its split
  const size_t at = (size_t)bh * n_split + split;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float M = pt::kNeg;
    for (int x = 0; x < KPB; ++x) M = fmaxf(M, smf[(size_t)x * (hd + 2) + hd]);
    float L = 0.f, A = 0.f;
    for (int x = 0; x < KPB; ++x) {
      const float* r = smf + (size_t)x * (hd + 2);
      const float c = exp2f(r[hd] - M);
      L = fmaf(r[hd + 1], c, L);
      A = fmaf(r[d], c, A);
    }
    part_o[at * hd + d] = A;
    if (d == 0) part_ml[at] = make_float2(M, L);
  }
}

// o[b, 0, h, :] = sum_i o_i exp2(m_i - M) / sum_i l_i exp2(m_i - M) over the
// splits in order, 0 where the sum of l is 0; lse = (M + log2 L) ln 2, -1e30
// where L is 0 (written only when `lse` is given).
template <typename T>
__global__ void flash_decode_merge_kernel(const float* __restrict__ part_o,
                                          const float2* __restrict__ part_ml,
                                          T* __restrict__ o,
                                          float* __restrict__ lse,
                                          Strides st, int H, int hd,
                                          int n_split) {
  // launched while the split kernel runs: wait until its partials are in
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float2* ml = part_ml + (size_t)bh * n_split;
  const float* po = part_o + (size_t)bh * n_split * hd;
  const float M = pt::splits_max(ml, n_split);
  T* orow = o + b * st.ob + h * st.oh;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float L;
    const float A = pt::splits_sum(ml, po, n_split, hd, d, M, &L);
    orow[d] = pt::from_f<T>(L > 0.f ? A / L : 0.f);
    if (d == 0 && lse) lse[bh] = L > 0.f ? (M + log2f(L)) * pt::kLn2 : pt::kNeg;
  }
}

template <typename T, int G, int NV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* part_o, float2* part_ml, const Strides& st, int B, int H,
           int hd, int n_keys, int split_len, int n_split, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kThreads / G) * (hd + 2);
  flash_decode_split_kernel<T, G, NV>
      <<<dim3(n_split, B * H), kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, part_o, part_ml, st, H, hd,
          n_keys, split_len, n_split, scale * pt::kLog2e);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  // programmatic dependent launch: the merge's blocks are set up while the
  // split kernel's last blocks run, instead of after it ends
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(hd < 128 ? hd : 128);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* po = part_o;
  const float2* pml = part_ml;
  return (int)cudaLaunchKernelEx(&cfg, flash_decode_merge_kernel<T>, po, pml,
                                 (T*)o, lse, st, H, hd, n_split);
}

// G lanes per key row: the row's 16-byte chunks rounded up to 8, 16 or 32
// lanes; fp32 rows of more than 32 chunks (d > 128) take two chunks a lane.
// Seven instances in all.
template <typename T>
int by_shape(const void* q, const void* k, const void* v, void* o,
             float* lse, float* po, float2* pml, const Strides& st, int B,
             int H, int hd, int n_keys, int split_len, int n_split,
             float scale, cudaStream_t s) {
  const int chunks = hd / (16 / (int)sizeof(T));
#define PT_DECODE(G, NV)                                                  \
  launch<T, G, NV>(q, k, v, o, lse, po, pml, st, B, H, hd, n_keys,        \
                   split_len, n_split, scale, s)
  if (chunks <= 8) return PT_DECODE(8, 1);
  if (chunks <= 16) return PT_DECODE(16, 1);
  if (chunks <= 32) return PT_DECODE(32, 1);
  if constexpr (sizeof(T) == 4) return PT_DECODE(32, 2);
  return (int)cudaErrorInvalidValue;
#undef PT_DECODE
}

}  // namespace

// q [B,1,H,hd], k and v [B,sk,H,hd], o [B,1,H,hd], each through its
// (batch, seq, head) strides in elements (head dim contiguous; every row
// start 16-byte aligned, which the wrapper checks); lse [B*H] fp32 or null;
// part_o [B*H, n_split, hd] and part_ml [B*H, n_split, 2] fp32 scratch.
// The first n_keys keys are visible; split i owns keys [i * split_len,
// (i + 1) * split_len), and n_split * split_len must cover n_keys. hd * the
// element size a multiple of 16 bytes, hd <= 256. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int pt_flash_decode(
    const void* q, const void* k, const void* v, void* o, void* lse,
    void* part_o, void* part_ml, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sh, int B,
    int H, int hd, int n_keys, int split_len, int n_split, float scale,
    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B * H == 0) return (int)cudaGetLastError();
  const int esz = dtype == 0 ? 4 : 2;
  if (hd < 1 || hd > 256 || (hd * esz) % 16 || n_split < 1 ||
      split_len < 1 || n_keys < 0 ||
      (long long)n_split * split_len < n_keys)
    return (int)cudaErrorInvalidValue;
  const Strides st{q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh};
  if (dtype == 0)
    return by_shape<float>(q, k, v, o, (float*)lse, (float*)part_o,
                           (float2*)part_ml, st, B, H, hd, n_keys, split_len,
                           n_split, scale, s);
  return by_shape<__nv_bfloat16>(q, k, v, o, (float*)lse, (float*)part_o,
                                 (float2*)part_ml, st, B, H, hd, n_keys,
                                 split_len, n_split, scale, s);
}

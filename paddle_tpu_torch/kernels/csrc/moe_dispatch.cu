// Fused MoE routing and row movement for Hopper (sm_90a): the routing
// kernel, the row gather and the top-k weighted combine.
//
// Replaces the TPU kernels of paddle_tpu/kernels/pallas/moe_dispatch.py:
//   routing `_routing_kernel` (:59), launched by `_routing_pallas` (:114,
//           call :119): gate logits x @ wg in fp32, softmax, iterative
//           top-k (ties to the lowest expert, as argmax), renormalisation by
//           max(sum, 1e-9), each (token, choice)'s position in its expert's
//           row block in token-major order (row r = t * k + c; the order of
//           a stable argsort of the experts), per-expert counts, and the
//           aux statistics me (probability sums) and ce (top-1 counts);
//   gather  `_gather_kernel` (:235), launched by `_gather_rows` (:240,
//           call :254): out[i] = src[idx[i]], whole rows;
//   combine `_make_combine_kernel` (:261), launched by `_combine_rows`
//           (:272, call :294): out[t] = sum_c gates[t, c] * y[dest2[t, c]]
//           in fp32, cast to the output's type.
//
// What bounds them on the H100: bytes. Routing reads x once ([8192, 1536]
// bf16, 25 MB) for 0.2 GFLOP of fp32 logits; gather and combine move rows
// with one multiply-add per element at most.
//
// Routing. The TPU kernel carries the per-expert counters across its
// sequential grid. Hopper blocks run in parallel, so the positions come in
// two passes, both deterministic (no atomics: under activation recompute the
// second forward must route every token exactly as the first):
//   1. route_local_kernel: a block of 256 threads takes 32 tokens; the
//      logits are a small tiled product over h (x and wg chunks in shared
//      memory, each output summed over h in ascending order), one warp per
//      token does softmax and top-k, and thread j counts expert j over the
//      block's rows in order, giving each row its position inside the block
//      and the block's count, probability sum and top-1 count for j;
//   2. route_scan_kernel (one block): an exclusive scan of the block counts
//      per expert over the blocks (warp shuffles, in block order) gives
//      each block's base, the totals give the counts, me and ce are summed
//      in block order; then every row adds its block's base.
// Gather. What bounds it: bytes, each distinct source row read once and
// each output row written once (16384 rows of 3 KB at the MoE step, 0.0226
// ms over 3.35 TB/s). A warp that loads one 16-byte vector per lane and
// stores it before the next load, reading the row's index first, keeps
// only 512 bytes in flight and waits on the index before any data. So a
// warp takes kGatherRows rows at a time and each lane issues all of its
// loads of those rows (NV vectors per row, an instance per NV) before any
// store, while the indices of the warp's next rows are read ahead. Rows
// wider than 8 vectors a lane take the NV = 8 instance in turns along the
// row. Stores are streaming (`st.global.cs`, evict first): the output is
// not read again by this kernel, and on the H100 that measured 4% faster
// than plain stores at the MoE shape. The grid is the blocks the card keeps
// resident (its SM count, from the caller, times the occupancy), each warp
// striding over the rows. An
// optional fp32 row scale (the combine's backward: d_ys = gate * d_out
// gathered) multiplies each element in fp32 and rounds once to the rows'
// type, bit for bit `(gather.float() * scale[:, None]).to(dtype)`; it is a
// template flag, so the plain gather stays a raw copy.
// Combine: one warp per output row, 16-byte vector loads and stores along
// the row.

#include <math.h>

#include "attention_common.cuh"
#include "vec16.cuh"

namespace {

constexpr int kTokens = 32;   // tokens per routing block
constexpr int kThreads = 256;
constexpr int kChunk = 64;    // h per step of the logits product
constexpr int kMaxExperts = 128;
constexpr int kMaxTopK = 8;
constexpr int kScanThreads = 1024;
constexpr int kRowWarps = 8;  // warps per gather/combine block
constexpr int kGatherRows = 2;  // rows a gather warp keeps in flight

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Shared memory (dynamic): probs [kTokens][e] (logits, then probabilities),
// ws [kChunk][e], xs [kTokens][kChunk + 1], sel [kTokens * k].
template <typename T>
__global__ void __launch_bounds__(kThreads)
route_local_kernel(const T* __restrict__ x, const T* __restrict__ wg, int n,
                   int h, int e, int k, float* __restrict__ gv,
                   int* __restrict__ gi, int* __restrict__ pos,
                   int* __restrict__ blk_cnt, float* __restrict__ blk_me,
                   int* __restrict__ blk_ce) {
  extern __shared__ __align__(16) float smem[];
  float* probs = smem;
  float* ws = probs + kTokens * e;
  float* xs = ws + kChunk * e;
  int* sel = reinterpret_cast<int*>(xs + kTokens * (kChunk + 1));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int t0 = b * kTokens;
  const int nt = min(kTokens, n - t0);

  // 1. logits [kTokens, e] = x[t0 : t0 + nt] @ wg, fp32, h ascending
  constexpr int kOut = kTokens * kMaxExperts / kThreads;
  float acc[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) acc[o] = 0.f;
  const int outs = kTokens * e;
  for (int c0 = 0; c0 < h; c0 += kChunk) {
    __syncthreads();
    for (int i = tid; i < kTokens * kChunk; i += kThreads) {
      const int t = i / kChunk, c = i % kChunk;
      xs[t * (kChunk + 1) + c] =
          (t < nt && c0 + c < h) ? pt::to_f(x[(long long)(t0 + t) * h + c0 + c])
                                 : 0.f;
    }
    for (int i = tid; i < kChunk * e; i += kThreads) {
      const int c = i / e;
      ws[i] = c0 + c < h ? pt::to_f(wg[(long long)(c0 + c) * e + i % e]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int idx = tid + o * kThreads;
      if (idx < outs) {
        const int t = idx / e, j = idx % e;
        const float* xr = xs + t * (kChunk + 1);
        float a = acc[o];
        for (int c = 0; c < kChunk; ++c) a = fmaf(xr[c], ws[c * e + j], a);
        acc[o] = a;
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int idx = tid + o * kThreads;
    if (idx < outs) probs[idx] = acc[o];
  }
  __syncthreads();

  // 2. softmax and top-k, one warp per token; lane l owns experts l + 32q
  for (int t = warp; t < nt; t += kThreads / 32) {
    float* pr = probs + t * e;
    float mx = -INFINITY;
    for (int j = lane; j < e; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float s = 0.f;
    for (int j = lane; j < e; j += 32) {
      const float p = expf(pr[j] - mx);
      pr[j] = p;
      s += p;
    }
    s = pt::warp_sum(s);
    for (int j = lane; j < e; j += 32) pr[j] = pr[j] / s;
    __syncwarp();
    float vals[kMaxTopK];
    int idxs[kMaxTopK];
    unsigned taken[kMaxExperts / 32] = {0u, 0u, 0u, 0u};
    float vsum = 0.f;
    for (int c = 0; c < k; ++c) {
      float v = -INFINITY;
      int i = 0x7fffffff;
      for (int q = 0, j = lane; j < e; ++q, j += 32) {
        const float p = (taken[q] >> lane) & 1u ? -1.f : pr[j];
        argmax_merge(v, i, p, j);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, i, o);
        argmax_merge(v, i, ov, oi);
      }
      taken[i >> 5] |= 1u << (i & 31);  // the same on every lane
      vals[c] = v;
      idxs[c] = i;
      vsum += v;
    }
    const float denom = fmaxf(vsum, 1e-9f);
    if (lane == 0) {
      for (int c = 0; c < k; ++c) {
        const long long r = (long long)(t0 + t) * k + c;
        gv[r] = vals[c] / denom;
        gi[r] = idxs[c];
        sel[t * k + c] = idxs[c];
      }
    }
  }
  __syncthreads();

  // 3. thread j: positions of expert j's rows inside the block (token-major
  //    order), the block's count, probability sum and top-1 count for j
  if (tid < e) {
    const int j = tid;
    int cnt = 0, top1 = 0;
    float psum = 0.f;
    for (int r = 0; r < nt * k; ++r) {
      if (sel[r] == j) pos[(long long)t0 * k + r] = cnt++;
    }
    for (int t = 0; t < nt; ++t) {
      psum += probs[t * e + j];
      top1 += sel[t * k] == j;
    }
    blk_cnt[(long long)b * e + j] = cnt;
    blk_me[(long long)b * e + j] = psum;
    blk_ce[(long long)b * e + j] = top1;
  }
}

// One block: per expert, the exclusive scan of the block counts in block
// order (in place: blk_cnt becomes each block's base), the totals (cnt),
// and me / ce summed in block order; then pos[r] += base of r's block.
__global__ void __launch_bounds__(kScanThreads)
route_scan_kernel(int nb, int e, int k, long long rows,
                  int* __restrict__ blk_cnt, const float* __restrict__ blk_me,
                  const int* __restrict__ blk_ce, const int* __restrict__ gi,
                  int* __restrict__ pos, int* __restrict__ cnt,
                  float* __restrict__ me, float* __restrict__ ce) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < e; j += kScanThreads / 32) {
    int run = 0, top1 = 0;
    float psum = 0.f;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + lane;
      const int c = b < nb ? blk_cnt[(long long)b * e + j] : 0;
      int inc = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += v;
      }
      if (b < nb) blk_cnt[(long long)b * e + j] = run + inc - c;
      run += __shfl_sync(0xffffffffu, inc, 31);
      psum += pt::warp_sum(b < nb ? blk_me[(long long)b * e + j] : 0.f);
      int t1 = b < nb ? blk_ce[(long long)b * e + j] : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        t1 += __shfl_xor_sync(0xffffffffu, t1, o);
      top1 += t1;
    }
    if (lane == 0) {
      cnt[j] = run;
      me[j] = psum;
      ce[j] = (float)top1;
    }
  }
  __syncthreads();  // the bases are visible to the whole block
  const long long per_block = (long long)kTokens * k;
  for (long long r = threadIdx.x; r < rows; r += kScanThreads)
    pos[r] += blk_cnt[(r / per_block) * e + gi[r]];
}

// A 16-byte vector of the rows' type times an fp32 scale, rounded once to
// that type (KIND 1: fp32, 2: bf16); KIND 0 leaves it as it is.
template <int KIND>
__device__ __forceinline__ uint4 scaled(uint4 v, float s) {
  if constexpr (KIND == 1) {
    float* f = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] *= s;
  } else if constexpr (KIND == 2) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      h[i] = __floats2bfloat162_rn(f.x * s, f.y * s);
    }
  }
  return v;
}

// The indices (and scales) of rows [r0, r0 + R); -1 past the last row.
template <int KIND, int R>
__device__ __forceinline__ void fetch_rows(const int* __restrict__ idx,
                                           const float* __restrict__ scale,
                                           long long r0, int n_out,
                                           int (&nxt)[R], float (&nsc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = r0 + r < n_out;
    nxt[r] = in ? idx[r0 + r] : -1;
    nsc[r] = (KIND != 0 && in) ? scale[r0 + r] : 1.f;
  }
}

// Warp w takes rows [R * w, R * w + R), then the same R rows one grid
// further on; lane l moves vectors l + 32 c of each row, c < NV (in turns
// of 32 * NV vectors for wider rows).
template <int NV, int KIND>
__global__ void __launch_bounds__(kRowWarps * 32)
gather_rows_kernel(const uint4* __restrict__ src, const int* __restrict__ idx,
                   const float* __restrict__ scale, uint4* __restrict__ out,
                   int n_out, int n_src, int row_vecs) {
  constexpr int R = kGatherRows;
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kRowWarps * R;
  long long row0 = ((long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5)) * R;
  int nxt[R];
  float nsc[R];
  fetch_rows<KIND>(idx, scale, row0, n_out, nxt, nsc);
  for (; row0 < n_out; row0 += step) {
    int s[R];
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = nxt[r] >= 0 && nxt[r] < n_src ? nxt[r] : -1;
      sc[r] = nsc[r];
    }
    // the next rows' indices, read ahead of this turn's data
    fetch_rows<KIND>(idx, scale, row0 + step, n_out, nxt, nsc);
    for (int c0 = lane; c0 < row_vecs; c0 += 32 * NV) {
      uint4 v[R][NV];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const int at = c0 + 32 * c;
          v[r][c] = (s[r] >= 0 && at < row_vecs)
                        ? src[(long long)s[r] * row_vecs + at]
                        : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + r >= n_out) continue;
        uint4* o = out + (row0 + r) * row_vecs;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const int at = c0 + 32 * c;
          if (at < row_vecs) __stcs(o + at, scaled<KIND>(v[r][c], sc[r]));
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
combine_rows_kernel(const T* __restrict__ y, const float* __restrict__ gates,
                    const int* __restrict__ dest2, T* __restrict__ out, int n,
                    int k, int h, int n_y) {
  constexpr int V = pt::Vec16<T>::N;
  const int lane = threadIdx.x & 31;
  for (long long t = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
       t < n; t += (long long)gridDim.x * kRowWarps) {
    for (int d0 = lane * V; d0 < h; d0 += 32 * V) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      for (int c = 0; c < k; ++c) {
        const int d = dest2[t * k + c];
        if (d < 0 || d >= n_y) continue;
        const float g = gates[t * k + c];
        float f[V];
        pt::Vec16<T>::load(y + (long long)d * h + d0, f);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(g, f[i], acc[i]);
      }
      pt::Vec16<T>::store(out + t * h + d0, acc);
    }
  }
}

unsigned row_grid(long long rows) {
  const long long want = (rows + kRowWarps - 1) / kRowWarps;
  return (unsigned)(want < 132 * 16 ? want : 132 * 16);
}

template <typename T>
int launch_route(const void* x, const void* wg, int n, int h, int e, int k,
                 void* gv, void* gi, void* pos, void* cnt, void* me, void* ce,
                 void* blk_cnt, void* blk_me, void* blk_ce, cudaStream_t st) {
  const int nb = (n + kTokens - 1) / kTokens;
  const size_t smem = sizeof(float) * ((size_t)kTokens * e +
                                       (size_t)kChunk * e +
                                       (size_t)kTokens * (kChunk + 1)) +
                      sizeof(int) * (size_t)kTokens * k;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        route_local_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  route_local_kernel<T><<<nb, kThreads, smem, st>>>(
      (const T*)x, (const T*)wg, n, h, e, k, (float*)gv, (int*)gi, (int*)pos,
      (int*)blk_cnt, (float*)blk_me, (int*)blk_ce);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  route_scan_kernel<<<1, kScanThreads, 0, st>>>(
      nb, e, k, (long long)n * k, (int*)blk_cnt, (const float*)blk_me,
      (const int*)blk_ce, (const int*)gi, (int*)pos, (int*)cnt, (float*)me,
      (float*)ce);
  return (int)cudaGetLastError();
}

// Launch one gather instance on the blocks the card keeps resident.
template <int NV, int KIND>
int launch_gather(const uint4* src, const int* idx, const float* scale,
                  uint4* out, int n_out, int n_src, int row_vecs, int sms,
                  cudaStream_t st) {
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, gather_rows_kernel<NV, KIND>, kRowWarps * 32, 0);
    return b > 0 ? b : 1;
  }();
  const long long rows = (long long)kRowWarps * kGatherRows;
  const long long want = (n_out + rows - 1) / rows;
  const long long most = (long long)(sms > 0 ? sms : 1) * per_sm;
  gather_rows_kernel<NV, KIND><<<(unsigned)(want < most ? want : most),
                                 kRowWarps * 32, 0, st>>>(
      src, idx, scale, out, n_out, n_src, row_vecs);
  return (int)cudaGetLastError();
}

template <int KIND>
int gather_kind(int nv, const uint4* src, const int* idx, const float* scale,
                uint4* out, int n_out, int n_src, int row_vecs, int sms,
                cudaStream_t st) {
  switch (nv) {
    case 1: return launch_gather<1, KIND>(src, idx, scale, out, n_out, n_src,
                                          row_vecs, sms, st);
    case 2: return launch_gather<2, KIND>(src, idx, scale, out, n_out, n_src,
                                          row_vecs, sms, st);
    case 4: return launch_gather<4, KIND>(src, idx, scale, out, n_out, n_src,
                                          row_vecs, sms, st);
    case 6: return launch_gather<6, KIND>(src, idx, scale, out, n_out, n_src,
                                          row_vecs, sms, st);
    default: return launch_gather<8, KIND>(src, idx, scale, out, n_out,
                                           n_src, row_vecs, sms, st);
  }
}

int dispatch_gather(int nv, int kind, const uint4* src, const int* idx,
                    const float* scale, uint4* out, int n_out, int n_src,
                    int row_vecs, int sms, cudaStream_t st) {
  if (kind == 1)
    return gather_kind<1>(nv, src, idx, scale, out, n_out, n_src, row_vecs,
                          sms, st);
  if (kind == 2)
    return gather_kind<2>(nv, src, idx, scale, out, n_out, n_src, row_vecs,
                          sms, st);
  return gather_kind<0>(nv, src, idx, scale, out, n_out, n_src, row_vecs, sms,
                        st);
}

}  // namespace

// x [n, h], wg [h, e] (one dtype: 0 = float32, 1 = bfloat16) -> gv f32 [n, k],
// gi / pos i32 [n, k], cnt i32 [e], me / ce f32 [e]. Scratch: blk_cnt i32,
// blk_me f32, blk_ce i32, each [ceil(n / 32), e]. 1 <= e <= 128,
// 1 <= k <= min(e, 8), n >= 1. Returns the first CUDA error, or 0.
extern "C" int pt_moe_route(const void* x, const void* wg, int n, int h,
                            int e, int k, void* gv, void* gi, void* pos,
                            void* cnt, void* me, void* ce, void* blk_cnt,
                            void* blk_me, void* blk_ce, int dtype,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_route<float>(x, wg, n, h, e, k, gv, gi, pos, cnt, me, ce,
                               blk_cnt, blk_me, blk_ce, st);
  return launch_route<__nv_bfloat16>(x, wg, n, h, e, k, gv, gi, pos, cnt, me,
                                     ce, blk_cnt, blk_me, blk_ce, st);
}

// out [n_out, row] = src[idx] by rows of row_bytes (a multiple of 16, every
// row 16-byte aligned); an index outside [0, n_src) gives a zero row. With
// `scale` (fp32 [n_out], may be null) each row is multiplied by its scale in
// fp32 and rounded once to `dtype` (0 = float32, 1 = bfloat16; read only
// with a scale). `sms`: the card's SM count. Returns the first CUDA error.
extern "C" int pt_moe_gather_rows(const void* src, const void* idx,
                                  const void* scale, void* out, int n_out,
                                  int n_src, int row_bytes, int dtype, int sms,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_out <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  const int kind = scale == nullptr ? 0 : dtype == 0 ? 1 : 2;
  const int per_lane = (row_bytes / 16 + 31) / 32;
  const int nv = per_lane <= 1 ? 1 : per_lane <= 2 ? 2 : per_lane <= 4 ? 4
               : per_lane <= 6 ? 6 : 8;
  return dispatch_gather(nv, kind, (const uint4*)src, (const int*)idx,
                         (const float*)scale, (uint4*)out, n_out, n_src,
                         row_bytes / 16, sms, st);
}

// The unscaled gather, on the current device's SM count.
extern "C" int pt_moe_gather(const void* src, const void* idx, void* out,
                             int n_out, int n_src, int row_bytes,
                             void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  return pt_moe_gather_rows(src, idx, nullptr, out, n_out, n_src, row_bytes,
                            0, sms, stream);
}

// out [n, h] = sum_c gates[t, c] * y[dest2[t, c]] in fp32; y and out of one
// dtype, h a multiple of 8; a destination outside [0, n_y) adds nothing.
// Returns cudaGetLastError().
extern "C" int pt_moe_combine(const void* y, const void* gates,
                              const void* dest2, void* out, int n, int k,
                              int h, int n_y, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0 && h > 0) {
    if (dtype == 0)
      combine_rows_kernel<float><<<row_grid(n), kRowWarps * 32, 0, st>>>(
          (const float*)y, (const float*)gates, (const int*)dest2,
          (float*)out, n, k, h, n_y);
    else
      combine_rows_kernel<__nv_bfloat16>
          <<<row_grid(n), kRowWarps * 32, 0, st>>>(
              (const __nv_bfloat16*)y, (const float*)gates,
              (const int*)dest2, (__nv_bfloat16*)out, n, k, h, n_y);
  }
  return (int)cudaGetLastError();
}

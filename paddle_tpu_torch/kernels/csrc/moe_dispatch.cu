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
// two launches, both deterministic (no atomics: under activation recompute
// the second forward must route every token exactly as the first):
//   1. The tokens kernel. The grid is the blocks the card keeps resident
//      (the caller's plan: its SM count times 2), and block b routes the
//      contiguous tokens [b * tokens, (b + 1) * tokens), so its rows stay
//      token-major. The block stages wg in shared memory once, transposed
//      to [expert][h] in wg's own type (24 KB at e 8, h 1536 in bf16),
//      while its warps' first x loads are in flight. Two instances:
//      - moe_route_mma_kernel (bf16, e <= 32, wg whole in 80 KB; the MoE
//        step): the logits on the tensor cores, mma.sync m16n8k16 with 16
//        tokens a warp (its note below). Reading wg for 16 tokens at once
//        is what removes the limit of the CUDA-core instance.
//      - moe_route_tokens_kernel (fp32, more experts, wider wg): a warp
//        routes two tokens at once; each lane loads 16-byte vectors of both
//        rows (4 a lane and row per turn) and for each reads one 16-byte
//        vector of each expert's wg columns, which serves both tokens,
//        forming 8 experts' partial dots in fp32 registers; a fixed
//        transpose-reduce of 9 shuffles (not 8 x 5) leaves expert (lane
//        >> 2) & 7's sum on lane; more experts go 8 at a time, and wg in h
//        tiles when e * h passes the budget (128 experts). It is bound by
//        the wg reads from shared memory and each block's chain of
//        dependent phases (a sweep of variants on the H100: 0.028 ms at
//        the MoE shape against 0.0148 for the tensor-core instance).
//      The sum orders are fixed, so a recompute routes every token as the
//      first forward did. Softmax and top-k follow, then the ranks of a
//      pass of tokens (pass_ranks): __match_any_sync over each 32-row
//      slice gives a row's rank among the slice's rows of its expert (a
//      lanes-below mask), the slice leaders write the slice counts to
//      shared memory, and a row's position is the block's running count of
//      its expert, plus the counts of the slices before its own, plus its
//      rank. The block writes its counts, probability sums (token order)
//      and top-1 counts.
//   2. moe_route_fix_kernel, launched as a programmatic dependent (it sets
//      up while the first grid finishes) on the same grid: block b sums the
//      counts of the blocks before it per expert (a warp per expert; int
//      sums are exact in any order) and adds that base to its own rows'
//      positions; the last block also writes the counts and me / ce,
//      summed over the blocks in a fixed order (lane q takes blocks q, q +
//      32, ..., then a fixed shuffle tree).
// The earlier design (32 tokens a block, the logits as a tiled product
// over h with scalar loads, one thread counting each expert's rows, and a
// one-block scan that fixed all positions) stays as route_local_kernel /
// route_scan_kernel behind pt_moe_route_earlier, for timing beside the new
// one; no path of the package calls it.
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

constexpr int kMaxExperts = 128;
constexpr int kMaxTopK = 8;
constexpr int kRouteWarps = 8;   // warps per routing block
constexpr int kRouteTpw = 2;     // tokens a routing warp takes at once
constexpr int kRoutePass = kRouteWarps * kRouteTpw;  // tokens per pass
constexpr int kRouteNV = 4;      // 16-byte vectors of a row a lane loads
constexpr int kRouteSlices = kRoutePass * kMaxTopK / 32;  // 32-row slices
constexpr int kRouteWgBytes = 80 * 1024;  // wg staged in shared memory
constexpr int kRouteSmemMost =   // wg, probabilities, choices, slice counts
    kRouteWgBytes + 4 * (kRoutePass * kMaxExperts + kRoutePass * kMaxTopK +
                         (kRouteSlices + 1) * kMaxExperts);
constexpr int kMmaWarps = 8;       // the tensor-core routing kernel's warps:
constexpr int kMmaPass = 32;       // 2 groups of 16 tokens x 4 column quarters
constexpr int kMmaAhead = 4;       // 32-column steps of x a warp has in flight
constexpr int kMmaMostExperts = 32;
constexpr int kMmaSlices = kMmaPass * kMaxTopK / 32;
constexpr int kMmaSmemMost =
    kRouteWgBytes + 4 * (5 * kMmaPass * kMmaMostExperts +
                         kMmaPass * kMaxTopK +
                         (kMmaSlices + 1) * kMmaMostExperts);
// the earlier routing kernels (pt_moe_route_earlier)
constexpr int kTokens = 32;   // tokens per routing block
constexpr int kThreads = 256;
constexpr int kChunk = 64;    // h per step of the logits product
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

// The earlier routing design (pt_moe_route_earlier), kept for timing.
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

// -- routing ------------------------------------------------------------------

// ws [e8][tile] (wg's own type) = wg[c0 + col][j]: the tile's columns of
// every expert, zero for experts e..e8-1 and columns past h. One 16-byte
// vector of wg is VEC consecutive (column, expert) pairs; a thread takes
// whole vectors, with one division each.
template <typename T>
__device__ void stage_wg(const T* __restrict__ wg, T* __restrict__ ws,
                         int h, int e, int e8, int c0, int tile) {
  constexpr int VEC = pt::Vec16<T>::N;
  constexpr int kAhead = 4;  // vectors a thread loads before it stores
  const T zero = pt::from_f<T>(0.f);
  const int cols = min(tile, h - c0), pad = tile - cols;
  for (int i = threadIdx.x; i < (e8 - e) * tile; i += blockDim.x)
    ws[e * tile + i] = zero;
  for (int i = threadIdx.x; i < e * pad; i += blockDim.x)
    ws[(i / pad) * tile + cols + i % pad] = zero;
  const uint4* src = reinterpret_cast<const uint4*>(wg + (size_t)c0 * e);
  const int nvec = cols * e / VEC;  // the tile's cols * e values
  for (int i0 = threadIdx.x; i0 < nvec; i0 += kAhead * blockDim.x) {
    uint4 raw[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int i = i0 + a * blockDim.x;
      if (i < nvec) raw[a] = src[i];
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int i = i0 + a * blockDim.x;
      if (i >= nvec) continue;
      const T* v = reinterpret_cast<const T*>(&raw[a]);
      int col = i * VEC / e, j = i * VEC - col * e;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        ws[j * tile + col] = v[q];
        if (++j == e) {
          j = 0;
          ++col;
        }
      }
    }
  }
}

// The warp's sum of v[(lane >> 2) & 7] on every lane: a transpose-reduce
// in a fixed order (each of the first three steps keeps half the values
// and adds the partner's other half; the last two add across lanes 2 and
// 1 apart), 9 shuffles where 8 butterflies take 40.
__device__ __forceinline__ float reduce8(const float (&v)[8], int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (b4 ? v[i + 4] : v[i]) +
           __shfl_xor_sync(kAll, b4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (b3 ? a[i + 2] : a[i]) +
           __shfl_xor_sync(kAll, b3 ? a[i] : a[i + 2], 8);
  float c = (b2 ? b[1] : b[0]) + __shfl_xor_sync(kAll, b2 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(kAll, c, 2);
  c += __shfl_xor_sync(kAll, c, 1);
  return c;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Softmax of the logits pr[0..e) in place, then the iterative top-k (ties
// to the lowest expert) renormalised by max(sum, 1e-9): gv / gi of row
// `row0` on, and the choices in sel[0..k). One warp; lane l owns experts
// l + 32 q.
__device__ __forceinline__ void softmax_topk(float* __restrict__ pr, int e,
                                             int k, int lane,
                                             float* __restrict__ gv,
                                             int* __restrict__ gi,
                                             long long row0,
                                             int* __restrict__ sel) {
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
      gv[row0 + c] = vals[c] / denom;
      gi[row0 + c] = idxs[c];
      sel[c] = idxs[c];
    }
  }
}

// The ranks of one pass of np tokens, for the whole block: rows r = slot *
// k + c (token-major, choices in sel) of the pass lie in 32-row slices,
// warp s taking slice s; __match_any_sync gives a row's rank among its
// slice's rows of its expert, the slice leaders write the slice counts to
// sc (zeroed before the call), and a row's block-local position (written
// from pos[row0]) is run[expert] plus the counts of the slices before its
// own plus its rank. Thread j < e then adds the slice counts to run[j] and
// the pass's probabilities (lg [slot][e]) and top-1 counts to its psum /
// top1. Ends on a barrier.
template <int SLICES>
__device__ __forceinline__ void pass_ranks(const int* __restrict__ sel,
                                           int* __restrict__ sc,
                                           int* __restrict__ run,
                                           const float* __restrict__ lg,
                                           int np, int e, int k,
                                           long long row0,
                                           int* __restrict__ pos,
                                           float& psum, int& top1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp * 32 + lane;
  int ex = -1, below = 0;
  if (warp < SLICES) {
    ex = r < np * k ? sel[r] : -1;
    const unsigned same = __match_any_sync(0xffffffffu, ex);
    below = __popc(same & ((1u << lane) - 1u));
    if (ex >= 0 && below == 0) sc[warp * e + ex] = __popc(same);
  }
  __syncthreads();
  if (ex >= 0) {
    int p = run[ex] + below;
    for (int s = 0; s < warp; ++s) p += sc[s * e + ex];
    pos[row0 + r] = p;
  }
  __syncthreads();
  if (threadIdx.x < e) {
    const int j = threadIdx.x;
    int c = 0;
#pragma unroll
    for (int s = 0; s < SLICES; ++s) c += sc[s * e + j];
    run[j] += c;
    for (int slot = 0; slot < np; ++slot) {
      psum += lg[slot * e + j];
      top1 += sel[slot * k] == j;
    }
  }
  __syncthreads();  // lg, sel and sc are rewritten by the next pass
}

// Softmax of one token's logits pr[0..e) in place and its iterative top-k
// (ties to the lowest expert), renormalised by max(sum, 1e-9), in one
// thread: gv / gi of row `row0` on, the choices in sel[0..k).
__device__ __forceinline__ void softmax_topk_thread(float* __restrict__ pr,
                                                    int e, int k,
                                                    float* __restrict__ gv,
                                                    int* __restrict__ gi,
                                                    long long row0,
                                                    int* __restrict__ sel) {
  float mx = -INFINITY;
  for (int j = 0; j < e; ++j) mx = fmaxf(mx, pr[j]);
  float s = 0.f;
  for (int j = 0; j < e; ++j) {
    const float p = expf(pr[j] - mx);
    pr[j] = p;
    s += p;
  }
  for (int j = 0; j < e; ++j) pr[j] = pr[j] / s;
  unsigned taken[kMaxExperts / 32] = {0u, 0u, 0u, 0u};
  float vals[kMaxTopK];
  int idxs[kMaxTopK];
  float vsum = 0.f;
  for (int c = 0; c < k; ++c) {
    float v = -INFINITY;
    int i = 0;
    for (int j = 0; j < e; ++j) {
      const float p = (taken[j >> 5] >> (j & 31)) & 1u ? -1.f : pr[j];
      if (p > v) {
        v = p;
        i = j;
      }
    }
    taken[i >> 5] |= 1u << (i & 31);
    vals[c] = v;
    idxs[c] = i;
    vsum += v;
  }
  const float denom = fmaxf(vsum, 1e-9f);
  for (int c = 0; c < k; ++c) {
    gv[row0 + c] = vals[c] / denom;
    gi[row0 + c] = idxs[c];
    sel[c] = idxs[c];
  }
}

// D += A (16 x 16 bf16, row) B (16 x 8 bf16, col), fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tensor-core routing kernel (bf16, e <= kMmaMostExperts, wg whole in
// shared memory): the logits as mma.sync m16n8k16 products. Block b routes
// tokens [b * tokens, ...) in passes of kMmaPass = 32; warp w takes token
// group w / 4 (16 tokens: the mma's rows) and the 32-column steps s of h
// with s % 4 == w % 4. A step's x is one 16-byte load per lane and row
// (lane 4g + t: rows g and g + 8, columns 8t..8t+7 of the step), taken as
// the A fragments of two mmas under one permutation of k (the first gets
// columns 8t..8t+3, the second 8t+4..8t+7), and one 16-byte read of the
// staged wg (expert 8 * group + g, the same columns) is the matching pair
// of B fragments, so no data is shuffled. kMmaAhead steps of x are in
// flight per warp. Each step's two mmas start from zero and their sum is
// added to the fp32 logits with one rounding (the tensor core's internal
// sums are not IEEE, so they never carry across steps). The warps' four
// column quarters are then added in a fixed order, one thread per token
// takes softmax and top-k, and pass_ranks the positions. Shared memory
// (dynamic): ws bf16 [e8][hp], part fp32 [4][kMmaPass][e8], lg [kMmaPass]
// [e], sel [kMmaPass * k], sc [kMmaSlices][e], run [e].
__global__ void __launch_bounds__(kMmaWarps * 32, 2)
moe_route_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wg, int n, int h,
                     int e, int k, int tokens, float* __restrict__ gv,
                     int* __restrict__ gi, int* __restrict__ pos,
                     int* __restrict__ blk) {
  constexpr int kGroups = kMmaMostExperts / 8;
  extern __shared__ __align__(16) unsigned char route_mma_smem[];
  const int e8 = (e + 7) & ~7, hp = (h + 31) & ~31, steps = hp / 32;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(route_mma_smem);
  float* part = reinterpret_cast<float*>(ws + (size_t)e8 * hp);
  float* lg = part + 4 * kMmaPass * e8;
  int* sel = reinterpret_cast<int*>(lg + kMmaPass * e);
  int* sc = sel + kMmaPass * k;
  int* run = sc + kMmaSlices * e;
  // the fix-up grid may start launching now; it waits for this one
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;   // the mma's row group and pair
  const int tg = warp >> 2, q = warp & 3;  // token group, column quarter
  const int t_begin = blockIdx.x * tokens, t_end = min(n, t_begin + tokens);
  for (int j = threadIdx.x; j < e; j += blockDim.x) run[j] = 0;
  float psum = 0.f;
  int top1 = 0;
  for (int p0 = t_begin; p0 < t_end; p0 += kMmaPass) {
    const int np = min(kMmaPass, t_end - p0);
    const int sa = 16 * tg + g, sb = sa + 8;  // this lane's two slots
    const __nv_bfloat16* xa = x + (size_t)(p0 + (sa < np ? sa : 0)) * h;
    const __nv_bfloat16* xb = x + (size_t)(p0 + (sb < np ? sb : 0)) * h;
    auto load = [&](int st, uint4& ra, uint4& rb) {
      const int col = st * 32 + 8 * t;  // h is whole vectors: all or none
      const bool in = st < steps && col < h;
      ra = in && sa < np ? __ldcs(reinterpret_cast<const uint4*>(xa + col))
                         : make_uint4(0u, 0u, 0u, 0u);
      rb = in && sb < np ? __ldcs(reinterpret_cast<const uint4*>(xb + col))
                         : make_uint4(0u, 0u, 0u, 0u);
    };
    uint4 ra[kMmaAhead], rb[kMmaAhead];
#pragma unroll
    for (int i = 0; i < kMmaAhead; ++i) load(q + 4 * i, ra[i], rb[i]);
    if (p0 == t_begin) {  // wg once per block, while the x loads fly
      stage_wg<__nv_bfloat16>(wg, ws, h, e, e8, 0, hp);
      __syncthreads();
    }
    float acc[kGroups][4];
#pragma unroll
    for (int gr = 0; gr < kGroups; ++gr)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[gr][i] = 0.f;
    for (int base = q; base < steps; base += 4 * kMmaAhead) {
#pragma unroll
      for (int i = 0; i < kMmaAhead; ++i) {
        const int st = base + 4 * i;
        if (st >= steps) break;
        const uint32_t a1[4] = {ra[i].x, rb[i].x, ra[i].y, rb[i].y};
        const uint32_t a2[4] = {ra[i].z, rb[i].z, ra[i].w, rb[i].w};
        const __nv_bfloat16* wr = ws + (size_t)g * hp + st * 32 + 8 * t;
#pragma unroll
        for (int gr = 0; gr < kGroups; ++gr) {
          if (8 * gr >= e8) break;
          const uint4 w =
              *reinterpret_cast<const uint4*>(wr + (size_t)8 * gr * hp);
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16_16816(c, a1, w.x, w.y);
          mma_bf16_16816(c, a2, w.z, w.w);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[gr][v] += c[v];
        }
        load(st + 4 * kMmaAhead, ra[i], rb[i]);  // this slot's next step
      }
    }
    // lane 4g + t holds slots sa / sb, experts 8 * gr + 2t and + 1
#pragma unroll
    for (int gr = 0; gr < kGroups; ++gr) {
      if (8 * gr >= e8) break;
      float* pa = part + ((size_t)q * kMmaPass + sa) * e8 + 8 * gr + 2 * t;
      pa[0] = acc[gr][0];
      pa[1] = acc[gr][1];
      pa[8 * e8] = acc[gr][2];
      pa[8 * e8 + 1] = acc[gr][3];
    }
    for (int i = threadIdx.x; i < kMmaSlices * e; i += blockDim.x) sc[i] = 0;
    __syncthreads();
    const size_t quarter = (size_t)kMmaPass * e8;
    for (int i = threadIdx.x; i < np * e; i += blockDim.x) {
      const int slot = i / e, j = i - slot * e;
      const float* pp = part + (size_t)slot * e8 + j;
      lg[i] = ((pp[0] + pp[quarter]) + pp[2 * quarter]) + pp[3 * quarter];
    }
    __syncthreads();
    if (warp == 0 && lane < np)
      softmax_topk_thread(lg + lane * e, e, k, gv, gi,
                          (long long)(p0 + lane) * k, sel + lane * k);
    __syncthreads();
    pass_ranks<kMmaSlices>(sel, sc, run, lg, np, e, k, (long long)p0 * k,
                           pos, psum, top1);
  }
  if (threadIdx.x < e) {
    const size_t at = (size_t)blockIdx.x * e + threadIdx.x;
    const size_t plane = (size_t)gridDim.x * e;
    blk[at] = run[threadIdx.x];
    reinterpret_cast<float*>(blk)[plane + at] = psum;
    blk[2 * plane + at] = top1;
  }
}

// Block b routes tokens [b * tokens, min(n, (b + 1) * tokens)) in passes of
// kRoutePass, warp w taking the pass's tokens 2w and 2w + 1. h is a
// multiple of VEC (the wrapper pads) and x, wg are 16-byte aligned; `tile`
// columns of wg fit the shared budget (all of h but for many experts).
// Writes gv, gi, the block-local positions, and blk [3][grid][e] (counts,
// probability sums as fp32 bits, top-1 counts). Shared memory (dynamic):
// ws [e8][tile], lg [kRoutePass][e] (logits, then probabilities), sel
// [kRoutePass * k], sc [kRouteSlices][e] (slice counts), run [e]; ws
// holds wg in its own type, so a 16-byte read is one vector's columns of
// one expert.
template <typename T>
__global__ void __launch_bounds__(kRouteWarps * 32, 2)
moe_route_tokens_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                        int n, int h, int e, int k, int tokens, int tile,
                        float* __restrict__ gv, int* __restrict__ gi,
                        int* __restrict__ pos, int* __restrict__ blk) {
  using V = pt::Vec16<T>;
  constexpr int VEC = V::N;
  constexpr int kChunkCols = 32 * kRouteNV * VEC;
  extern __shared__ __align__(16) unsigned char route_smem[];
  const int e8 = (e + 7) & ~7;
  T* ws = reinterpret_cast<T*>(route_smem);
  float* lg = reinterpret_cast<float*>(ws + (size_t)e8 * tile);
  int* sel = reinterpret_cast<int*>(lg + kRoutePass * e);
  int* sc = sel + kRoutePass * k;
  int* run = sc + kRouteSlices * e;
  // the fix-up grid may start launching now; it waits for this one
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t_begin = blockIdx.x * tokens, t_end = min(n, t_begin + tokens);
  const int ntile = (h + tile - 1) / tile;
  for (int j = threadIdx.x; j < e; j += blockDim.x) run[j] = 0;
  float psum = 0.f;  // thread j < e: expert j's probability sum and
  int top1 = 0;      // top-1 count over the block's tokens, in order
  for (int p0 = t_begin; p0 < t_end; p0 += kRoutePass) {
    const int np = min(kRoutePass, t_end - p0);
    int tok[kRouteTpw];
#pragma unroll
    for (int u = 0; u < kRouteTpw; ++u) {
      const int slot = warp * kRouteTpw + u;
      tok[u] = slot < np ? p0 + slot : -1;
      for (int j = lane; j < e; j += 32) lg[slot * e + j] = 0.f;
    }
    for (int i = threadIdx.x; i < kRouteSlices * e; i += blockDim.x)
      sc[i] = 0;
    __syncwarp();
    // 1. logits: lg[slot][j] = x[tok] . wg[:, j] in fp32, a fixed order.
    //    The block's first x loads are issued before wg is staged, so that
    //    their latency overlaps the staging.
    uint4 xr[kRouteTpw][kRouteNV];
    auto load_x = [&](int cc, int c1) {
#pragma unroll
      for (int u = 0; u < kRouteTpw; ++u)
#pragma unroll
        for (int c = 0; c < kRouteNV; ++c) {
          const int col = cc + (lane + 32 * c) * VEC;
          xr[u][c] = tok[u] >= 0 && col < c1
              ? __ldcs(reinterpret_cast<const uint4*>(
                    x + (size_t)tok[u] * h + col))
              : make_uint4(0u, 0u, 0u, 0u);
        }
    };
    bool loaded = p0 == t_begin;
    if (loaded) load_x(0, min(h, tile));
    for (int ti = 0; ti < ntile; ++ti) {
      const int c0 = ti * tile, c1 = min(h, c0 + tile);
      if (ntile > 1 || p0 == t_begin) {
        __syncthreads();
        stage_wg<T>(wg, ws, h, e, e8, c0, tile);
        __syncthreads();
      }
      for (int cc = c0; cc < c1; cc += kChunkCols) {
        if (!loaded) load_x(cc, c1);
        loaded = false;
        for (int g = 0; g < e8; g += 8) {
          float acc[kRouteTpw][8];
#pragma unroll
          for (int u = 0; u < kRouteTpw; ++u)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) acc[u][jj] = 0.f;
#pragma unroll
          for (int c = 0; c < kRouteNV; ++c) {
            const int col = cc + (lane + 32 * c) * VEC;
            if (col >= c1) continue;
            float xf[kRouteTpw][VEC];
#pragma unroll
            for (int u = 0; u < kRouteTpw; ++u) V::unpack(xr[u][c], xf[u]);
            const T* wr = ws + (size_t)g * tile + (col - c0);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              float wv[VEC];
              V::unpack(*reinterpret_cast<const uint4*>(wr + jj * tile), wv);
#pragma unroll
              for (int u = 0; u < kRouteTpw; ++u)
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                  acc[u][jj] = fmaf(xf[u][i], wv[i], acc[u][jj]);
            }
          }
#pragma unroll
          for (int u = 0; u < kRouteTpw; ++u) {
            const float s = reduce8(acc[u], lane);
            const int j = g + ((lane >> 2) & 7);
            if ((lane & 3) == 0 && j < e && tok[u] >= 0)
              lg[(warp * kRouteTpw + u) * e + j] += s;
          }
        }
      }
    }
    __syncwarp();
    // 2. softmax and top-k of the warp's tokens
#pragma unroll
    for (int u = 0; u < kRouteTpw; ++u) {
      if (tok[u] < 0) continue;
      const int slot = warp * kRouteTpw + u;
      softmax_topk(lg + slot * e, e, k, lane, gv, gi, (long long)tok[u] * k,
                   sel + slot * k);
    }
    __syncthreads();
    // 3. ranks, counts and sums of the pass
    pass_ranks<kRouteSlices>(sel, sc, run, lg, np, e, k, (long long)p0 * k,
                             pos, psum, top1);
  }
  if (threadIdx.x < e) {
    const size_t at = (size_t)blockIdx.x * e + threadIdx.x;
    const size_t plane = (size_t)gridDim.x * e;
    blk[at] = run[threadIdx.x];
    reinterpret_cast<float*>(blk)[plane + at] = psum;
    blk[2 * plane + at] = top1;
  }
}

// Launched as a programmatic dependent of the tokens kernel, on its grid:
// block b adds to its rows' positions the counts of the blocks before it
// (per expert); the last block also writes cnt, me and ce.
__global__ void __launch_bounds__(kRouteWarps * 32)
moe_route_fix_kernel(const int* __restrict__ blk, int n, int e, int k,
                     int tokens, const int* __restrict__ gi,
                     int* __restrict__ pos, int* __restrict__ cnt,
                     float* __restrict__ me, float* __restrict__ ce) {
  __shared__ int base[kMaxExperts];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, nb = gridDim.x;
  const float* bme = reinterpret_cast<const float*>(blk) + (size_t)nb * e;
  const int* btop = blk + 2 * (size_t)nb * e;
  for (int j = warp; j < e; j += kRouteWarps) {
    int s = 0;
#pragma unroll 4
    for (int q = lane; q < b; q += 32) s += blk[(size_t)q * e + j];
    s = warp_sum_int(s);
    if (lane == 0) base[j] = s;
    if (b == nb - 1) {  // the totals: blocks q = lane, lane + 32, ... in order
      float m = 0.f;
      int t1 = 0;
#pragma unroll 4
      for (int q = lane; q < nb; q += 32) {
        m += bme[(size_t)q * e + j];
        t1 += btop[(size_t)q * e + j];
      }
      m = pt::warp_sum(m);
      t1 = warp_sum_int(t1);
      if (lane == 0) {
        cnt[j] = s + blk[(size_t)b * e + j];
        me[j] = m;
        ce[j] = (float)t1;
      }
    }
  }
  __syncthreads();
  const long long r0 = (long long)b * tokens * k;
  const long long r1 = (long long)min(n, (b + 1) * tokens) * k;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x)
    pos[r] += base[gi[r]];
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

// The tokens kernel a call takes: the tensor-core one for bf16 with at most
// kMmaMostExperts experts whose wg fits shared memory whole, the CUDA-core
// one otherwise (fp32, more experts, wider wg).
template <typename T>
cudaError_t route_tokens(const T* x, const T* wg, int n, int h, int e, int k,
                         int tokens, unsigned grid, float* gv, int* gi,
                         int* pos, int* blk, cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int e8 = (e + 7) & ~7;
  if constexpr (sizeof(T) == 2) {
    const int hp = (h + 31) & ~31;
    if (e <= kMmaMostExperts && (size_t)e8 * hp * 2 <= kRouteWgBytes) {
      static const cudaError_t opt = cudaFuncSetAttribute(
          moe_route_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMmaSmemMost);
      if (opt != cudaSuccess) return opt;
      const size_t smem = 2 * (size_t)e8 * hp +
                          sizeof(float) * (4 * kMmaPass * e8 + kMmaPass * e) +
                          sizeof(int) * ((size_t)kMmaPass * k +
                                         (size_t)(kMmaSlices + 1) * e);
      moe_route_mma_kernel<<<grid, kMmaWarps * 32, smem, st>>>(
          x, wg, n, h, e, k, tokens, gv, gi, pos, blk);
      return cudaGetLastError();
    }
  }
  static const cudaError_t opt = cudaFuncSetAttribute(
      moe_route_tokens_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRouteSmemMost);
  if (opt != cudaSuccess) return opt;
  int tile = kRouteWgBytes / ((int)sizeof(T) * e8) / VEC * VEC;  // fits
  if (tile > h) tile = h;
  const size_t smem = sizeof(T) * (size_t)e8 * tile +
                      sizeof(float) * kRoutePass * e +
                      sizeof(int) * ((size_t)kRoutePass * k +
                                     (size_t)(kRouteSlices + 1) * e);
  moe_route_tokens_kernel<T><<<grid, kRouteWarps * 32, smem, st>>>(
      x, wg, n, h, e, k, tokens, tile, gv, gi, pos, blk);
  return cudaGetLastError();
}

template <typename T>
int launch_route(const void* x, const void* wg, int n, int h, int e, int k,
                 int tokens, void* gv, void* gi, void* pos, void* cnt,
                 void* me, void* ce, void* blk, cudaStream_t st) {
  const unsigned grid = (unsigned)((n + tokens - 1) / tokens);
  const cudaError_t err = route_tokens<T>(
      (const T*)x, (const T*)wg, n, h, e, k, tokens, grid, (float*)gv,
      (int*)gi, (int*)pos, (int*)blk, st);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kRouteWarps * 32);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, moe_route_fix_kernel,
                                 (const int*)blk, n, e, k, tokens,
                                 (const int*)gi, (int*)pos, (int*)cnt,
                                 (float*)me, (float*)ce);
}

template <typename T>
int launch_route_earlier(const void* x, const void* wg, int n, int h, int e,
                         int k, void* gv, void* gi, void* pos, void* cnt,
                         void* me, void* ce, void* blk_cnt, void* blk_me,
                         void* blk_ce, cudaStream_t st) {
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

// x [n, h], wg [h, e] (one dtype: 0 = float32, 1 = bfloat16; h a whole
// number of 16-byte vectors, both 16-byte aligned) -> gv f32 [n, k], gi /
// pos i32 [n, k], cnt i32 [e], me / ce f32 [e], every entry written.
// `tokens`: tokens per block (the caller's plan; the grid is ceil(n /
// tokens)); scratch blk i32 [3, grid, e]. 1 <= e <= 128, 1 <= k <= min(e,
// 8), n >= 1. Returns the first CUDA error, or 0.
extern "C" int pt_moe_route(const void* x, const void* wg, int n, int h,
                            int e, int k, int tokens, void* gv, void* gi,
                            void* pos, void* cnt, void* me, void* ce,
                            void* blk, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_route<float>(x, wg, n, h, e, k, tokens, gv, gi, pos, cnt,
                               me, ce, blk, st);
  return launch_route<__nv_bfloat16>(x, wg, n, h, e, k, tokens, gv, gi, pos,
                                     cnt, me, ce, blk, st);
}

// The earlier routing kernels, same outputs (any h; scratch blk_cnt i32,
// blk_me f32, blk_ce i32, each [ceil(n / 32), e]), for timing beside the
// new ones.
extern "C" int pt_moe_route_earlier(const void* x, const void* wg, int n,
                                    int h, int e, int k, void* gv, void* gi,
                                    void* pos, void* cnt, void* me, void* ce,
                                    void* blk_cnt, void* blk_me,
                                    void* blk_ce, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_route_earlier<float>(x, wg, n, h, e, k, gv, gi, pos, cnt,
                                       me, ce, blk_cnt, blk_me, blk_ce, st);
  return launch_route_earlier<__nv_bfloat16>(x, wg, n, h, e, k, gv, gi, pos,
                                             cnt, me, ce, blk_cnt, blk_me,
                                             blk_ce, st);
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

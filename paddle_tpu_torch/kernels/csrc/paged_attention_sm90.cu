// Paged attention over a window of queries (prefill, W > 1) on Hopper's
// tensor cores (sm_90a): bf16, head dim 64 or 128, page length 8-64.
//
// Replaces the TPU kernel `_paged_kernel` (paddle_tpu/kernels/pallas/
// paged_attention.py:46, launched by `_paged_pallas` at :91) for the
// windows it takes. Same function: q [S,W,nh,hd] attends to arenas
// [P,PL,kvh,hd] through the page table tables [S,B]; key j is visible to
// (s, w) iff j <= pos[s, w]; GQA when kvh < nh; a row that sees no key
// gives 0. P is rounded to bf16 before P.V, as the TPU kernel rounds
// `p.astype(v.dtype)` (:77); the row sum l adds the fp32 p.
//
// What bounds it on the H100: operations. A 512-token window reuses each
// K/V byte for 512 query rows (~250 FLOPs per byte at hd 128), near the
// ~295 FLOPs per byte where bf16 tensor cores become the limit, so the
// products belong on the tensor cores and each page should be read by as
// few blocks as possible.
//
// What the design does about it: the shape of flash_fwd_sm90.cu with the
// key tiles gathered through the page table.
//  - One block of two warpgroups per (slot, query head, tile of 128 window
//    rows); each warpgroup owns 64 rows. Q comes in once by TMA through a
//    4-D map over q [S, W, nh, hd] (box {64, 1, 64, 1}: 64 rows of one head,
//    one 64-column half), so rows past W read zeros; the map takes q's
//    strides, so the serving step's q, a view into its fused QKV
//    projection, is read where it lies.
//  - A key tile is 64 keys = 64 / PL pages. Each page is one TMA box
//    {64, 1, PL} of a map over the arena seen as [P * PL, kvh, hd], at row
//    tables[s, p] * PL; the block reads its page ids from `tables` once,
//    into shared memory. Box p of a tile lands at byte p * PL * 128 of the
//    tile's 64-column half, a multiple of 1024 because PL >= 8. The 128-byte
//    swizzle is a function of the shared address bits (chunk bits 4-6 XOR
//    row bits 7-9), so boxes that start on 1024-byte boundaries and stack
//    whole 128-byte rows give the same swizzled image as one 64-row box:
//    sm90_common.cuh's layout contract holds for the stacked tile.
//  - The tiles go through the 2-stage mbarrier ring of the flash forward
//    ("full" when the bytes landed, "empty" when all 256 threads are done).
//    Per tile: S = Q.K^T as wgmma m64n64k16 (both operands K-major); the
//    online softmax on the accumulator fragment in log2 units; O += P.V as
//    wgmma with P the bf16 register A operand and V read MN-major.
//  - Masking reads pos per row and assumes no order among the rows: the
//    block stops after the tile holding its largest pos (or the table's
//    last key), a warpgroup skips tiles past its own largest pos, and only
//    a tile that crosses its smallest pos or the table's end is masked.
//    Pages past the table load the scratch page and are masked.
// Thread 0 issues the TMA loads between its own tiles (no producer warp).

#include <limits.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 128;  // window rows per block (two warpgroups of 64)
constexpr int kKeys = 64;   // keys per K / V tile
constexpr int kThreads = 256;

template <int D>
struct PagedLayout {
  static constexpr int kHalves = D / 64;
  static constexpr uint32_t kHalfQ = kRows * 128;   // bytes of one Q half
  static constexpr uint32_t kHalfKV = kKeys * 128;  // bytes of one K/V half
  static constexpr uint32_t kTileKV = kHalves * kHalfKV;
  static constexpr uint32_t kQ = kHalves * kHalfQ;
  static constexpr uint32_t kBars = kQ + 2 * 2 * kTileKV;  // full[2] empty[2] q
  static constexpr uint32_t kPages = kBars + 64;           // page ids
  static size_t smem(int n_pages) {
    return kPages + sizeof(int) * (size_t)n_pages + 1024;  // + alignment
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
paged_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const int* __restrict__ tables, const int* __restrict__ pos,
                  __nv_bfloat16* __restrict__ o, int W, int nh, int kvh,
                  int PL, int B, float scale_log2) {
  using L = PagedLayout<D>;
  constexpr int H = L::kHalves;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_max, s_wg_min[2], s_wg_max[2];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sKV = sQ + L::kQ;  // stage s: K at + 2 s kTileKV, V after it
  const uint32_t bar = sQ + L::kBars;
  const uint32_t qbar = bar + 32;
  int* spage = reinterpret_cast<int*>(smem_raw + (sQ - raw) + L::kPages);

  const int s = blockIdx.z, h = blockIdx.y;
  const int g = h / (nh / kvh);
  const int w0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest rows first
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row_lo = w0 + wg * 64 + warp * 16 + lane / 4;  // d[i], i % 4 < 2
  const int row_hi = row_lo + 8;                           // d[i], i % 4 >= 2
  const int cq = 2 * (lane % 4);
  const int p_lo = row_lo < W ? pos[(size_t)s * W + row_lo] : -1;
  const int p_hi = row_hi < W ? pos[(size_t)s * W + row_hi] : -1;

  if (tid == 0) {
    s_max = -1;
    s_wg_max[0] = s_wg_max[1] = -1;
    s_wg_min[0] = s_wg_min[1] = INT_MAX;
    for (int st = 0; st < 2; ++st) {
      mbar_init(bar + 8 * st, 1);
      mbar_init(bar + 16 + 8 * st, kThreads);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  {
    const int mx = __reduce_max_sync(0xffffffffu, max(p_lo, p_hi));
    const int mn = __reduce_min_sync(
        0xffffffffu, min(row_lo < W ? p_lo : INT_MAX,
                         row_hi < W ? p_hi : INT_MAX));
    if (lane == 0) {
      atomicMax(&s_max, mx);
      atomicMax(&s_wg_max[wg], mx);
      atomicMin(&s_wg_min[wg], mn);
    }
  }
  __syncthreads();
  const int n_table = B * PL;  // keys the table can hold
  const int n_keys = min(s_max + 1, n_table);
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int ppt = kKeys / PL;  // pages per tile
  for (int i = tid; i < n_tiles * ppt; i += kThreads)
    spage[i] = i < B ? tables[(size_t)s * B + i] : 0;
  const int wg_max = s_wg_max[wg], wg_min = s_wg_min[wg];
  __syncthreads();

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto load_kv = [=](int stage, int tile) {
    const uint32_t full = bar + 8 * stage;
    const uint32_t sK = sKV + 2 * stage * L::kTileKV;
    mbar_expect_tx(full, 2 * L::kTileKV);
    for (int pp = 0; pp < ppt; ++pp) {
      const int row = spage[tile * ppt + pp] * PL;
      const uint32_t at = pp * PL * 128;
#pragma unroll
      for (int hh = 0; hh < H; ++hh) {
        tma_load(sK + hh * L::kHalfKV + at, mk, full, 64 * hh, g, row);
        tma_load(sK + L::kTileKV + hh * L::kHalfKV + at, mv, full, 64 * hh,
                 g, row);
      }
    }
  };

  if (tid == 0) {
    // the second warpgroup's rows only where some lie before W (it skips
    // every tile otherwise)
    const int halves = w0 + 64 < W ? 2 : 1;
    mbar_expect_tx(qbar, halves * H * 64 * 128);
#pragma unroll
    for (int hh = 0; hh < H; ++hh)
      for (int half = 0; half < halves; ++half)
        tma_load_4d(sQ + hh * L::kHalfQ + half * 64 * 128, &tq, qbar, 64 * hh,
                    h, w0 + half * 64, s);
    for (int st = 0; st < 2 && st < n_tiles; ++st) load_kv(st, st);
  }
  __syncwarp();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;
  const uint32_t sQw = sQ + wg * 64 * 128;  // this warpgroup's 64 rows
  mbar_wait(qbar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const uint32_t parity = (it >> 1) & 1;
    const int k0 = it * kKeys;
    const uint32_t sK = sKV + 2 * stage * L::kTileKV;
    const uint32_t sV = sK + L::kTileKV;
    mbar_wait(bar + 8 * stage, parity);

    if (k0 <= wg_max) {  // some row of this warpgroup sees the tile
      // S = Q . K^T over d in k16 steps
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // k within the 64-wide half
        wgmma_ss_n64(sc, desc(sQw + (kk / 4) * L::kHalfQ + off, 16, 1024),
                     desc(sK + (kk / 4) * L::kHalfKV + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax in log2 units; masked -> kNeg
      const bool mask = k0 + kKeys - 1 > wg_min || k0 + kKeys > n_table;
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] * scale_log2;
        if (mask) {
          const int col = k0 + 8 * (i / 4) + cq + (i & 1);
          const int lim = (i & 2) ? p_hi : p_lo;
          if (col > lim || col >= n_table) x = kNeg;
        }
        sc[i] = x;
        if (i & 2)
          mx_hi = fmaxf(mx_hi, x);
        else
          mx_lo = fmaxf(mx_lo, x);
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
      }
      const float a_lo = exp2f(m_lo - mx_lo), a_hi = exp2f(m_hi - mx_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      l_lo *= a_lo;
      l_hi *= a_hi;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        // masked entries are zeroed explicitly: in a row that has seen no
        // key yet the max is kNeg too and exp2(0) would be 1
        const float mrow = (i & 2) ? m_hi : m_lo;
        const float p = sc[i] > 0.5f * kNeg ? exp2f(sc[i] - mrow) : 0.f;
        sc[i] = p;
        if (i & 2)
          l_hi += p;
        else
          l_lo += p;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? a_hi : a_lo;

      // O += P . V over the 64 keys in k16 steps, P rounded to bf16
      uint32_t pa[4][4];
      acc_to_a<32>(sc, pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = desc(sV + kk * 16 * 128, L::kHalfKV, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128(acc, pa[kk], dv);
        else
          wgmma_rs_n64(acc, pa[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }

    // release the stage; thread 0 refills it with tile it + 2 once all 256
    // threads are done with it
    mbar_arrive(bar + 16 + 8 * stage);
    if (tid == 0 && it + 2 < n_tiles) {
      mbar_wait(bar + 16 + 8 * stage, parity);
      load_kv(stage, it + 2);
    }
    __syncwarp();
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = (i & 2) ? row_hi : row_lo;
    const float inv = (i & 2) ? inv_hi : inv_lo;
    if (row < W) {
      const int col = 8 * (i / 4) + cq;
      *reinterpret_cast<__nv_bfloat162*>(
          o + (((size_t)s * W + row) * nh + h) * D + col) =
          __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* pos, void* o, long long qw, long long qs, int S, int W,
           int nh, int kvh, int P, int PL, int B, float scale,
           cudaStream_t stream) {
  const int ppt = kKeys / PL;
  const size_t smem = PagedLayout<D>::smem((B + ppt - 1) / ppt * ppt);
  // first, before any map: binds the calling thread's context
  if (const cudaError_t e = allow_smem(paged_sm90_kernel<D>, smem))
    return (int)e;
  const cuuint64_t qdims[4] = {(cuuint64_t)D, (cuuint64_t)nh, (cuuint64_t)W,
                               (cuuint64_t)S};
  const cuuint64_t qstrides[3] = {(cuuint64_t)D * 2, (cuuint64_t)qw * 2,
                                  (cuuint64_t)qs * 2};
  const cuuint32_t qbox[4] = {64, 1, 64, 1};
  const cuuint64_t kdims[3] = {(cuuint64_t)D, (cuuint64_t)kvh,
                               (cuuint64_t)P * PL};
  const cuuint64_t kstrides[2] = {(cuuint64_t)D * 2, (cuuint64_t)kvh * D * 2};
  const cuuint32_t kbox[3] = {64, 1, (cuuint32_t)PL};
  CUtensorMap tq, tk, tv;
  if (!make_map_nd(&tq, q, 4, qdims, qstrides, qbox) ||
      !make_map_nd(&tk, k, 3, kdims, kstrides, kbox) ||
      !make_map_nd(&tv, v, 3, kdims, kstrides, kbox))
    return kMapRefused;
  const dim3 grid((unsigned)((W + kRows - 1) / kRows), (unsigned)nh,
                  (unsigned)S);
  paged_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tables, pos, (__nv_bfloat16*)o, W, nh, kvh, PL, B,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q [S, W, nh, hd] with window-row and slot strides q_w_stride and
// q_s_stride elements (heads packed; strides multiples of 16 bytes), arenas
// [P, PL, kvh, hd], out [S, W, nh, hd] contiguous; tables [S, B] and pos
// [S, W] int32; hd 64 or 128; PL 8, 16, 32 or 64; every bf16 pointer
// 16-byte aligned (TMA). Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for a shape it does not take, or
// kMapRefused (-1) for a tensor map that cuTensorMapEncodeTiled refuses.
extern "C" int pt_paged_attention_sm90(const void* q, const void* k,
                                       const void* v, const void* tables,
                                       const void* pos, void* out,
                                       long long q_w_stride,
                                       long long q_s_stride, int S, int W,
                                       int nh, int kvh, int hd, int P, int PL,
                                       int B, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S * W * nh == 0) return (int)cudaGetLastError();
  if (PL < 8 || PL > kKeys || kKeys % PL || nh % kvh)
    return (int)cudaErrorInvalidValue;
  if (hd == 128)
    return launch<128>(q, k, v, (const int*)tables, (const int*)pos, out,
                       q_w_stride, q_s_stride, S, W, nh, kvh, P, PL, B, scale,
                       st);
  if (hd == 64)
    return launch<64>(q, k, v, (const int*)tables, (const int*)pos, out,
                      q_w_stride, q_s_stride, S, W, nh, kvh, P, PL, B, scale,
                      st);
  return (int)cudaErrorInvalidValue;
}

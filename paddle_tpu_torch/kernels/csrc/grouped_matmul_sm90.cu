// Grouped (ragged) matrix product on Hopper's tensor cores (sm_90a): bf16
// operands, fp32 accumulation, bf16 results. Forward, the input-gradient
// product (dgrad) and the per-group weight gradient (wgrad).
//
// Replaces the TPU kernels that `grouped_matmul`
// (paddle_tpu/kernels/grouped_matmul.py:35) reaches, megablox `gmm`
// (:51-56) and its VJP's `gmm` (dgrad, transposed rhs) and `tgmm` (wgrad),
// for bf16; fp32 stays on the CUDA-core kernels of grouped_matmul.cu. Same
// functions, rows of lhs grouped by expert: rows [off_g, off_g + size_g)
// with off_g = sum(sizes[:g]) use rhs[g].
//   gmm:   out[m, N] = lhs[m, K] @ rhs[g]         rhs [G, K, N]
//          (trans)     lhs[m, K] @ rhs[g]^T       rhs [G, N, K]
//   tgmm:  d_rhs[g]  = lhs[rows_g]^T @ dout[rows_g]   -> [G, K, N]
// Rows past sum(sizes) get zeros (as jax.lax.ragged_dot gives them); an
// empty group's d_rhs is 0. Products of bf16 values are exact in fp32 and
// nothing intermediate is rounded, so the result differs from an fp32
// reference by one rounding to bf16 and the summation order.
//
// What bounds it on the H100: operations. At the MoE step's shapes
// ([16384, 1536] x [8, 1536, 2048]) a product is 103 GFLOP over 75 MB, some
// 1400 FLOPs per byte.
//
// What the design does about it: every product runs as wgmma on the tensor
// cores. A block of two warpgroups owns a 128 x 128 output tile, each
// warpgroup an m64n128 fp32 accumulator in registers. The reduction walks
// in steps of 64 (one 128-byte swizzled row of each operand), both operand
// tiles (16 KB each) streaming through a 3-stage TMA ring ("full" /
// "empty" mbarriers, thread 0 issuing the loads); one wgmma group stays in
// flight while the next stage is waited for, and a stage is refilled as
// soon as the group that read it has retired. About 100 KB of shared memory
// and at most 128 registers a thread keep two blocks on an SM, so one
// block's epilogue overlaps the other's loads. Operand layouts (see
// sm90_common.cuh):
//   forward  A = lhs rows, K-major;   B = rhs[g] rows of K, MN-major;
//   dgrad    A = dout rows, K-major;  B = rhs[g] read as its transpose,
//            contiguous along the reduction, so K-major;
//   wgrad    A = lhs rows taken as their transpose (MN-major, transpose
//            bit), B = dout rows, MN-major; the reduction runs over the
//            group's rows.
// TMA zero-fills the ragged edges of K and N and the rows past M.
//
// The group sizes stay on the device (group_layout.cuh): forward and dgrad
// launch ceil(m/128) + G + 1 row tiles, each block finds its group and its
// tile by a scan in shared memory, and no tile crosses a group boundary;
// rows that a load reads past its group's end only feed output rows that
// are not stored. wgrad launches one block per (N tile, K tile, group),
// walking the group's rows; in its last step the rows at or past the
// group's end belong to the next group, so they are zeroed in the dout tile
// in shared memory once it has landed (whole 128-byte rows, which the
// swizzle leaves in place), then fenced for the tensor cores.

#include "group_layout.cuh"
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kTile = pt::kGroupTile;        // output tile edge
constexpr int kStep = 64;                     // reduction step
constexpr int kStages = 3;
constexpr int kThreads = pt::kGroupThreads;  // two warpgroups
constexpr uint32_t kHalf = 64 * 128;          // [64 rows][64 bf16], 8 KB
constexpr uint32_t kOperand = 2 * kHalf;      // one operand tile, 16 KB
constexpr uint32_t kStage = 2 * kOperand;     // A then B
constexpr uint32_t kBars = kStages * kStage;  // full[kStages] empty[kStages]
constexpr size_t kSmem = kBars + 16 * kStages + 1024;  // + alignment slack

enum Mode { kForward = 0, kDgrad = 1, kWgrad = 2 };

// The block's mainloop: n_k reduction steps, `load(stage, step)` issuing a
// step's TMA loads (thread 0 only), `prep(stage, step)` run by every thread
// once the step has landed. acc: this warpgroup's m64n128 accumulator.
template <int MODE, typename Load, typename Prep>
__device__ __forceinline__ void mainloop(uint32_t s0, int n_k, Load load,
                                         Prep prep, float (&acc)[64]) {
  const int tid = threadIdx.x, wg = tid / 128;
  const uint32_t bar = s0 + kBars;
  if (tid == 0)
    for (int s = 0; s < kStages && s < n_k; ++s) load(s, s);
  __syncwarp();
  for (int it = 0; it < n_k; ++it) {
    const int stage = it % kStages;
    mbar_wait(bar + 8 * stage, (it / kStages) & 1);
    prep(stage, it);
    const uint32_t sA = s0 + stage * kStage;
    const uint32_t sB = sA + kOperand;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      if constexpr (MODE == kForward)
        wgmma_ss_n128<0, 1>(acc, desc(sA + wg * kHalf + kk * 32, 16, 1024),
                            desc(sB + kk * 16 * 128, kHalf, 1024), 1);
      else if constexpr (MODE == kDgrad)
        wgmma_ss_n128<0, 0>(acc, desc(sA + wg * kHalf + kk * 32, 16, 1024),
                            desc(sB + kk * 32, 16, 1024), 1);
      else
        wgmma_ss_n128<1, 1>(acc,
                            desc(sA + wg * kHalf + kk * 16 * 128, kHalf, 1024),
                            desc(sB + kk * 16 * 128, kHalf, 1024), 1);
    }
    wgmma_commit();
    // the group of step it - 1 has retired: release its stage, and thread
    // 0 refills it with step it - 1 + kStages once all 256 threads have
    wgmma_wait<1>();
    if (it > 0) {
      const int j = it - 1, sj = j % kStages;
      mbar_arrive(bar + 8 * (kStages + sj));
      if (tid == 0 && j + kStages < n_k) {
        mbar_wait(bar + 8 * (kStages + sj), (j / kStages) & 1);
        load(sj, j + kStages);
      }
      __syncwarp();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

__device__ __forceinline__ uint32_t ring_base(uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

__device__ __forceinline__ void init_bars(uint32_t s0) {
  if (threadIdx.x == 0) {
    const uint32_t bar = s0 + kBars;
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (kStages + s), kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// Store this warpgroup's accumulator as rows [r0, r0 + 64) of a row-major
// [*, ld] bf16 matrix at `c`, rows below `rows` and columns below `cols`
// (even) only; the tile's columns start at column 0 of `c`.
__device__ __forceinline__ void store_tile(__nv_bfloat16* c, long long ld,
                                           int r0, int rows, int cols,
                                           const float (&acc)[64]) {
  const int tid = threadIdx.x, warp = (tid % 128) / 32, lane = tid % 32;
  const int r_lo = r0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = (i & 2) ? r_lo + 8 : r_lo;
    const int col = 8 * (i / 4) + cq;
    if (r < rows && col < cols)
      *reinterpret_cast<__nv_bfloat162*>(c + (long long)r * ld + col) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
gmm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const int* __restrict__ sizes, __nv_bfloat16* __restrict__ out,
                int M, int K, int N, int G) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ pt::GroupLayout L;
  __shared__ pt::RowTile s_tile;
  pt::group_layout(sizes, G, M, L);
  const pt::RowTile rt = pt::row_tile(L, G, blockIdx.x, s_tile);
  if (rt.group < 0) return;  // past the last tile: uniform across the block
  const int g = rt.group, row0 = rt.row0;
  const int n0 = blockIdx.y * kTile;
  const uint32_t s0 = ring_base(smem_raw);
  init_bars(s0);

  const CUtensorMap* ma = &ta;
  const CUtensorMap* mb = &tb;
  const uint32_t bar = s0 + kBars;
  auto load = [=](int stage, int kt) {
    const uint32_t full = bar + 8 * stage;
    const uint32_t sA = s0 + stage * kStage;
    const uint32_t sB = sA + kOperand;
    mbar_expect_tx(full, kStage);
    tma_load(sA, ma, full, kt * kStep, row0, 0);
    if (MODE == kForward) {
      tma_load(sB, mb, full, n0, kt * kStep, g);
      tma_load(sB + kHalf, mb, full, n0 + 64, kt * kStep, g);
    } else {
      tma_load(sB, mb, full, kt * kStep, n0, g);
    }
  };
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // the rows past the last group (g == G) load nothing and store zeros
  const int n_k = g < G ? (K + kStep - 1) / kStep : 0;
  mainloop<MODE>(s0, n_k, load, [](int, int) {}, acc);
  const int wg = threadIdx.x / 128;
  store_tile(out + (long long)row0 * N + n0, N, wg * 64, rt.rows, N - n0,
             acc);
}

__global__ void __launch_bounds__(kThreads, 2)
tgmm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const int* __restrict__ sizes,
                 __nv_bfloat16* __restrict__ drhs, int M, int K, int N,
                 int G) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ pt::GroupLayout L;
  pt::group_layout(sizes, G, M, L);
  const int g = blockIdx.z;
  const int k0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int start = L.start[g], end = L.end[g];
  const uint32_t s0 = ring_base(smem_raw);
  init_bars(s0);

  const CUtensorMap* ma = &ta;
  const CUtensorMap* mb = &tb;
  const uint32_t bar = s0 + kBars;
  auto load = [=](int stage, int kt) {
    const uint32_t full = bar + 8 * stage;
    const uint32_t sA = s0 + stage * kStage;
    const uint32_t sB = sA + kOperand;
    const int r = start + kt * kStep;
    mbar_expect_tx(full, kStage);
    tma_load(sA, ma, full, k0, r, 0);
    tma_load(sA + kHalf, ma, full, k0 + 64, r, 0);
    tma_load(sB, mb, full, n0, r, 0);
    tma_load(sB + kHalf, mb, full, n0 + 64, r, 0);
  };
  // the last step's rows at or past `end`: zero them in the dout tile
  auto prep = [=](int stage, int kt) {
    const int valid = end - (start + kt * kStep);
    if (valid >= kStep) return;  // uniform across the block
    const uint32_t sB = s0 + stage * kStage + kOperand;
    const int chunks = (kStep - valid) * 8;  // 16-byte chunks of one half
    for (int c = threadIdx.x; c < 2 * chunks; c += kThreads) {
      const int h = c / chunks, rc = c % chunks;
      st_shared_zero16(sB + h * kHalf + (valid + rc / 8) * 128 +
                       (rc % 8) * 16);
    }
    fence_proxy_async();
    __syncthreads();
  };
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int n_k = (end - start + kStep - 1) / kStep;
  mainloop<kWgrad>(s0, n_k, load, prep, acc);
  const int wg = threadIdx.x / 128;
  store_tile(drhs + (long long)g * K * N + (long long)k0 * N + n0, N,
             wg * 64, K - k0, N - n0, acc);
}

}  // namespace

// bf16 out [M, N] = lhs [M, K] @ rhs[g] per row group; rhs [G, K, N], or
// [G, N, K] with trans (the dgrad). sizes: int32 [G] on the device. K and N
// multiples of 8, 1 <= G <= 128, pointers 16-byte aligned (TMA). Returns
// cudaGetLastError() after the launch, or kMapRefused (-1) for a tensor map
// that cuTensorMapEncodeTiled refuses.
extern "C" int pt_gmm_sm90(const void* lhs, const void* rhs, const void* sizes,
                           void* out, int M, int K, int N, int G, int trans,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if (const cudaError_t e = trans ? allow_smem(gmm_sm90_kernel<kDgrad>, kSmem)
                                  : allow_smem(gmm_sm90_kernel<kForward>,
                                               kSmem))
    return (int)e;
  CUtensorMap ta, tb;
  const bool ok = make_map(&ta, lhs, 1, M, K, kTile) &&
                  (trans ? make_map(&tb, rhs, G, N, K, kTile)
                         : make_map(&tb, rhs, G, K, N, kStep));
  if (!ok) return kMapRefused;
  const dim3 grid((unsigned)((M + kTile - 1) / kTile + G + 1),
                  (unsigned)((N + kTile - 1) / kTile));
  if (trans) {
    gmm_sm90_kernel<kDgrad><<<grid, kThreads, kSmem, st>>>(
        ta, tb, (const int*)sizes, (__nv_bfloat16*)out, M, K, N, G);
  } else {
    gmm_sm90_kernel<kForward><<<grid, kThreads, kSmem, st>>>(
        ta, tb, (const int*)sizes, (__nv_bfloat16*)out, M, K, N, G);
  }
  return (int)cudaGetLastError();
}

// bf16 drhs [G, K, N] = lhs[rows_g]^T @ dout[rows_g] per group; lhs [M, K],
// dout [M, N]. Same constraints as pt_gmm_sm90.
extern "C" int pt_tgmm_sm90(const void* lhs, const void* dout,
                            const void* sizes, void* drhs, int M, int K, int N,
                            int G, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K == 0 || N == 0) return (int)cudaGetLastError();
  if (M == 0)  // no rows: every group is empty (and there is nothing to map)
    return (int)cudaMemsetAsync(drhs, 0, (size_t)G * K * N * 2, st);
  if (const cudaError_t e = allow_smem(tgmm_sm90_kernel, kSmem))
    return (int)e;
  CUtensorMap ta, tb;
  if (!make_map(&ta, lhs, 1, M, K, kStep) ||
      !make_map(&tb, dout, 1, M, N, kStep))
    return kMapRefused;
  const dim3 grid((unsigned)((N + kTile - 1) / kTile),
                  (unsigned)((K + kTile - 1) / kTile), (unsigned)G);
  tgmm_sm90_kernel<<<grid, kThreads, kSmem, st>>>(
      ta, tb, (const int*)sizes, (__nv_bfloat16*)drhs, M, K, N, G);
  return (int)cudaGetLastError();
}

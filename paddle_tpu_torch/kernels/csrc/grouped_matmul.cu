// Grouped (ragged) matrix product for Hopper (sm_90a): forward, the
// input-gradient product (dgrad) and the per-group weight gradient (wgrad).
//
// Replaces the TPU kernels that `grouped_matmul`
// (paddle_tpu/kernels/grouped_matmul.py:35) reaches: megablox `gmm`
// (:51-56) for the forward, and its VJP's `gmm` (dgrad, transposed rhs) and
// `tgmm` (wgrad). Same functions, rows of lhs grouped by expert: rows
// [off_g, off_g + size_g) with off_g = sum(sizes[:g]) use rhs[g].
//   gmm:   out[m, N] = lhs[m, K] @ rhs[g]         rhs [G, K, N]
//          (trans)     lhs[m, K] @ rhs[g]^T       rhs [G, N, K]
//   tgmm:  d_rhs[g]  = lhs[rows_g]^T @ dout[rows_g]   -> [G, K, N]
// fp32 accumulation, results in the inputs' type. Rows past sum(sizes) get
// zeros (as jax.lax.ragged_dot gives them); an empty group's d_rhs is 0.
//
// What bounds it on the H100: operations. At the MoE step's shapes
// ([16384, 1536] x [8, 1536, 2048]) a product is 103 GFLOP over 75 MB, some
// 1400 FLOPs per byte.
//
// What the design does about it, simple first: a CUDA-core SGEMM. A block
// of 256 threads owns a 128 x 128 tile of the output and walks the
// reduction in steps of 16, both operand tiles staged in shared memory as
// fp32 (converted once on the way in, with 16-byte vector loads), the next
// step's tiles fetched into registers while the current one is multiplied;
// each thread accumulates an 8 x 8 sub-tile in registers. bf16 operands go
// to the tensor-core kernels of grouped_matmul_sm90.cu; this one stays for
// fp32.
//
// The group sizes stay on the device (group_layout.cuh): the host never
// learns them, so a step does not wait on the card. gmm launches
// ceil(m/128) + G + 1 row
// tiles (an upper bound: each group wastes at most one partial tile, and
// the rows past the last group form one more "group" of zeros); each block
// scans the <= 129 sizes in shared memory, finds its group and its tile in
// it, and exits when it has none. No tile crosses a group boundary. tgmm
// launches one block per (K tile, N tile, group) and walks its group's rows.

#include "group_layout.cuh"
#include "vec16.cuh"

namespace {

using pt::GroupLayout;

constexpr int kTile = pt::kGroupTile;      // output tile edge (rows, columns)
constexpr int kStep = 16;                   // reduction step
constexpr int kThreads = pt::kGroupThreads; // 16 x 16 threads, 8 x 8 outputs
constexpr int kLds = kTile + 4;

// One operand tile: kTile "outer" indices (rows of the output for the left
// operand, columns for the right) by kStep reduction indices, staged as
// S[p][o]. RC: contiguous along the reduction (element (o, p) at
// base[o * ld + p]); otherwise contiguous along the outer index (element
// (o, p) at base[p * ld + o]). A vector that is out of range is zero; the
// contiguous extent is a multiple of 8, so a vector is all in or all out.
template <typename T, bool RC>
struct OperandTile {
  static constexpr int V = pt::Vec16<T>::N;
  static constexpr int NV = kTile * kStep / V / kThreads;  // bf16 1, fp32 2
  float r[NV][V];

  __device__ __forceinline__ static void coords(int k, int& o, int& p) {
    const int v = threadIdx.x + k * kThreads;
    if (RC) {
      o = v / (kStep / V);
      p = (v % (kStep / V)) * V;
    } else {
      p = v / (kTile / V);
      o = (v % (kTile / V)) * V;
    }
  }

  __device__ __forceinline__ void fetch(const T* base, long long ld,
                                        int o_valid, int p_valid) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      int o, p;
      coords(k, o, p);
      const bool ok = RC ? (o < o_valid && p < p_valid)
                         : (p < p_valid && o < o_valid);
      if (ok) {
        pt::Vec16<T>::load(RC ? base + (long long)o * ld + p
                              : base + (long long)p * ld + o,
                           r[k]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) r[k][e] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float (*S)[kLds]) const {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      int o, p;
      coords(k, o, p);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (RC)
          S[p + e][o] = r[k][e];
        else
          S[p][o + e] = r[k][e];
      }
    }
  }
};

// acc += A (kTile x red) @ B (red x kTile). `a` and `b` point at reduction
// index 0 of the block's tiles; a_ov / b_ov are the valid outer extents.
template <typename T, bool A_RC, bool B_RC>
__device__ __forceinline__ void mainloop(const T* a, long long lda, int a_ov,
                                         const T* b, long long ldb, int b_ov,
                                         int red, float acc[8][8],
                                         float (*As)[kLds],
                                         float (*Bs)[kLds]) {
  if (red <= 0) return;
  OperandTile<T, A_RC> ta;
  OperandTile<T, B_RC> tb;
  ta.fetch(a, lda, a_ov, red);
  tb.fetch(b, ldb, b_ov, red);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int p0 = 0; p0 < red; p0 += kStep) {
    __syncthreads();  // the previous step is done reading the tiles
    ta.store(As);
    tb.store(Bs);
    __syncthreads();
    if (p0 + kStep < red) {
      a += A_RC ? (long long)kStep : kStep * lda;
      b += B_RC ? (long long)kStep : kStep * ldb;
      ta.fetch(a, lda, a_ov, red - p0 - kStep);
      tb.fetch(b, ldb, b_ov, red - p0 - kStep);
    }
#pragma unroll
    for (int p = 0; p < kStep; ++p) {
      float av[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[p][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[p][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[p][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[p][tx * 8 + 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Write the block's tile: `rows` valid rows, `cols` valid columns (a
// multiple of 8), row stride ldc.
template <typename T>
__device__ __forceinline__ void epilogue(T* c, long long ldc, int rows,
                                         int cols, const float acc[8][8]) {
  constexpr int V = pt::Vec16<T>::N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int col = tx * 8;
  if (col >= cols) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r < rows) {
#pragma unroll
      for (int e = 0; e < 8; e += V)
        pt::Vec16<T>::store(c + (long long)r * ldc + col + e, &acc[i][e]);
    }
  }
}

template <typename T, bool TRANS>
__global__ void __launch_bounds__(kThreads, 2)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
           const int* __restrict__ sizes, T* __restrict__ out, int M, int K,
           int N, int G) {
  __shared__ __align__(16) float As[kStep][kLds];
  __shared__ __align__(16) float Bs[kStep][kLds];
  __shared__ GroupLayout L;
  __shared__ pt::RowTile s_tile;
  pt::group_layout(sizes, G, M, L);
  const pt::RowTile rt = pt::row_tile(L, G, blockIdx.x, s_tile);
  const int g = rt.group;
  if (g < 0) return;  // past the last tile: uniform across the block
  const int row0 = rt.row0, rows = rt.rows;
  const int j0 = blockIdx.y * kTile;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (g < G) {
    const T* a = lhs + (long long)row0 * K;
    const T* b = TRANS ? rhs + (long long)g * N * K + (long long)j0 * K
                       : rhs + (long long)g * K * N + j0;
    mainloop<T, true, TRANS>(a, K, rows, b, TRANS ? K : N, N - j0, K, acc,
                             As, Bs);
  }
  epilogue<T>(out + (long long)row0 * N + j0, N, rows, N - j0, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
tgmm_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
            const int* __restrict__ sizes, T* __restrict__ drhs, int M,
            int K, int N, int G) {
  __shared__ __align__(16) float As[kStep][kLds];
  __shared__ __align__(16) float Bs[kStep][kLds];
  __shared__ GroupLayout L;
  pt::group_layout(sizes, G, M, L);
  const int g = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int start = L.start[g], rows = L.end[g] - L.start[g];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  mainloop<T, false, false>(lhs + (long long)start * K + i0, K, K - i0,
                            dout + (long long)start * N + j0, N, N - j0,
                            rows, acc, As, Bs);
  epilogue<T>(drhs + (long long)g * K * N + (long long)i0 * N + j0, N,
              min(kTile, K - i0), N - j0, acc);
}

template <typename T>
void launch_gmm(const void* lhs, const void* rhs, const void* sizes,
                void* out, int M, int K, int N, int G, int trans,
                cudaStream_t st) {
  const dim3 grid((M + kTile - 1) / kTile + G + 1, (N + kTile - 1) / kTile);
  if (trans)
    gmm_kernel<T, true><<<grid, kThreads, 0, st>>>(
        (const T*)lhs, (const T*)rhs, (const int*)sizes, (T*)out, M, K, N, G);
  else
    gmm_kernel<T, false><<<grid, kThreads, 0, st>>>(
        (const T*)lhs, (const T*)rhs, (const int*)sizes, (T*)out, M, K, N, G);
}

template <typename T>
void launch_tgmm(const void* lhs, const void* dout, const void* sizes,
                 void* drhs, int M, int K, int N, int G, cudaStream_t st) {
  const dim3 grid((N + kTile - 1) / kTile, (K + kTile - 1) / kTile, G);
  tgmm_kernel<T><<<grid, kThreads, 0, st>>>(
      (const T*)lhs, (const T*)dout, (const int*)sizes, (T*)drhs, M, K, N, G);
}

}  // namespace

// out [M, N] = lhs [M, K] @ rhs[g] per row group; rhs [G, K, N], or
// [G, N, K] with trans (the dgrad). sizes: int32 [G] on the device.
// K and N multiples of 8, 1 <= G <= 128, pointers 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int pt_gmm(const void* lhs, const void* rhs, const void* sizes,
                      void* out, int M, int K, int N, int G, int trans,
                      int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if (dtype == 0)
    launch_gmm<float>(lhs, rhs, sizes, out, M, K, N, G, trans, st);
  else
    launch_gmm<__nv_bfloat16>(lhs, rhs, sizes, out, M, K, N, G, trans, st);
  return (int)cudaGetLastError();
}

// drhs [G, K, N] = lhs[rows_g]^T @ dout[rows_g] per group; lhs [M, K],
// dout [M, N]. Same constraints as pt_gmm.
extern "C" int pt_tgmm(const void* lhs, const void* dout, const void* sizes,
                       void* drhs, int M, int K, int N, int G, int dtype,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K == 0 || N == 0) return (int)cudaGetLastError();
  if (dtype == 0)
    launch_tgmm<float>(lhs, dout, sizes, drhs, M, K, N, G, st);
  else
    launch_tgmm<__nv_bfloat16>(lhs, dout, sizes, drhs, M, K, N, G, st);
  return (int)cudaGetLastError();
}

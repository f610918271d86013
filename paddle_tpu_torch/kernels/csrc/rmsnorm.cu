// RMSNorm and RMSNorm+residual, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/kernels/pallas/rmsnorm.py:
//   forward  `_fwd_kernel` (:47, +residual) and `_fwd_kernel_plain` (:57),
//            both launched by `_fwd_pallas` (:66; calls :75 and :88);
//   backward `_bwd_kernel` (:127, +residual) and `_bwd_kernel_plain` (:147),
//            both launched by `_bwd_pallas` (:166; calls :179 and :186).
// Same functions, on rows of width h:
//   forward  s = x (+ res, in fp32; stored in x's type), rstd = rsqrt(mean(s^2)
//            + eps) (fp32 [n]), y = s * rstd * w;
//   backward g = dy * w, ds = rstd * (g - s * rstd^2 * mean(g * s)) (+ dres),
//            dx = ds, and dw = sum over rows of dy * s * rstd (fp32, cast to
//            w's type).
// The plain and +residual variants are one kernel templated on RESIDUAL: the
// plain one reads no residual and writes no s, as on the TPU.
//
// What bounds it on the H100: bytes. Each element is read and written once
// with a handful of FLOPs (about 1 FLOP per byte against the ~295 at which
// bf16 tensor cores would become the limit), so the floor is the [n, h]
// tensors moved over 3.35 TB/s.
//
// What the design does about it. The forward reads each row from device
// memory once and keeps it in registers: a warp takes a row, each lane loads
// NV 16-byte vectors of it (8 bf16 or 4 fp32 values; vec16.cuh), all issued
// before any is used, sums the squares, and writes y (and s) from the same
// registers with 16-byte stores; w is read as vectors too. One instance per
// range of vectors per lane (NV 2, 4, 8, and 16 for fp32: up to 64 floats a
// lane) covers rows up to 2048 wide, which both training steps use (2048
// dense, 1536 MoE), at 4 warps (rows) a block; at 80 registers a thread
// some 24 rows (96 KB) are in flight on each SM. A wider row takes a looping
// instance that reads it twice with the same vectors (the second pass from
// L1/L2), and a row that is not whole 16-byte vectors, or an operand that
// does not start on a 16-byte boundary, takes the scalar instance (lanes
// stride the row one element at a time, two passes).
//
// The backward reads s and dy (and dres) once and writes dx once, the same
// way: a warp takes a row, each lane holds its NV 16-byte vectors of s and
// dy (and dres) in registers, mean(g * s) is a warp shuffle sum with no
// block barrier, and dx is written from the same registers; w is read as
// vectors once per warp and kept in registers while the warp walks its
// rows (NV 2, 4, 8: rows up to 2048 wide in bf16, 1024 in fp32; a looping
// instance reads wider rows, up to 8192, twice; the scalar kernel, a block
// a row, takes rows that are not whole vectors, unaligned operands and
// wider rows). The TPU backward carries dw in VMEM across its sequential
// row grid; Hopper blocks run in parallel and carry nothing. So the grid
// is the blocks the card keeps resident (the caller's plan: 2 per SM, from
// its SM count), each walks a contiguous chunk of rows with 4 warps, each
// warp adds dy * s * rstd into its own fp32 row of shared memory (a lane
// owns fixed columns), and the block sums its warps' rows in warp order
// into one row of an fp32 [n_blocks, h] scratch. A second kernel, launched
// as a programmatic dependent (griddepcontrol: it is set up while the rows
// finish), sums the scratch's columns: a block per 32 columns, 16 row
// groups each summing every 16th row in order, then the groups in order.
// Deterministic, no atomics. The earlier backward (a 256-thread block per
// row with scalar loads that read s, dy and w twice, 512 blocks, and a
// column sum of one thread per column on 8 blocks at h 2048) stays behind
// pt_rmsnorm_bwd_earlier for timing beside it; no path calls it.

#include "attention_common.cuh"
#include "vec16.cuh"

namespace {

constexpr int kFwdWarps = 4;     // rows per forward block
constexpr int kBwdWarps = 4;     // rows in flight per backward block
constexpr int kBwdWidest = 8192;  // widest row of the vector backward
constexpr int kBwdSmemMost = kBwdWarps * kBwdWidest * 4;  // its dw rows
constexpr int kColGroups = 16;   // row groups of the dw column sum
constexpr int kBwdThreads = 256;  // the scalar backward (a block a row)

// Scalar instance: any width and alignment. Lanes stride the row one element
// at a time; the second pass, which writes y, reads the row again.
template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(kFwdWarps * 32)
rmsnorm_fwd_scalar_kernel(const T* __restrict__ x, const T* __restrict__ res,
                          const T* __restrict__ w, T* __restrict__ y,
                          T* __restrict__ s_out, float* __restrict__ rstd,
                          int n, int h, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFwdWarps + warp;
  if (row >= n) return;
  const size_t base = (size_t)row * h;
  float ss = 0.f;
  for (int d = lane; d < h; d += 32) {
    float s = pt::to_f(x[base + d]);
    if (RESIDUAL) s += pt::to_f(res[base + d]);
    ss = fmaf(s, s, ss);
  }
  const float r = rsqrtf(pt::warp_sum(ss) / (float)h + eps);
  for (int d = lane; d < h; d += 32) {
    float s = pt::to_f(x[base + d]);
    if (RESIDUAL) s += pt::to_f(res[base + d]);
    y[base + d] = pt::from_f<T>(s * r * pt::to_f(w[d]));
    if (RESIDUAL) s_out[base + d] = pt::from_f<T>(s);
  }
  if (lane == 0) rstd[row] = r;
}

// Vector instances: rows of nv = h / VEC 16-byte vectors, 16-byte aligned.
// NV > 0: lane l holds vectors l + 32 i (i < NV) in registers between the
// sum of squares and the write, so the row is read once. NV == 0: the
// looping instance for wider rows, which reads each vector twice.
template <typename T, bool RESIDUAL, int NV>
__global__ void __launch_bounds__(kFwdWarps * 32)
rmsnorm_fwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       const T* __restrict__ w, T* __restrict__ y,
                       T* __restrict__ s_out, float* __restrict__ rstd,
                       int n, int h, float eps) {
  using V = pt::Vec16<T>;
  constexpr int VEC = V::N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFwdWarps + warp;
  if (row >= n) return;
  const int nv = h / VEC;
  const size_t base = (size_t)row * h;
  float ss = 0.f;
  if constexpr (NV > 0) {
    float sv[NV][VEC];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int at = (lane + 32 * c) * VEC;
      if (lane + 32 * c < nv) {
        V::load(x + base + at, sv[c]);
        if (RESIDUAL) {
          float rv[VEC];
          V::load(res + base + at, rv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) sv[c][i] += rv[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) sv[c][i] = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(sv[c][i], sv[c][i], ss);
    const float r = rsqrtf(pt::warp_sum(ss) / (float)h + eps);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int at = (lane + 32 * c) * VEC;
      if (lane + 32 * c < nv) {
        float wv[VEC], yv[VEC];
        V::load(w + at, wv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) yv[i] = sv[c][i] * r * wv[i];
        V::store(y + base + at, yv);
        if (RESIDUAL) V::store(s_out + base + at, sv[c]);
      }
    }
    if (lane == 0) rstd[row] = r;
  } else {
    float sv[VEC], rv[VEC];
    for (int c = lane; c < nv; c += 32) {
      V::load(x + base + c * VEC, sv);
      if (RESIDUAL) V::load(res + base + c * VEC, rv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (RESIDUAL) sv[i] += rv[i];
        ss = fmaf(sv[i], sv[i], ss);
      }
    }
    const float r = rsqrtf(pt::warp_sum(ss) / (float)h + eps);
    for (int c = lane; c < nv; c += 32) {
      float wv[VEC], yv[VEC];
      V::load(x + base + c * VEC, sv);
      if (RESIDUAL) V::load(res + base + c * VEC, rv);
      V::load(w + c * VEC, wv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (RESIDUAL) sv[i] += rv[i];
        yv[i] = sv[i] * r * wv[i];
      }
      V::store(y + base + c * VEC, yv);
      if (RESIDUAL) V::store(s_out + base + c * VEC, sv);
    }
    if (lane == 0) rstd[row] = r;
  }
}

// Scalar instance of the backward (any width and alignment; also the
// earlier design, pt_rmsnorm_bwd_earlier): one block per chunk of
// `rows_per_block` rows, all its threads on one row at a time. Shared
// memory: dw partial [h] + one float per warp for the row reduction.
template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ s, const T* __restrict__ w,
                   const float* __restrict__ rstd, const T* __restrict__ dy,
                   const T* __restrict__ dr, T* __restrict__ dx,
                   float* __restrict__ dw_part, int n, int h,
                   int rows_per_block) {
  extern __shared__ float sm[];
  float* dw_acc = sm;
  float* red = sm + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int d = tid; d < h; d += kBwdThreads) dw_acc[d] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const size_t base = (size_t)row * h;
    const float r = rstd[row];
    float part = 0.f;  // sum of g * s over this thread's columns
    for (int d = tid; d < h; d += kBwdThreads)
      part = fmaf(pt::to_f(dy[base + d]) * pt::to_f(w[d]),
                  pt::to_f(s[base + d]), part);
    part = pt::warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < kBwdThreads / 32; ++i) tot += red[i];
    const float mean_gs = tot / (float)h;
    for (int d = tid; d < h; d += kBwdThreads) {
      const float sv = pt::to_f(s[base + d]);
      const float dyv = pt::to_f(dy[base + d]);
      float ds = r * (dyv * pt::to_f(w[d]) - sv * (r * r) * mean_gs);
      if (RESIDUAL) ds += pt::to_f(dr[base + d]);
      dx[base + d] = pt::from_f<T>(ds);
      dw_acc[d] = fmaf(dyv * sv, r, dw_acc[d]);
    }
    __syncthreads();  // `red` is rewritten by the next row
  }
  for (int d = tid; d < h; d += kBwdThreads)
    dw_part[(size_t)blockIdx.x * h + d] = dw_acc[d];
}

// The earlier column sum: dw[d] = sum over blocks of dw_part[b, d], one
// thread per column, cast to T.
template <typename T>
__global__ void rmsnorm_dw_sum_kernel(const float* __restrict__ dw_part,
                                      T* __restrict__ dw, int n_blocks,
                                      int h) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= h) return;
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += dw_part[(size_t)b * h + d];
  dw[d] = pt::from_f<T>(acc);
}

// Vector instances of the backward: rows of nv = h / VEC 16-byte vectors,
// every operand 16-byte aligned, h <= kBwdWidest. Block b walks rows [b *
// rows_per_block, ...), warp w taking every kBwdWarps-th of them from w.
// NV > 0: lane l holds vectors l + 32 i (i < NV) of s, dy (and dr) in
// registers from the row's one read to its dx store, and w's from the
// first row on. NV == 0: the looping instance for wider rows, which reads
// each vector of a row twice (the second time from L1/L2) and w per row.
// Each warp adds dy * s * rstd into its own fp32 row of shared memory
// (dws [kBwdWarps][h], fixed columns per lane); the block then sums its
// warps' rows in warp order into its partial row of dw_part.
// d[i] += dy[i] * s[i] * r for one vector's columns, as float4s
template <int VEC>
__device__ __forceinline__ void add_dw(float* d, const float* gf,
                                       const float* sf, float r) {
#pragma unroll
  for (int f = 0; f < VEC / 4; ++f) {
    float4 a = reinterpret_cast<float4*>(d)[f];
    a.x = fmaf(gf[4 * f] * sf[4 * f], r, a.x);
    a.y = fmaf(gf[4 * f + 1] * sf[4 * f + 1], r, a.y);
    a.z = fmaf(gf[4 * f + 2] * sf[4 * f + 2], r, a.z);
    a.w = fmaf(gf[4 * f + 3] * sf[4 * f + 3], r, a.w);
    reinterpret_cast<float4*>(d)[f] = a;
  }
}

template <typename T, bool RESIDUAL, int NV>
__global__ void __launch_bounds__(kBwdWarps * 32)
rmsnorm_bwd_vec_kernel(const T* __restrict__ s, const T* __restrict__ w,
                       const float* __restrict__ rstd,
                       const T* __restrict__ dy, const T* __restrict__ dr,
                       T* __restrict__ dx, float* __restrict__ dw_part, int n,
                       int h, int rows_per_block) {
  using V = pt::Vec16<T>;
  constexpr int VEC = V::N;
  constexpr int kHeld = NV > 0 ? NV : 1;
  extern __shared__ __align__(16) float dws[];
  // the column sum may start launching now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = h / VEC;
  float* mine = dws + (size_t)warp * h;
  for (int i = lane; i < h; i += 32) mine[i] = 0.f;
  __syncwarp();
  uint4 wr[kHeld];
  if constexpr (NV > 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int v = lane + 32 * c;
      wr[c] = v < nv ? *reinterpret_cast<const uint4*>(w + v * VEC)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += kBwdWarps) {
    const size_t base = (size_t)row * h;
    const float r = rstd[row];
    float part = 0.f;  // sum of dy * w * s over the lane's columns
    if constexpr (NV > 0) {
      uint4 sr[NV], gr[NV], rr[RESIDUAL ? NV : 1];
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int v = lane + 32 * c;
        if (v < nv) {
          sr[c] = *reinterpret_cast<const uint4*>(s + base + v * VEC);
          gr[c] = *reinterpret_cast<const uint4*>(dy + base + v * VEC);
          if constexpr (RESIDUAL)
            rr[c] = *reinterpret_cast<const uint4*>(dr + base + v * VEC);
        }
      }
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        if (lane + 32 * c >= nv) continue;
        float sf[VEC], gf[VEC], wf[VEC];
        V::unpack(sr[c], sf);
        V::unpack(gr[c], gf);
        V::unpack(wr[c], wf);
#pragma unroll
        for (int i = 0; i < VEC; ++i) part = fmaf(gf[i] * wf[i], sf[i], part);
      }
      const float mean_gs = pt::warp_sum(part) / (float)h;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int v = lane + 32 * c;
        if (v >= nv) continue;
        float sf[VEC], gf[VEC], wf[VEC], o[VEC];
        V::unpack(sr[c], sf);
        V::unpack(gr[c], gf);
        V::unpack(wr[c], wf);
        if constexpr (RESIDUAL) V::unpack(rr[c], o);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float ds = r * (gf[i] * wf[i] - sf[i] * (r * r) * mean_gs);
          if constexpr (RESIDUAL) o[i] += ds;
          else o[i] = ds;
        }
        V::store(dx + base + v * VEC, o);
        add_dw<VEC>(mine + v * VEC, gf, sf, r);
      }
    } else {
      for (int v = lane; v < nv; v += 32) {
        float sf[VEC], gf[VEC], wf[VEC];
        V::load(s + base + v * VEC, sf);
        V::load(dy + base + v * VEC, gf);
        V::load(w + v * VEC, wf);
#pragma unroll
        for (int i = 0; i < VEC; ++i) part = fmaf(gf[i] * wf[i], sf[i], part);
      }
      const float mean_gs = pt::warp_sum(part) / (float)h;
      for (int v = lane; v < nv; v += 32) {
        float sf[VEC], gf[VEC], wf[VEC], o[VEC];
        V::load(s + base + v * VEC, sf);
        V::load(dy + base + v * VEC, gf);
        V::load(w + v * VEC, wf);
        if constexpr (RESIDUAL) V::load(dr + base + v * VEC, o);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float ds = r * (gf[i] * wf[i] - sf[i] * (r * r) * mean_gs);
          if constexpr (RESIDUAL) o[i] += ds;
          else o[i] = ds;
        }
        V::store(dx + base + v * VEC, o);
        add_dw<VEC>(mine + v * VEC, gf, sf, r);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    float a = dws[i];
#pragma unroll
    for (int q = 1; q < kBwdWarps; ++q) a += dws[(size_t)q * h + i];
    dw_part[(size_t)blockIdx.x * h + i] = a;
  }
}

// dw[col] = the sum over the partial rows, cast to T: block of 32 columns
// (one 128-byte line a row) by kColGroups row groups; group g sums rows g,
// g + kColGroups, ... in order, then the groups are added in order.
// Launched as a programmatic dependent of the row kernel.
template <typename T>
__global__ void __launch_bounds__(32 * kColGroups)
rmsnorm_dw_cols_kernel(const float* __restrict__ dw_part, T* __restrict__ dw,
                       int n_blocks, int h) {
  __shared__ float red[kColGroups][33];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + c;
  float acc = 0.f;
  if (col < h)
    for (int b = g; b < n_blocks; b += kColGroups)
      acc += dw_part[(size_t)b * h + col];
  red[g][c] = acc;
  __syncthreads();
  if (g == 0 && col < h) {
    float t = red[0][c];
#pragma unroll
    for (int q = 1; q < kColGroups; ++q) t += red[q][c];
    dw[col] = pt::from_f<T>(t);
  }
}

inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The instance a row takes: scalar unless the row is whole 16-byte vectors
// and every operand starts on a 16-byte boundary; then the fewest vectors
// per lane that hold it (at most 64 floats a lane), or the looping one.
template <typename T, bool RESIDUAL>
void fwd(const void* x, const void* res, const void* w, void* y, void* s,
         float* rstd, int n, int h, float eps, cudaStream_t st) {
  const unsigned grid = (unsigned)((n + kFwdWarps - 1) / kFwdWarps);
  constexpr int VEC = 16 / (int)sizeof(T);
  const bool vec = h % VEC == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(y) && (!RESIDUAL || (aligned16(res) &&
                                                  aligned16(s)));
  const int per_lane = (h / VEC + 31) / 32;
  using Fn = void (*)(const T*, const T*, const T*, T*, T*, float*, int, int,
                      float);
  Fn kernel = rmsnorm_fwd_vec_kernel<T, RESIDUAL, 0>;
  if (!vec)
    kernel = rmsnorm_fwd_scalar_kernel<T, RESIDUAL>;
  else if (per_lane <= 2)
    kernel = rmsnorm_fwd_vec_kernel<T, RESIDUAL, 2>;
  else if (per_lane <= 4)
    kernel = rmsnorm_fwd_vec_kernel<T, RESIDUAL, 4>;
  else if (per_lane <= 8)
    kernel = rmsnorm_fwd_vec_kernel<T, RESIDUAL, 8>;
  else if constexpr (sizeof(T) == 4) {
    if (per_lane <= 16) kernel = rmsnorm_fwd_vec_kernel<T, RESIDUAL, 16>;
  }
  kernel<<<grid, kFwdWarps * 32, 0, st>>>((const T*)x, (const T*)res,
                                          (const T*)w, (T*)y, (T*)s, rstd, n,
                                          h, eps);
}

// The scalar row kernel on `n_blocks` blocks (dw partial [h] in shared
// memory, opted in above 48 KB).
template <typename T, bool RESIDUAL>
cudaError_t bwd_rows_scalar(const T* s, const T* w, const float* rstd,
                            const T* dy, const T* dr, T* dx, float* dw_part,
                            int n, int h, int n_blocks, int rows_per_block,
                            cudaStream_t st) {
  const size_t smem = sizeof(float) * (h + kBwdThreads / 32);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T, RESIDUAL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  rmsnorm_bwd_kernel<T, RESIDUAL><<<n_blocks, kBwdThreads, smem, st>>>(
      s, w, rstd, dy, dr, dx, dw_part, n, h, rows_per_block);
  return cudaGetLastError();
}

template <typename T, bool RESIDUAL, int NV>
cudaError_t bwd_rows_vec(const T* s, const T* w, const float* rstd,
                         const T* dy, const T* dr, T* dx, float* dw_part,
                         int n, int h, int n_blocks, int rows_per_block,
                         cudaStream_t st) {
  static const cudaError_t opt = cudaFuncSetAttribute(
      rmsnorm_bwd_vec_kernel<T, RESIDUAL, NV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemMost);
  if (opt != cudaSuccess) return opt;
  rmsnorm_bwd_vec_kernel<T, RESIDUAL, NV>
      <<<n_blocks, kBwdWarps * 32, sizeof(float) * kBwdWarps * h, st>>>(
          s, w, rstd, dy, dr, dx, dw_part, n, h, rows_per_block);
  return cudaGetLastError();
}

// The instance a backward takes: a vector one for rows of whole 16-byte
// vectors on 16-byte boundaries up to kBwdWidest wide (the fewest vectors
// per lane that hold the row, up to 8, else the looping one), the scalar
// one otherwise; then the column sum, a programmatic dependent.
template <typename T, bool RESIDUAL>
int bwd(const void* s_, const void* w_, const float* rstd, const void* dy_,
        const void* dr_, void* dx_, void* dw, float* dw_part, int n, int h,
        int n_blocks, cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const T *s = (const T*)s_, *w = (const T*)w_, *dy = (const T*)dy_,
          *dr = (const T*)dr_;
  T* dx = (T*)dx_;
  const int rows = (n + n_blocks - 1) / n_blocks;
  const bool vec = h % VEC == 0 && h <= kBwdWidest && aligned16(s) &&
                   aligned16(w) && aligned16(dy) && aligned16(dx) &&
                   (!RESIDUAL || aligned16(dr));
  const int per_lane = (h / VEC + 31) / 32;
  cudaError_t e;
  if (!vec)
    e = bwd_rows_scalar<T, RESIDUAL>(s, w, rstd, dy, dr, dx, dw_part, n, h,
                                     n_blocks, rows, st);
  else if (per_lane <= 2)
    e = bwd_rows_vec<T, RESIDUAL, 2>(s, w, rstd, dy, dr, dx, dw_part, n, h,
                                     n_blocks, rows, st);
  else if (per_lane <= 4)
    e = bwd_rows_vec<T, RESIDUAL, 4>(s, w, rstd, dy, dr, dx, dw_part, n, h,
                                     n_blocks, rows, st);
  else if (per_lane <= 8)
    e = bwd_rows_vec<T, RESIDUAL, 8>(s, w, rstd, dy, dr, dx, dw_part, n, h,
                                     n_blocks, rows, st);
  else
    e = bwd_rows_vec<T, RESIDUAL, 0>(s, w, rstd, dy, dr, dx, dw_part, n, h,
                                     n_blocks, rows, st);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((h + 31) / 32));
  cfg.blockDim = dim3(32 * kColGroups);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* part = dw_part;
  return (int)cudaLaunchKernelEx(&cfg, rmsnorm_dw_cols_kernel<T>, part,
                                 (T*)dw, n_blocks, h);
}

template <typename T, bool RESIDUAL>
int bwd_earlier(const void* s, const void* w, const float* rstd,
                const void* dy, const void* dr, void* dx, void* dw,
                float* dw_part, int n, int h, int n_blocks, cudaStream_t st) {
  const cudaError_t e = bwd_rows_scalar<T, RESIDUAL>(
      (const T*)s, (const T*)w, rstd, (const T*)dy, (const T*)dr, (T*)dx,
      dw_part, n, h, n_blocks, (n + n_blocks - 1) / n_blocks, st);
  if (e != cudaSuccess) return (int)e;
  rmsnorm_dw_sum_kernel<T><<<(h + 255) / 256, 256, 0, st>>>(
      dw_part, (T*)dw, n_blocks, h);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, res, w, y, s share it). `res` and `s`
// are read/written only when `residual` is 1. Returns cudaGetLastError().
extern "C" int pt_rmsnorm_fwd(const void* x, const void* res, const void* w,
                              void* y, void* s, void* rstd, int n, int h,
                              float eps, int residual, int dtype,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) return (int)cudaGetLastError();
  float* r = (float*)rstd;
  if (dtype == 0) {
    if (residual) fwd<float, true>(x, res, w, y, s, r, n, h, eps, st);
    else fwd<float, false>(x, res, w, y, s, r, n, h, eps, st);
  } else {
    if (residual) fwd<__nv_bfloat16, true>(x, res, w, y, s, r, n, h, eps, st);
    else fwd<__nv_bfloat16, false>(x, res, w, y, s, r, n, h, eps, st);
  }
  return (int)cudaGetLastError();
}

// Launches the row kernel on `n_blocks` blocks (rows split evenly; fp32
// scratch dw_part [n_blocks, h] from the caller) and then the column sum
// into dw [h].
extern "C" int pt_rmsnorm_bwd(const void* s, const void* w, const void* rstd,
                              const void* dy, const void* dr, void* dx,
                              void* dw, void* dw_part, int n, int h,
                              int n_blocks, int residual, int dtype,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* r = (const float*)rstd;
  float* part = (float*)dw_part;
  if (dtype == 0)
    return residual
        ? bwd<float, true>(s, w, r, dy, dr, dx, dw, part, n, h, n_blocks, st)
        : bwd<float, false>(s, w, r, dy, dr, dx, dw, part, n, h, n_blocks, st);
  return residual
      ? bwd<__nv_bfloat16, true>(s, w, r, dy, dr, dx, dw, part, n, h,
                                 n_blocks, st)
      : bwd<__nv_bfloat16, false>(s, w, r, dy, dr, dx, dw, part, n, h,
                                  n_blocks, st);
}

// The earlier backward (the scalar row kernel, then a column sum of one
// thread per column), for timing beside the new one.
extern "C" int pt_rmsnorm_bwd_earlier(const void* s, const void* w,
                                      const void* rstd, const void* dy,
                                      const void* dr, void* dx, void* dw,
                                      void* dw_part, int n, int h,
                                      int n_blocks, int residual, int dtype,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* r = (const float*)rstd;
  float* part = (float*)dw_part;
  if (dtype == 0)
    return residual
        ? bwd_earlier<float, true>(s, w, r, dy, dr, dx, dw, part, n, h,
                                   n_blocks, st)
        : bwd_earlier<float, false>(s, w, r, dy, dr, dx, dw, part, n, h,
                                    n_blocks, st);
  return residual
      ? bwd_earlier<__nv_bfloat16, true>(s, w, r, dy, dr, dx, dw, part, n,
                                         h, n_blocks, st)
      : bwd_earlier<__nv_bfloat16, false>(s, w, r, dy, dr, dx, dw, part, n,
                                          h, n_blocks, st);
}

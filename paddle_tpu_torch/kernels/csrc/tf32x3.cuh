// Shared pieces of the fp32 attention kernels on the tensor cores
// (flash_fwd_tf32x3.cu, flash_bwd_dkv_tf32x3.cu, flash_bwd_dq_tf32x3.cu):
// the 3xTF32 split and product, cp.async staging, and the shared-memory row
// layout.
//
// 3xTF32. An fp32 operand x is split into hi = tf32(x), rounded to nearest
// with ties away (cvt.rna), and lo = tf32(x - hi); a product is then
// a_lo b_hi + a_hi b_lo + a_hi b_hi, three mma.sync m16n8k8 TF32 products
// accumulated in fp32 (CUTLASS's "3xTF32"). x - hi is exact and at most
// 2^-11 |x|; it goes to the tensor core as it is, which reads a TF32
// operand's top 19 bits, so lo's conversion is that truncation (CUTLASS's
// round-toward-zero for the small part) and costs no instruction. The
// dropped a_lo b_lo term and lo's truncation are at most ~2^-21 of the
// product, so sums keep fp32's accuracy to a few ulps where one TF32 pass
// keeps ~3 decimal digits (measured on the card: 5e-6 against 7e-4 for o
// at DiT's shape).
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, lane = 4 g + t:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n): b0 (t, g), b1 (t + 4, g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A C fragment feeds the next product as its A operand without a shuffle
// by renaming the contraction index: a0 = c0, a1 = c2, a2 = c1, a3 = c3
// takes k index t to column 2t and t + 4 to 2t + 1, so the B operand's
// rows are read at 2t and 2t + 1 instead of t and t + 4 (a sum does not
// depend on the order of its terms).
//
// Shared-memory rows are kStride(DN) floats, a multiple of 16 plus 4: the
// fragment reads at (row g, column t) and at (row 2t, column g) then fall
// on 32 different banks, and every row starts on a 16-byte boundary for
// cp.async.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr float kNeg = -1e30f;  // the masked logit of the reference kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;   // 4 warps

// floats a shared-memory row of a head dim of up to 8 * DN takes
__host__ __device__ constexpr int row_stride(int DN) {
  return (8 * DN + 15) / 16 * 16 + 4;
}

// the logit of a masked pair: exp2 of it is exactly 0
__device__ __forceinline__ float masked() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x by the hardware's approximation (MUFU.EX2, relative error ~2^-22,
// results below 2^-126 flushed to 0; exp2(-inf) = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An A fragment from its four fp32 values, split.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// A B fragment from its two fp32 values, split.
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// -- cp.async ------------------------------------------------------------------

// 16 bytes from global to shared memory; zeros where `valid` is false (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, likewise
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of a [n, d] fp32 matrix into R shared-memory rows of
// `stride` floats, by the block's threads; rows past n read as zeros.
template <int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int n, int d, int stride) {
  const int chunks = d >> 2;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < R * chunks; c += kThreads) {
    const int r = c / chunks, x = (c - r * chunks) << 2;
    const bool ok = r0 + r < n;
    cp16(dst + r * stride + x, ok ? src + (size_t)(r0 + r) * d + x : src,
         ok);
  }
}

// The bucket of head dims a kernel instance serves: DN 8-wide chunks,
// with the head dim's own count d / 8 <= DN checked inside.
inline int dn_bucket(int hd) {
  const int n = hd / 8;
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : n <= 9 ? 9 : n <= 12 ? 12
                                                                      : 16;
}

}  // namespace tf32x3

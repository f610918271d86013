// Shared pieces of the two split-K decode kernels (paged_attention_decode.cu,
// flash_decode.cu): 16 bytes of a row unpacked to fp32, and the fixed-order
// merge of a row's split partials.
//
// A split's partial is (o, m, l) in fp32 with m in log2 units: o = sum of
// exp2(s - m) * v over the split's keys (not normalised), m = the largest
// score s = q.k * scale * log2(e), l = sum of exp2(s - m). A split that owns
// no key has m = -1e30 and l = 0. The merge takes the splits in index order,
// with no atomics, so a result repeats bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace pt {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 16 bytes of T as floats (16 / sizeof(T) of them)
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& r, float* f) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& r,
                                                        float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// M = the largest m over a row's n_split partials (ml[i] = (m_i, l_i)).
__device__ __forceinline__ float splits_max(const float2* ml, int n_split) {
  float M = kNeg;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, ml[i].x);
  return M;
}

// Dim d of a row's merge, over the splits in order: returns A = sum o_i[d]
// exp2(m_i - M) and sets *L = sum l_i exp2(m_i - M). `po` is the row's
// [n_split][hd] partial o.
__device__ __forceinline__ float splits_sum(const float2* ml, const float* po,
                                            int n_split, int hd, int d,
                                            float M, float* L) {
  float l = 0.f, A = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float c = exp2f(ml[i].x - M);
    l = fmaf(ml[i].y, c, l);
    A = fmaf(po[(size_t)i * hd + d], c, A);
  }
  *L = l;
  return A;
}

}  // namespace pt

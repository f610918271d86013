// 16-byte vector loads and stores, converted to and from fp32, for the MoE
// kernels (grouped_matmul.cu, moe_dispatch.cu) and RMSNorm (rmsnorm.cu).
// One vector holds 8 bf16 or 4 fp32 values; the pointer must be 16-byte
// aligned, which the callers check (the MoE wrappers pass row widths that
// are multiples of 8 elements; RMSNorm takes its scalar kernels for
// anything else).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

template <typename T>
struct Vec16 {
  static constexpr int N = 16 / (int)sizeof(T);

  __device__ __forceinline__ static void load(const T* p, float* out);
  __device__ __forceinline__ static void store(T* p, const float* in);
  // a vector already loaded (raw bits) to N floats
  __device__ __forceinline__ static void unpack(uint4 raw, float* out);
};

template <>
__device__ __forceinline__ void Vec16<float>::unpack(uint4 raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void Vec16<__nv_bfloat16>::unpack(uint4 raw,
                                                            float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void Vec16<float>::load(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

template <>
__device__ __forceinline__ void Vec16<float>::store(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

template <>
__device__ __forceinline__ void Vec16<__nv_bfloat16>::load(
    const __nv_bfloat16* p, float* out) {
  unpack(*reinterpret_cast<const uint4*>(p), out);
}

template <>
__device__ __forceinline__ void Vec16<__nv_bfloat16>::store(
    __nv_bfloat16* p, const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

}  // namespace pt

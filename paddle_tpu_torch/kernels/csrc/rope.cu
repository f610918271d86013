// Rotate-half rotary position embedding (RoPE) for Hopper (sm_90a), and its
// inverse, which is its VJP.
//
// Replaces the TPU kernel `_rope_kernel` (paddle_tpu/kernels/pallas/rope.py:50),
// launched by `_rope_pallas` (:63, call :66). Same function on x [b, s, h, d],
// d even, with half = d / 2:
//   out[..., i]        = x1 * cos(f) - x2 * sin(f)
//   out[..., half + i] = x2 * cos(f) + x1 * sin(f)
// where x1 = x[..., i], x2 = x[..., half + i], f = (pos_offset + s) * inv_i
// and inv_i = exp(i * (-2/d) * ln(theta)), computed in fp32 in the kernel as
// `_angles` (:38-47) does: no cos/sin tables in device memory. `inverse`
// negates sin: a rotation is orthogonal, so the VJP applies the inverse
// rotation to the cotangent and saves nothing (`_rope4_bwd`, :108).
//
// Angles use the precise sincosf (this library is built without
// --use_fast_math): at position 2047 the argument is about 2000 rad, where
// the fast intrinsics lose the angle.
//
// What bounds it on the H100: bytes (one read and one write of x, a few
// dozen FLOPs per element pair, well under the tensor-core ratio of ~295
// FLOPs per byte, and the sincosf work runs on the CUDA cores beside the
// memory traffic).
//
// What the design does about it: one thread per (row, i) pair, neighbouring
// threads on neighbouring i, so both halves of a row are read and written as
// coalesced runs; a grid-stride loop over all pairs.

#include "attention_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
rope_kernel(const T* __restrict__ x, T* __restrict__ out, long long n_pairs,
            int S, int H, int half, float neg2_over_d, float ln_theta,
            int pos_offset, float sin_sign) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_pairs; t += stride) {
    const int i = (int)(t % half);
    const long long row = t / half;  // (b * S + s) * H + head
    const int s = (int)((row / H) % S);
    const float inv = expf((float)i * neg2_over_d * ln_theta);
    const float f = (float)(pos_offset + s) * inv;
    float sn, cs;
    sincosf(f, &sn, &cs);
    sn *= sin_sign;
    const size_t base = (size_t)row * (2 * half);
    const float x1 = pt::to_f(x[base + i]);
    const float x2 = pt::to_f(x[base + half + i]);
    out[base + i] = pt::from_f<T>(x1 * cs - x2 * sn);
    out[base + half + i] = pt::from_f<T>(x2 * cs + x1 * sn);
  }
}

template <typename T>
void launch(const void* x, void* out, int b, int S, int H, int d,
            float theta_ln, int pos_offset, int inverse, cudaStream_t st) {
  const int half = d / 2;
  const long long n_pairs = (long long)b * S * H * half;
  const long long want = (n_pairs + 255) / 256;
  const unsigned grid = (unsigned)(want < 132 * 32 ? want : 132 * 32);
  rope_kernel<T><<<grid, 256, 0, st>>>(
      (const T*)x, (T*)out, n_pairs, S, H, half, -2.0f / (float)d, theta_ln,
      pos_offset, inverse ? -1.f : 1.f);
}

}  // namespace

// x, out: [b, S, H, d] contiguous, d even. ln_theta = ln(theta) in fp32.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int pt_rope(const void* x, void* out, int b, int S, int H, int d,
                       float ln_theta, int pos_offset, int inverse, int dtype,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)b * S * H * d == 0) return (int)cudaGetLastError();
  if (dtype == 0)
    launch<float>(x, out, b, S, H, d, ln_theta, pos_offset, inverse, st);
  else
    launch<__nv_bfloat16>(x, out, b, S, H, d, ln_theta, pos_offset, inverse,
                          st);
  return (int)cudaGetLastError();
}

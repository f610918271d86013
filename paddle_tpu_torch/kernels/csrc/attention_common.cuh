// Shared pieces of the attention kernels (paged_attention.cu,
// flash_attention.cu, flash_attention_bwd.cu): type conversion, warp sums,
// the per-warp online-softmax state and the cross-warp merge. rmsnorm.cu and
// rope.cu use the conversions and warp sums.
//
// Work split used by both kernels: a block owns R query rows of one
// (sequence, head) group. Its NW warps split the KEYS between them, each warp
// keeping its own online-softmax state for all R rows. Inside a warp, lane l
// owns head dims [l*DPL, l*DPL + DPL): a key row (hd elements) is read by the
// warp as one contiguous, coalesced run; the score q.k is a warp sum. At the
// end the NW partial states are merged through shared memory (the
// log-sum-exp merge of split-K "flash decoding").
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

constexpr float kNeg = -1e30f;  // the masked logit of the reference kernels
constexpr int kWarps = 4;       // warps per block (128 threads)

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Online-softmax state of R query rows in one warp. Row r's key limit is
// `lim[r]`: key j is visible iff j <= lim[r] (lim = -1 marks a padding row).
template <int R, int DPL>
struct WarpRows {
  float q[R][DPL];
  float acc[R][DPL];
  float m[R];
  float l[R];
  int lim[R];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = kNeg;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
    }
  }

  template <typename T>
  __device__ __forceinline__ void load_q(int r, const T* qp, int lane, int hd) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane * DPL + i;
      q[r][i] = d < hd ? to_f(qp[d]) : 0.f;
    }
  }

  // Fold key j (rows kp, vp of hd elements) into every row that sees it.
  // Masked keys contribute exactly 0, as in the TPU kernels.
  template <typename T>
  __device__ __forceinline__ void fold(const T* kp, const T* vp, int j,
                                       int lane, int hd, float scale) {
    float kv[DPL], vv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane * DPL + i;
      kv[i] = d < hd ? to_f(kp[d]) : 0.f;
      vv[i] = d < hd ? to_f(vp[d]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s = fmaf(q[r][i], kv[i], s);
      s = warp_sum(s) * scale;
      if (j <= lim[r]) {
        const float m_new = fmaxf(m[r], s);
        const float alpha = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i] * alpha);
        m[r] = m_new;
      }
    }
  }

  // Park this warp's partial state in shared memory:
  // sm layout [kWarps][R][hd + 2] floats (acc..., m, l).
  __device__ __forceinline__ void park(float* sm, int warp, int lane, int hd) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* row = sm + ((size_t)warp * R + r) * (hd + 2);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane * DPL + i;
        if (d < hd) row[d] = acc[r][i];
      }
      if (lane == 0) {
        row[hd] = m[r];
        row[hd + 1] = l[r];
      }
    }
  }
};

// Merge the kWarps partial states of row r, dim d (after __syncthreads()).
// Returns the normalised output; *lse_out receives the row's log-sum-exp.
// A row that saw no key (l == 0) gives 0, as the TPU kernels do.
template <int R>
__device__ __forceinline__ float merge(const float* sm, int r, int d, int hd,
                                       float* lse_out) {
  float M = kNeg;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    M = fmaxf(M, sm[((size_t)w * R + r) * (hd + 2) + hd]);
  float L = 0.f, A = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float* row = sm + ((size_t)w * R + r) * (hd + 2);
    const float c = expf(row[hd] - M);
    L = fmaf(row[hd + 1], c, L);
    A = fmaf(row[d], c, A);
  }
  L = fmaxf(L, 1e-30f);
  if (lse_out) *lse_out = M + logf(L);
  return A / L;
}

inline int dims_per_lane(int hd) {
  return hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 128 ? 4 : 8;
}

}  // namespace pt

// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ from the saved
// per-row log-sum-exp.
//
// Replaces the two TPU kernels launched by `_flash_bwd`
// (paddle_tpu/kernels/flash_attention.py:253): `_bwd_dkv_kernel` (:154, call
// :268) and `_bwd_dq_kernel` (:206, call :296). Same functions, on
// q, dO [bh, sq, d] and k, v [bh, sk, d], with lse and
// delta = rowsum(dO * O) - dlse [bh, sq] in fp32 (computed by the caller,
// :262-264). Under `causal`, query row i sees key j iff j <= i + offset.
// For every visible pair (i, j):
//   p_ij  = exp(scale * q_i.k_j - lse_i)            (0 where masked, :182)
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i) * scale
//   dV_j += p_ij dO_i,  dK_j += ds_ij q_i,  dQ_i += ds_ij k_j.
// A row that sees no key (lse = -1e30) adds exactly 0: p is selected to 0
// before it is used, so no inf or NaN is formed. All arithmetic is fp32
// (the TPU kernel casts dO and v to f32, :172, :186); outputs are written in
// the inputs' type.
//
// What bounds it on the H100: operations. dK/dV does 8*d FLOPs per visible
// pair and dQ 6*d (it recomputes s and dp), hundreds of FLOPs per byte of
// q/k/v/dO at causal 2048, d 128.
//
// What the design does about it, simple first (the CUDA cores, not the
// tensor cores, as in the forward kernel flash_attention.cu): lanes own head
// dims (DPL per lane), so every row read is one coalesced run and each dot
// product is a warp sum.
//  - dK/dV: one block per (bh, tile of R key rows); the R keys' k, v and
//    fp32 dk, dv accumulators live in registers of each of the 4 warps,
//    which split the query rows that can see the tile between them (rows
//    from max(0, j_start - offset), the counterpart of the TPU kernel's
//    skip at :193-195); the warps' partial dk and dv are summed through
//    shared memory at the end.
//  - dQ: mirrors the forward: one block per (bh, tile of R query rows); the
//    4 warps split the keys up to the tile's last diagonal in chunks and
//    the partial dq rows are summed through shared memory.
// The TPU kernels carry their accumulators across a sequential grid axis;
// here that axis is the loop inside the block. Ragged sq / sk are masked.

#include "attention_common.cuh"

namespace {

constexpr int kChunk = 16;  // keys per warp turn in the dQ kernel

template <typename T, int DPL>
__device__ __forceinline__ void load_row(float (&dst)[DPL], const T* p,
                                         int lane, int hd) {
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane * DPL + i;
    dst[i] = d < hd ? pt::to_f(p[d]) : 0.f;
  }
}

// Sum the kWarps partial rows parked in sm [kWarps][R][hd] and write them.
template <typename T, int R>
__device__ __forceinline__ void sum_and_store(const float* sm, T* dst,
                                              int first_row, int n_rows,
                                              int hd) {
  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd;
    if (first_row + r >= n_rows) continue;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < pt::kWarps; ++w) acc += sm[((size_t)w * R + r) * hd + d];
    dst[(size_t)(first_row + r) * hd + d] = pt::from_f<T>(acc);
  }
}

template <int R, int DPL>
__device__ __forceinline__ void park(float* sm, const float (&acc)[R][DPL],
                                     int warp, int lane, int hd) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane * DPL + i;
      if (d < hd) sm[((size_t)warp * R + r) * hd + d] = acc[r][i];
    }
  }
}

template <typename T, int R, int DPL>
__global__ void __launch_bounds__(pt::kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int hd, int offset,
                     int causal, int n_tiles, float scale) {
  extern __shared__ float sm[];  // [kWarps][R][hd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x % n_tiles;
  const size_t b = blockIdx.x / n_tiles;
  const int j0 = tile * R;

  float kr[R][DPL], vr[R][DPL], dka[R][DPL], dva[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
    const size_t off = (b * sk + (j < sk ? j : 0)) * hd;
    load_row<T, DPL>(kr[r], k + off, lane, j < sk ? hd : 0);
    load_row<T, DPL>(vr[r], v + off, lane, j < sk ? hd : 0);
#pragma unroll
    for (int i = 0; i < DPL; ++i) dka[r][i] = dva[r][i] = 0.f;
  }
  // the first query row that can see key j0 (earlier rows see none of the
  // tile's keys); offset may be negative
  const int i_begin = causal ? max(0, j0 - offset) : 0;
  for (int i = i_begin + warp; i < sq; i += pt::kWarps) {
    float qv[DPL], dov[DPL];
    const size_t row = (b * sq + i) * hd;
    load_row<T, DPL>(qv, q + row, lane, hd);
    load_row<T, DPL>(dov, dout + row, lane, hd);
    const float l = lse[b * sq + i], dl = delta[b * sq + i];
    const int lim = causal ? i + offset : sk - 1;  // keys j <= lim visible
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        s = fmaf(qv[e], kr[r][e], s);
        dp = fmaf(dov[e], vr[r][e], dp);
      }
      s = pt::warp_sum(s) * scale;
      dp = pt::warp_sum(dp);
      const int j = j0 + r;
      const float p = (j < sk && j <= lim) ? expf(s - l) : 0.f;
      const float ds = p * (dp - dl) * scale;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        dva[r][e] = fmaf(p, dov[e], dva[r][e]);
        dka[r][e] = fmaf(ds, qv[e], dka[r][e]);
      }
    }
  }
  // one [kWarps][R][hd] buffer in turn for dk and dv
  park<R, DPL>(sm, dka, warp, lane, hd);
  __syncthreads();
  sum_and_store<T, R>(sm, dk + b * sk * hd, j0, sk, hd);
  __syncthreads();
  park<R, DPL>(sm, dva, warp, lane, hd);
  __syncthreads();
  sum_and_store<T, R>(sm, dv + b * sk * hd, j0, sk, hd);
}

template <typename T, int R, int DPL>
__global__ void __launch_bounds__(pt::kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int hd, int offset, int causal,
                    int n_tiles, float scale) {
  extern __shared__ float sm[];  // [kWarps][R][hd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x % n_tiles;
  const size_t b = blockIdx.x / n_tiles;
  const int i0 = tile * R;

  float qv[R][DPL], dov[R][DPL], dqa[R][DPL], l[R], dl[R];
  int lim[R];
  int lim_max = -1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    const bool ok = i < sq;
    const size_t row = (b * sq + (ok ? i : 0)) * hd;
    load_row<T, DPL>(qv[r], q + row, lane, ok ? hd : 0);
    load_row<T, DPL>(dov[r], dout + row, lane, ok ? hd : 0);
    l[r] = ok ? lse[b * sq + i] : 0.f;
    dl[r] = ok ? delta[b * sq + i] : 0.f;
    lim[r] = !ok ? -1 : causal ? min(i + offset, sk - 1) : sk - 1;
    lim_max = max(lim_max, lim[r]);
#pragma unroll
    for (int e = 0; e < DPL; ++e) dqa[r][e] = 0.f;
  }
  const T* kb = k + b * sk * hd;
  const T* vb = v + b * sk * hd;
  const int kend = lim_max + 1;  // keys [0, kend) can be visible to the tile
  for (int c = warp * kChunk; c < kend; c += pt::kWarps * kChunk) {
    const int cend = min(c + kChunk, kend);
    for (int j = c; j < cend; ++j) {
      float kv[DPL], vv[DPL];
      load_row<T, DPL>(kv, kb + (size_t)j * hd, lane, hd);
      load_row<T, DPL>(vv, vb + (size_t)j * hd, lane, hd);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          s = fmaf(qv[r][e], kv[e], s);
          dp = fmaf(dov[r][e], vv[e], dp);
        }
        s = pt::warp_sum(s) * scale;
        dp = pt::warp_sum(dp);
        const float p = j <= lim[r] ? expf(s - l[r]) : 0.f;
        const float ds = p * (dp - dl[r]) * scale;
#pragma unroll
        for (int e = 0; e < DPL; ++e) dqa[r][e] = fmaf(ds, kv[e], dqa[r][e]);
      }
    }
  }
  park<R, DPL>(sm, dqa, warp, lane, hd);
  __syncthreads();
  sum_and_store<T, R>(sm, dq + b * sq * hd, i0, sq, hd);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *d0, *d1;  // dkv: dk, dv; dq: dq
  int bh, sq, sk, hd, offset, causal;
  float scale;
};

template <typename T, int DPL>
void launch_dkv(const Args& a, cudaStream_t st) {
  constexpr int R = DPL <= 4 ? 8 : 4;  // four [R][DPL] register tiles
  const int n_tiles = (a.sk + R - 1) / R;
  const dim3 grid((unsigned)((size_t)a.bh * n_tiles));
  const size_t smem = sizeof(float) * pt::kWarps * R * a.hd;
  flash_bwd_dkv_kernel<T, R, DPL><<<grid, pt::kWarps * 32, smem, st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.d0, (T*)a.d1, a.sq, a.sk, a.hd, a.offset, a.causal,
      n_tiles, a.scale);
}

template <typename T, int DPL>
void launch_dq(const Args& a, cudaStream_t st) {
  constexpr int R = DPL <= 4 ? 8 : 4;
  const int n_tiles = (a.sq + R - 1) / R;
  const dim3 grid((unsigned)((size_t)a.bh * n_tiles));
  const size_t smem = sizeof(float) * pt::kWarps * R * a.hd;
  flash_bwd_dq_kernel<T, R, DPL><<<grid, pt::kWarps * 32, smem, st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.d0, a.sq, a.sk, a.hd, a.offset, a.causal, n_tiles,
      a.scale);
}

template <typename T, bool DKV, int DPL>
void launch(const Args& a, cudaStream_t st) {
  if constexpr (DKV)
    launch_dkv<T, DPL>(a, st);
  else
    launch_dq<T, DPL>(a, st);
}

template <typename T, bool DKV>
void by_dpl(const Args& a, cudaStream_t st) {
  switch (pt::dims_per_lane(a.hd)) {
    case 1: launch<T, DKV, 1>(a, st); break;
    case 2: launch<T, DKV, 2>(a, st); break;
    case 4: launch<T, DKV, 4>(a, st); break;
    default: launch<T, DKV, 8>(a, st); break;
  }
}

template <bool DKV>
int run(const Args& a, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((DKV ? a.sk : a.sq) == 0 || a.bh == 0) return (int)cudaGetLastError();
  if (dtype == 0)
    by_dpl<float, DKV>(a, st);
  else
    by_dpl<__nv_bfloat16, DKV>(a, st);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout [bh, sq, hd]; k, v, dk, dv [bh, sk, hd]; lse, delta [bh, sq] fp32.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
    int sk, int hd, int offset, int causal, float scale, int dtype,
    void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv,
               bh, sq, sk, hd, offset, causal, scale};
  return run<true>(a, dtype, stream);
}

// dq [bh, sq, hd]; the rest as for pt_flash_attention_bwd_dkv.
extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
    int hd, int offset, int causal, float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)delta, dq,
               nullptr, bh, sq, sk, hd, offset, causal, scale};
  return run<false>(a, dtype, stream);
}

// Flash-attention forward for Hopper (sm_90a), with per-row log-sum-exp.
//
// Replaces the TPU kernel `_fwd_kernel`, launched by `_flash_fwd`, in
// paddle_tpu/kernels/flash_attention.py. Same function: q [bh,sq,d] against
// k, v [bh,sk,d]; under `causal` query row i sees key j iff j <= i + offset
// (offset shifts q's global positions: sk - sq for bottom-right aligned
// self-attention, a chunk start for ring attention). Returns o [bh,sq,d] in
// q's type and lse [bh,sq] fp32. A row that sees no key gives o = 0 (the TPU
// kernel zeroes masked probabilities explicitly rather than averaging V).
//
// What bounds it on the H100: operations at the prefill shapes (causal
// sq = sk = 2048, d = 128 is ~2*d FLOPs per visible (row, key) pair,
// hundreds of FLOPs per byte of q/k/v/o), bytes at decode (sq = 1: each
// K/V byte is used once).
//
// What the design does about it, simple first: one block per (bh, tile of R
// query rows); its 4 warps split the keys in chunks of 16, each warp keeping
// fp32 running max, sum and output for all R rows in registers, lanes
// owning head dims so a key row is one coalesced read that all R rows
// reuse; the partial states merge through shared memory (log-sum-exp merge).
// Under causal a block reads keys only up to its last row's diagonal, the
// counterpart of the TPU kernel skipping k-blocks above the offset diagonal.
// Ragged sq / sk are masked, so any length works; the TPU kernel's
// block-divisibility rule (`_pick_block`) is a TPU tile rule and is dropped.
// The products run on the CUDA cores, not the tensor cores: wgmma, TMA and
// warp specialisation are later work, and this kernel's time against its
// operations bound says how much they are worth.

#include "attention_common.cuh"

namespace {

constexpr int kChunk = 16;  // keys per warp turn

template <typename T, int R, int DPL>
__global__ void __launch_bounds__(pt::kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int hd, int offset,
                 int causal, int n_tiles, float scale) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x % n_tiles;
  const size_t b = blockIdx.x / n_tiles;
  const T* kb = k + b * sk * hd;
  const T* vb = v + b * sk * hd;

  pt::WarpRows<R, DPL> st;
  st.init();
  int lim_max = -1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tile * R + r;
    if (i < sq) {
      st.lim[r] = causal ? min(i + offset, sk - 1) : sk - 1;
      st.load_q(r, q + (b * sq + i) * hd, lane, hd);
    } else {
      st.lim[r] = -1;
      st.load_q(r, q, lane, 0);
    }
    lim_max = max(lim_max, st.lim[r]);
  }
  const int kend = lim_max + 1;  // keys [0, kend) can be visible to the tile
  for (int c = warp * kChunk; c < kend; c += pt::kWarps * kChunk) {
    const int cend = min(c + kChunk, kend);
    for (int j = c; j < cend; ++j)
      st.fold(kb + (size_t)j * hd, vb + (size_t)j * hd, j, lane, hd, scale);
  }
  st.park(sm, warp, lane, hd);
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd;
    const int i = tile * R + r;
    if (i >= sq) continue;
    float row_lse;
    o[(b * sq + i) * hd + d] = pt::from_f<T>(pt::merge<R>(sm, r, d, hd, &row_lse));
    if (d == 0) lse[b * sq + i] = row_lse;
  }
}

template <typename T, int R, int DPL>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            int bh, int sq, int sk, int hd, int offset, int causal,
            float scale, cudaStream_t stream) {
  const int n_tiles = (sq + R - 1) / R;
  const dim3 grid((unsigned)((size_t)bh * n_tiles));
  const size_t smem = sizeof(float) * pt::kWarps * R * (hd + 2);
  flash_fwd_kernel<T, R, DPL><<<grid, pt::kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, sq, sk, hd, offset,
      causal, n_tiles, scale);
}

template <typename T, int R>
void by_dpl(const void* q, const void* k, const void* v, void* o, float* lse,
            int bh, int sq, int sk, int hd, int offset, int causal,
            float scale, cudaStream_t st) {
  switch (pt::dims_per_lane(hd)) {
    case 1: launch<T, R, 1>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st); break;
    case 2: launch<T, R, 2>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st); break;
    case 4: launch<T, R, 4>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st); break;
    default: launch<T, R, 8>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st); break;
  }
}

template <typename T>
void by_rows(const void* q, const void* k, const void* v, void* o, float* lse,
             int bh, int sq, int sk, int hd, int offset, int causal,
             float scale, cudaStream_t st) {
  if (sq == 1)
    by_dpl<T, 1>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st);
  else
    by_dpl<T, 8>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int bh, int sq, int sk, int hd,
                                      int offset, int causal, float scale,
                                      int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bh * sq == 0) return (int)cudaGetLastError();
  if (dtype == 0)
    by_rows<float>(q, k, v, o, (float*)lse, bh, sq, sk, hd, offset, causal,
                   scale, st);
  else
    by_rows<__nv_bfloat16>(q, k, v, o, (float*)lse, bh, sq, sk, hd, offset,
                           causal, scale, st);
  return (int)cudaGetLastError();
}

// The message of a code returned by any entry point of the library
// (read by kernels/_build.py:check).
extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

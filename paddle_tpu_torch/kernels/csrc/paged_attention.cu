// Paged attention for Hopper (sm_90a): window queries against a page pool.
//
// Replaces the TPU kernel `_paged_kernel`, launched by `_paged_pallas`, in
// paddle_tpu/kernels/pallas/paged_attention.py. Same function: q [S,W,nh,hd]
// attends to arenas [P,PL,kvh,hd] through the page table tables [S,B]; key j
// is visible to window token (s,w) iff j <= pos[s,w]; GQA when kvh < nh.
// Output [S,W,nh,hd] in q's type; all softmax arithmetic in fp32.
//
// What bounds it on the H100: bytes. At decode (W = 1) every visible K/V
// byte is read once and used for one query row (~1 FLOP per byte), far
// below the ~295 FLOP/byte where bf16 tensor cores would become the limit,
// so the floor is visible K/V bytes / 3.35 TB/s.
//
// What the design does about it: the TPU kernel walks a sequential (slot,
// page) grid and carries fp32 accumulators in VMEM across the page axis.
// Hopper blocks run in parallel and carry nothing between them, so the page
// loop moves inside the block: one block per (slot, kv-head, tile of R of
// the W*rep query rows); its 4 warps split the slot's pages between them and
// each reads its own page ids from `tables`, so the dense gathered context
// never exists; a warp reads a key row as one coalesced run (lane = head
// dims) and keeps running max, sum and output in fp32 registers; the four
// partial states merge through shared memory at the end. The block stops
// after the last page any of its rows can see (max pos // PL): masked keys
// contribute exactly 0, so pages past it need not be read.
// Simple first: no TMA, no wgmma, no split across blocks.

#include "attention_common.cuh"

namespace {

template <typename T, int R, int DPL>
__global__ void __launch_bounds__(pt::kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ tables,
                       const int* __restrict__ pos, T* __restrict__ out,
                       int W, int nh, int kvh, int hd, int PL, int B,
                       int n_tiles, float scale) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x % n_tiles;
  const int sg = blockIdx.x / n_tiles;
  const int g = sg % kvh, s = sg / kvh;
  const int rep = nh / kvh, rows = W * rep;

  pt::WarpRows<R, DPL> st;
  st.init();
  int lim_max = -1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rr = tile * R + r;
    if (rr < rows) {
      const int w = rr / rep, h = g * rep + rr % rep;
      st.lim[r] = pos[s * W + w];
      st.load_q(r, q + (((size_t)s * W + w) * nh + h) * hd, lane, hd);
    } else {
      st.lim[r] = -1;
      st.load_q(r, q, lane, 0);
    }
    lim_max = max(lim_max, st.lim[r]);
  }
  const int n_pages = lim_max < 0 ? 0 : min(B, lim_max / PL + 1);
  for (int p = warp; p < n_pages; p += pt::kWarps) {
    const size_t page = (size_t)tables[(size_t)s * B + p];
    for (int jj = 0; jj < PL; ++jj) {
      const size_t off = ((page * PL + jj) * kvh + g) * hd;
      st.fold(k + off, v + off, p * PL + jj, lane, hd, scale);
    }
  }
  st.park(sm, warp, lane, hd);
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd;
    const int rr = tile * R + r;
    if (rr >= rows) continue;
    const int w = rr / rep, h = g * rep + rr % rep;
    out[(((size_t)s * W + w) * nh + h) * hd + d] =
        pt::from_f<T>(pt::merge<R>(sm, r, d, hd, nullptr));
  }
}

template <typename T, int R, int DPL>
void launch(const void* q, const void* k, const void* v, const int* tables,
            const int* pos, void* out, int S, int W, int nh, int kvh, int hd,
            int PL, int B, float scale, cudaStream_t stream) {
  const int rows = W * (nh / kvh);
  const int n_tiles = (rows + R - 1) / R;
  const dim3 grid((unsigned)(S * kvh * n_tiles));
  const size_t smem = sizeof(float) * pt::kWarps * R * (hd + 2);
  paged_attention_kernel<T, R, DPL><<<grid, pt::kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, tables, pos, (T*)out, W, nh, kvh,
      hd, PL, B, n_tiles, scale);
}

template <typename T, int R>
void by_dpl(int dpl, const void* q, const void* k, const void* v,
            const int* tables, const int* pos, void* out, int S, int W, int nh,
            int kvh, int hd, int PL, int B, float scale, cudaStream_t st) {
  switch (dpl) {
    case 1: launch<T, R, 1>(q, k, v, tables, pos, out, S, W, nh, kvh, hd, PL, B, scale, st); break;
    case 2: launch<T, R, 2>(q, k, v, tables, pos, out, S, W, nh, kvh, hd, PL, B, scale, st); break;
    case 4: launch<T, R, 4>(q, k, v, tables, pos, out, S, W, nh, kvh, hd, PL, B, scale, st); break;
    default: launch<T, R, 8>(q, k, v, tables, pos, out, S, W, nh, kvh, hd, PL, B, scale, st); break;
  }
}

template <typename T>
void by_rows(const void* q, const void* k, const void* v, const int* tables,
             const int* pos, void* out, int S, int W, int nh, int kvh, int hd,
             int PL, int B, float scale, cudaStream_t st) {
  const int rows = W * (nh / kvh), dpl = pt::dims_per_lane(hd);
  if (rows == 1)
    by_dpl<T, 1>(dpl, q, k, v, tables, pos, out, S, W, nh, kvh, hd, PL, B, scale, st);
  else if (rows <= 4)
    by_dpl<T, 4>(dpl, q, k, v, tables, pos, out, S, W, nh, kvh, hd, PL, B, scale, st);
  else
    by_dpl<T, 8>(dpl, q, k, v, tables, pos, out, S, W, nh, kvh, hd, PL, B, scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int pt_paged_attention(const void* q, const void* k, const void* v,
                                  const void* tables, const void* pos,
                                  void* out, int S, int W, int nh, int kvh,
                                  int hd, int PL, int B, float scale,
                                  int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S * W == 0) return (int)cudaGetLastError();
  if (dtype == 0)
    by_rows<float>(q, k, v, (const int*)tables, (const int*)pos, out, S, W,
                   nh, kvh, hd, PL, B, scale, st);
  else
    by_rows<__nv_bfloat16>(q, k, v, (const int*)tables, (const int*)pos, out,
                           S, W, nh, kvh, hd, PL, B, scale, st);
  return (int)cudaGetLastError();
}

// Flash-attention backward dK/dV in fp32 on Hopper's tensor cores
// (3xTF32), from the saved per-row log-sum-exp.
//
// Replaces the TPU kernel `_bwd_dkv_kernel`, launched by `_flash_bwd`, in
// paddle_tpu/kernels/flash_attention.py (:154, call :268) for fp32 at a head
// dim d that is a multiple of 8 up to 128. Same function as the dK/dV
// kernel of flash_attention_bwd.cu: q, dO [bh, sq, d], k, v [bh, sk, d],
// lse and delta = rowsum(dO * O) - dlse [bh, sq] fp32; under `causal` query
// row i sees key j iff j <= i + offset; for every visible pair
//   p = exp(scale q.k - lse), dp = dO.v, ds = p (dp - delta) scale,
//   dV_j += p dO_i, dK_j += ds q_i,
// and a masked pair adds exactly 0 (p is selected to 0, so a row that sees
// no key, lse = -1e30, forms no inf).
//
// What bounds it on the H100: operations (8 d FLOPs a visible pair: four
// products). fp32 on the CUDA cores peaks at 67 TFLOP/s; the three TF32
// products of each (tf32x3.cuh) at ~165 effective.
//
// What the design does about it: one block per (bh, tile of 64 keys; 128
// at d 72), 4 warps of 16 keys (32) each; the tile's K and V stay in shared
// memory and each warp's dK and dV stay in registers. The block walks the
// query tiles of 16 rows that can see its keys, from row max(0, j0 -
// offset) (the TPU kernel's skip at :193-195), Q, dO, lse and delta
// double-buffered by cp.async. Each warp computes the transposed scores
// S^T = K Q^T and dP^T = V dO^T (mma.sync m16n8k8), then P^T and dS^T on
// the lanes that own them (the hardware exp2 of the prescaled logit), and
// takes them as the A operands of dV += P^T dO and dK += dS^T Q straight
// from its registers (tf32x3.cuh's renaming): computing the transposes
// keeps P^T and dS^T out of shared memory. Each tile's contribution is
// summed from zero in the tensor cores and added to the running dK and dV
// by fp32 adds (at 4096 rows, d 128, a running sum in the tensor cores
// erred by 1.4e-4 in dK and 2.3e-4 in dV; this way by 1.4e-5). Ragged sq
// and sk read as zeros and are masked. No atomics: every sum runs in a
// fixed order, so two launches agree bit for bit. See DkvShape for the
// tiles. dQ is flash_bwd_dq_tf32x3.cu's.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

// The tile shape of a head-dim bucket: MT m-tiles of 16 keys a warp (4 MT
// 16 keys a block) and QR query rows a Q / dO tile. At d 72 two m-tiles
// (128 keys a block) let every Q and dO fragment, split once, serve two
// products, and dK and dV (144 registers) still fit without spills; at d 96
// and 128 they would spill, and at d 64 BERT's 128 keys would give half
// the blocks. Chosen on the card from MT 1-2 x QR 8-64.
template <int DN>
struct DkvShape {
  static constexpr int MT = DN == 9 ? 2 : 1;
  static constexpr int QR = 16;
};

template <int DN>
struct DkvLayout {
  static constexpr int MT = DkvShape<DN>::MT, QR = DkvShape<DN>::QR;
  static constexpr int kKeys = 64 * MT;  // keys a block
  static constexpr int kStride = row_stride(DN);
  static constexpr int kKv = kKeys * kStride;  // floats of the K or V tile
  static constexpr int kQ = QR * kStride;      // of a Q or dO tile
  // K, V, Q[2], dO[2], then lse[2] and delta[2] of QR
  static constexpr size_t kSmem = sizeof(float) * (2 * kKv + 4 * kQ + 4 * QR);
};

// Query tile `q0`'s rows of Q and dO, and their lse and delta, into buffer
// `buf`; rows past sq read as zeros.
template <int DN>
__device__ __forceinline__ void load_tile(float* sm, int buf, const float* qb,
                                          const float* dob, const float* lb,
                                          const float* db, int q0, int sq,
                                          int d) {
  using L = DkvLayout<DN>;
  float* qs = sm + 2 * L::kKv + buf * L::kQ;
  float* dos = sm + 2 * L::kKv + (2 + buf) * L::kQ;
  float* st = sm + 2 * L::kKv + 4 * L::kQ + buf * 2 * L::QR;
  load_rows<L::QR>(qs, qb, q0, sq, d, L::kStride);
  load_rows<L::QR>(dos, dob, q0, sq, d, L::kStride);
  if (threadIdx.x < 2 * L::QR) {
    const int r = threadIdx.x % L::QR;
    const float* src = threadIdx.x < L::QR ? lb : db;
    const bool ok = q0 + r < sq;
    cp4(st + threadIdx.x, ok ? src + q0 + r : src, ok);
  }
}

template <int DN>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int sq, int sk, int d, int offset, int causal,
                            int n_tiles, float scale, float scale_log2) {
  using L = DkvLayout<DN>;
  constexpr int MT = L::MT, QR = L::QR, NT = QR / 8;
  constexpr int S = L::kStride;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* vs = sm + L::kKv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nd = d >> 3;
  const int tile = (int)(blockIdx.x % n_tiles);
  const size_t b = blockIdx.x / n_tiles;
  const int j0 = tile * L::kKeys;
  const float* qb = q + b * sq * d;
  const float* dob = dout + b * sq * d;
  const float* lb = lse + b * sq;
  const float* db = delta + b * sq;

  // the first query row that can see key j0; earlier rows see none of the
  // tile's keys (offset may be negative)
  const int i_begin = causal ? max(0, j0 - offset) : 0;
  const int t_begin = i_begin / QR;
  const int t_end = i_begin < sq ? (sq + QR - 1) / QR : t_begin;
  load_rows<L::kKeys>(ks, k + b * sk * d, j0, sk, d, S);
  load_rows<L::kKeys>(vs, v + b * sk * d, j0, sk, d, S);
  if (t_begin < t_end)
    load_tile<DN>(sm, 0, qb, dob, lb, db, t_begin * QR, sq, d);
  cp_commit();

  const int kw = j0 + warp * 16 * MT;  // the warp's first key
  float dka[MT][DN][4], dva[MT][DN][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < DN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[mt][n][e] = dva[mt][n][e] = 0.f;
    }
  }
  const float* ka = ks + (warp * 16 * MT + g) * S + t;
  const float* va = vs + (warp * 16 * MT + g) * S + t;

  for (int it = t_begin; it < t_end; ++it) {
    const int buf = (it - t_begin) & 1;
    if (it + 1 < t_end) {
      load_tile<DN>(sm, buf ^ 1, qb, dob, lb, db, (it + 1) * QR, sq, d);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* Q = sm + 2 * L::kKv + buf * L::kQ;
    const float* dO = sm + 2 * L::kKv + (2 + buf) * L::kQ;
    const float* ls = sm + 2 * L::kKv + 4 * L::kQ + buf * 2 * QR;
    const float* ds_ = ls + QR;
    const int q0 = it * QR;
    // warp-uniform: a mask is needed, or the warp's keys are all unseen
    const bool need = q0 + QR > sq || kw + 16 * MT > sk ||
                      (causal && kw + 16 * MT - 1 > q0 + offset);
    const bool none = causal && kw > q0 + QR - 1 + offset;
    if (!none) {
      // S^T = K Q^T and dP^T = V dO^T: 16 MT keys x QR rows; a Q or dO
      // fragment serves the MT m-tiles
      float st[MT][NT][4], dpt[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) st[mt][n][e] = dpt[mt][n][e] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < DN; ++kk) {
        if (kk < nd) {
          FragA fk[MT], fv[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float* a = ka + mt * 16 * S + kk * 8;
            const float* c = va + mt * 16 * S + kk * 8;
            fk[mt].set(a[0], a[8 * S], a[4], a[8 * S + 4]);
            fv[mt].set(c[0], c[8 * S], c[4], c[8 * S + 4]);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int at = (n * 8 + g) * S + kk * 8 + t;
            FragB fq, fo;
            fq.set(Q[at], Q[at + 4]);
            fo.set(dO[at], dO[at + 4]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma3(st[mt][n], fk[mt], fq);
              mma3(dpt[mt][n], fv[mt], fo);
            }
          }
        }
      }
      // P^T and dS^T on the lanes that own them: element e of n-tile n is
      // (key kw + 16 mt + g + 8 (e / 2), row q0 + 8 n + 2 t + e % 2)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = n * 8 + 2 * t + c;
          const float lr = ls[r] * kLog2e, dr = ds_[r];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int x = 2 * h + c;
              bool vis = true;
              if (need) {
                const int i = q0 + r, j = kw + mt * 16 + g + 8 * h;
                vis = i < sq && j < sk && (!causal || j <= i + offset);
              }
              const float p =
                  vis ? exp2_approx(st[mt][n][x] * scale_log2 - lr) : 0.f;
              st[mt][n][x] = p;
              dpt[mt][n][x] = p * (dpt[mt][n][x] - dr) * scale;
            }
          }
        }
      }
      // dV += P^T dO and dK += dS^T Q: the row n-tiles are the k-steps; a
      // dO or Q fragment serves the MT m-tiles. Each output n-tile's sum
      // over the tile's rows starts from zero in the tensor cores and is
      // then added to the running dK and dV by fp32 adds: the tensor cores
      // truncate what they accumulate, and over thousands of rows that
      // bias would gather in a running sum (1.5e-4 at 4096 rows, d 128)
      FragA fp[NT][MT], fs[NT][MT];
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          fp[kk][mt].set(st[mt][kk][0], st[mt][kk][2], st[mt][kk][1],
                         st[mt][kk][3]);
          fs[kk][mt].set(dpt[mt][kk][0], dpt[mt][kk][2], dpt[mt][kk][1],
                         dpt[mt][kk][3]);
        }
      }
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        if (n < nd) {
          float tv[MT][4], tk[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) tv[mt][e] = tk[mt][e] = 0.f;
          }
#pragma unroll
          for (int kk = 0; kk < NT; ++kk) {
            const int at = (kk * 8 + 2 * t) * S + g + n * 8;
            FragB fo, fq;
            fo.set(dO[at], dO[at + S]);
            fq.set(Q[at], Q[at + S]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma3(tv[mt], fp[kk][mt], fo);
              mma3(tk[mt], fs[kk][mt], fq);
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dva[mt][n][e] += tv[mt][e];
              dka[mt][n][e] += tk[mt][e];
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer is reloaded next turn
  }
  cp_wait<0>();  // a block with no query tile still has K and V in flight

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = kw + mt * 16 + g + 8 * h;
      if (j >= sk) continue;
      const size_t at = (b * sk + j) * d + 2 * t;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        if (n < nd) {
          *reinterpret_cast<float2*>(dk + at + n * 8) =
              make_float2(dka[mt][n][2 * h], dka[mt][n][2 * h + 1]);
          *reinterpret_cast<float2*>(dv + at + n * 8) =
              make_float2(dva[mt][n][2 * h], dva[mt][n][2 * h + 1]);
        }
      }
    }
  }
}

template <int DN>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dk, float* dv, int bh,
           int sq, int sk, int hd, int offset, int causal, float scale,
           cudaStream_t stream) {
  using L = DkvLayout<DN>;
  if (const cudaError_t e = cudaFuncSetAttribute(
          flash_bwd_dkv_tf32x3_kernel<DN>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem))
    return (int)e;
  const int n_tiles = (sk + L::kKeys - 1) / L::kKeys;
  const dim3 grid((unsigned)((size_t)bh * n_tiles));
  flash_bwd_dkv_tf32x3_kernel<DN><<<grid, kThreads, L::kSmem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, sq, sk, hd, offset, causal, n_tiles,
      scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 q, dout [bh, sq, hd]; k, v, dk, dv [bh, sk, hd]; lse, delta [bh, sq];
// hd a multiple of 8 from 8 to 128; q, k, v, dout, dk, dv 16-byte aligned
// (cp.async). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dim the kernel does not take.
extern "C" int pt_flash_attention_bwd_dkv_tf32x3(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
    int sk, int hd, int offset, int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hd < 8 || hd > 128 || hd % 8) return (int)cudaErrorInvalidValue;
  if (bh * sk == 0) return (int)cudaGetLastError();
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *of = (const float*)dout,
              *lf = (const float*)lse, *df = (const float*)delta;
  float *dkf = (float*)dk, *dvf = (float*)dv;
  switch (dn_bucket(hd)) {
    case 2: return launch<2>(qf, kf, vf, of, lf, df, dkf, dvf, bh, sq, sk, hd, offset, causal, scale, st);
    case 4: return launch<4>(qf, kf, vf, of, lf, df, dkf, dvf, bh, sq, sk, hd, offset, causal, scale, st);
    case 8: return launch<8>(qf, kf, vf, of, lf, df, dkf, dvf, bh, sq, sk, hd, offset, causal, scale, st);
    case 9: return launch<9>(qf, kf, vf, of, lf, df, dkf, dvf, bh, sq, sk, hd, offset, causal, scale, st);
    case 12: return launch<12>(qf, kf, vf, of, lf, df, dkf, dvf, bh, sq, sk, hd, offset, causal, scale, st);
    default: return launch<16>(qf, kf, vf, of, lf, df, dkf, dvf, bh, sq, sk, hd, offset, causal, scale, st);
  }
}

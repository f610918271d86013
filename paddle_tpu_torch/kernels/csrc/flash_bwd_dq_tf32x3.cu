// Flash-attention backward dQ in fp32 on Hopper's tensor cores (3xTF32),
// from the saved per-row log-sum-exp.
//
// Replaces the TPU kernel `_bwd_dq_kernel`, launched by `_flash_bwd`, in
// paddle_tpu/kernels/flash_attention.py (:206, call :296) for fp32 at a head
// dim d that is a multiple of 8 up to 128. Same function as the dQ kernel
// of flash_attention_bwd.cu: q, dO [bh, sq, d], k, v [bh, sk, d], lse and
// delta = rowsum(dO * O) - dlse [bh, sq] fp32; under `causal` query row i
// sees key j iff j <= i + offset; for every visible pair
//   p = exp(scale q.k - lse), dp = dO.v, ds = p (dp - delta) scale,
//   dQ_i += ds k_j,
// and a masked pair adds exactly 0 (p is selected to 0, so a row that sees
// no key, lse = -1e30, forms no inf and gets dQ = 0).
//
// What bounds it on the H100: operations (6 d FLOPs a visible pair: three
// products). fp32 on the CUDA cores peaks at 67 TFLOP/s; the three TF32
// products of each (tf32x3.cuh) at ~165 effective.
//
// What the design does about it: the mirror image of the dK/dV kernel
// (flash_bwd_dkv_tf32x3.cu), built like the forward (flash_fwd_tf32x3.cu).
// One block per (bh, tile of query rows), 4 warps of 16 MT rows each; dQ
// stays in registers. K and V tiles of KT keys stream through shared
// memory, double-buffered by cp.async, in rows of row_stride(DN) floats.
// Per key tile each warp computes S = Q K^T and dP = dO V^T (mma.sync
// m16n8k8, 3xTF32), then P and dS on the lanes that own them (the hardware
// exp2 of the prescaled logit), and takes dS as the A operand of dQ += dS K
// straight from its registers (tf32x3.cuh's renaming). Each key tile's
// contribution is summed from zero in the tensor cores and added to the
// running dQ by fp32 adds: the tensor cores truncate what they accumulate,
// and over thousands of keys a running sum in them gathers that bias (the
// dK/dV kernel's dK at 4096 rows, d 128: 1.4e-4 against 1.4e-5). Under
// causal a block stops at its last row's last visible key (the TPU kernel's
// skip at :241-246) and a warp skips a tile that none of its rows sees;
// only tiles that a mask cuts pay for it. Ragged sq and sk read as zeros
// and are masked. No atomics: every sum runs in a fixed order, so two
// launches agree bit for bit. See DqShape for the tiles.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

// The tile shape of a head-dim bucket: MT m-tiles of 16 query rows a warp
// (64 MT rows a block) and KT keys a K / V tile. Two m-tiles let each K and
// V fragment, split once, serve two products (DiT's d 72: 0.44 ms in graph
// replay against 0.48 for one m-tile); elsewhere one m-tile keeps 2 or 3
// blocks an SM (at most 168 registers). Chosen on the card from MT 1-2 x
// KT 16-32 at DiT's, BERT's, causal 2048 d 128 and d 96 shapes
// (tools/torch_dq_sweep.py). Splitting Q and dO once into registers
// instead of once a key tile spilled at d 96 and 128 and did not pay.
template <int DN>
struct DqShape {
  static constexpr int MT = DN == 9 ? 2 : 1;
  static constexpr int KT = DN == 9 || DN == 16 ? 16 : 32;
};

template <int DN>
struct DqLayout {
  static constexpr int MT = DqShape<DN>::MT, KT = DqShape<DN>::KT;
  static constexpr int kRows = 64 * MT;  // query rows a block
  static constexpr int kStride = row_stride(DN);
  static constexpr int kQ = kRows * kStride;  // floats of the Q or dO tile
  static constexpr int kKv = KT * kStride;    // of a K or V tile
  // Q, dO, then K[2] and V[2]
  static constexpr size_t kSmem = sizeof(float) * (2 * kQ + 4 * kKv);
};

template <int DN>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int sq, int sk, int d,
                           int offset, int causal, int n_tiles, float scale,
                           float scale_log2) {
  using L = DqLayout<DN>;
  constexpr int MT = L::MT, KT = L::KT, NT = KT / 8;
  constexpr int S = L::kStride;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // [kRows][S]
  float* dos = sm + L::kQ;         // [kRows][S]
  float* ks = sm + 2 * L::kQ;      // [2][KT][S]
  float* vs = ks + 2 * L::kKv;     // [2][KT][S]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nd = d >> 3;
  // the tiles with the most keys under causal first
  const int tile = n_tiles - 1 - (int)(blockIdx.x % n_tiles);
  const size_t b = blockIdx.x / n_tiles;
  const int i0 = tile * L::kRows;
  const float* kb = k + b * sk * d;
  const float* vb = v + b * sk * d;

  // keys [0, kend) can be visible to the block's rows
  const int last = min(i0 + L::kRows, sq) - 1;
  const int kend = causal ? max(0, min(sk, last + offset + 1)) : sk;
  const int n_kt = (kend + KT - 1) / KT;
  load_rows<L::kRows>(qs, q + b * sq * d, i0, sq, d, S);
  load_rows<L::kRows>(dos, dout + b * sq * d, i0, sq, d, S);
  if (n_kt > 0) {
    load_rows<KT>(ks, kb, 0, sk, d, S);
    load_rows<KT>(vs, vb, 0, sk, d, S);
  }
  cp_commit();

  const int w0 = i0 + warp * 16 * MT;  // the warp's first row
  float acc[MT][DN][4];
  float lr[MT][2], dr[MT][2];  // lse (log2 units) and delta of the rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = w0 + mt * 16 + g + 8 * r;
      lr[mt][r] = i < sq ? lse[b * sq + i] * kLog2e : 0.f;
      dr[mt][r] = i < sq ? delta[b * sq + i] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < DN; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  }
  const float* qa = qs + (warp * 16 * MT + g) * S + t;
  const float* oa = dos + (warp * 16 * MT + g) * S + t;

  for (int it = 0; it < n_kt; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_kt) {
      load_rows<KT>(ks + (buf ^ 1) * L::kKv, kb, (it + 1) * KT, sk, d, S);
      load_rows<KT>(vs + (buf ^ 1) * L::kKv, vb, (it + 1) * KT, sk, d, S);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* K = ks + buf * L::kKv;
    const float* V = vs + buf * L::kKv;
    const int j0 = it * KT;
    // warp-uniform: does any (row, key) pair of the warp's tile need a mask
    const bool need = j0 + KT > sk || (causal && j0 + KT - 1 > w0 + offset);
    // a warp whose rows see none of the tile's keys skips it
    const bool none = causal && j0 > w0 + 16 * MT - 1 + offset;
    if (!none) {
      // S = Q K^T and dP = dO V^T: 16 MT rows x KT keys; a K or V fragment
      // serves the MT m-tiles
      float s[MT][NT][4], dp[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = dp[mt][n][e] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < DN; ++kk) {
        if (kk < nd) {
          FragA fq[MT], fo[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float* a = qa + mt * 16 * S + kk * 8;
            const float* c = oa + mt * 16 * S + kk * 8;
            fq[mt].set(a[0], a[8 * S], a[4], a[8 * S + 4]);
            fo[mt].set(c[0], c[8 * S], c[4], c[8 * S + 4]);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int at = (n * 8 + g) * S + kk * 8 + t;
            FragB fk, fv;
            fk.set(K[at], K[at + 4]);
            fv.set(V[at], V[at + 4]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma3(s[mt][n], fq[mt], fk);
              mma3(dp[mt][n], fo[mt], fv);
            }
          }
        }
      }
      // P and dS on the lanes that own them: element e of n-tile n is
      // (row w0 + 16 mt + g + 8 (e / 2), key j0 + 8 n + 2 t + e % 2)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            bool vis = true;
            if (need) {
              const int i = w0 + mt * 16 + g + 8 * r;
              const int j = j0 + n * 8 + 2 * t + (e & 1);
              vis = j < sk && (!causal || j <= i + offset);
            }
            const float p =
                vis ? exp2_approx(s[mt][n][e] * scale_log2 - lr[mt][r]) : 0.f;
            s[mt][n][e] = p * (dp[mt][n][e] - dr[mt][r]) * scale;
          }
        }
      }
      // dQ += dS K: the key n-tiles of dS are the k-steps, its C fragment
      // the A operand (keys 2t, 2t + 1 of each step); a K fragment serves
      // the MT m-tiles. Each output n-tile's sum over the tile's keys starts
      // from zero in the tensor cores and joins dQ by fp32 adds
      FragA fs[NT][MT];
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          fs[kk][mt].set(s[mt][kk][0], s[mt][kk][2], s[mt][kk][1],
                         s[mt][kk][3]);
      }
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        if (n < nd) {
          float tq[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            tq[mt][0] = tq[mt][1] = tq[mt][2] = tq[mt][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < NT; ++kk) {
            const float* kp = K + (kk * 8 + 2 * t) * S + g + n * 8;
            FragB fb;
            fb.set(kp[0], kp[S]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma3(tq[mt], fs[kk][mt], fb);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] += tq[mt][e];
          }
        }
      }
    }
    __syncthreads();  // the buffer is reloaded next turn
  }
  cp_wait<0>();  // a block with no key tile still has its Q load in flight

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = w0 + mt * 16 + g + 8 * r;
      if (i >= sq) continue;
      float* row = dq + (b * sq + i) * d + 2 * t;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        if (n < nd)
          *reinterpret_cast<float2*>(row + n * 8) =
              make_float2(acc[mt][n][2 * r], acc[mt][n][2 * r + 1]);
      }
    }
  }
}

template <int DN>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dq, int bh, int sq,
           int sk, int hd, int offset, int causal, float scale,
           cudaStream_t stream) {
  using L = DqLayout<DN>;
  if (const cudaError_t e = cudaFuncSetAttribute(
          flash_bwd_dq_tf32x3_kernel<DN>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem))
    return (int)e;
  const int n_tiles = (sq + L::kRows - 1) / L::kRows;
  const dim3 grid((unsigned)((size_t)bh * n_tiles));
  flash_bwd_dq_tf32x3_kernel<DN><<<grid, kThreads, L::kSmem, stream>>>(
      q, k, v, dout, lse, delta, dq, sq, sk, hd, offset, causal, n_tiles,
      scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 q, dout, dq [bh, sq, hd]; k, v [bh, sk, hd]; lse, delta [bh, sq];
// hd a multiple of 8 from 8 to 128; q, k, v, dout, dq 16-byte aligned
// (cp.async). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dim the kernel does not take.
extern "C" int pt_flash_attention_bwd_dq_tf32x3(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
    int hd, int offset, int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hd < 8 || hd > 128 || hd % 8) return (int)cudaErrorInvalidValue;
  if (bh * sq == 0) return (int)cudaGetLastError();
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *of = (const float*)dout,
              *lf = (const float*)lse, *df = (const float*)delta;
  float* dqf = (float*)dq;
  switch (dn_bucket(hd)) {
    case 2: return launch<2>(qf, kf, vf, of, lf, df, dqf, bh, sq, sk, hd, offset, causal, scale, st);
    case 4: return launch<4>(qf, kf, vf, of, lf, df, dqf, bh, sq, sk, hd, offset, causal, scale, st);
    case 8: return launch<8>(qf, kf, vf, of, lf, df, dqf, bh, sq, sk, hd, offset, causal, scale, st);
    case 9: return launch<9>(qf, kf, vf, of, lf, df, dqf, bh, sq, sk, hd, offset, causal, scale, st);
    case 12: return launch<12>(qf, kf, vf, of, lf, df, dqf, bh, sq, sk, hd, offset, causal, scale, st);
    default: return launch<16>(qf, kf, vf, of, lf, df, dqf, bh, sq, sk, hd, offset, causal, scale, st);
  }
}

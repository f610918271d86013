// Flash-attention forward in fp32 on Hopper's tensor cores (3xTF32), with
// per-row log-sum-exp.
//
// Replaces the TPU kernel `_fwd_kernel`, launched by `_flash_fwd`, in
// paddle_tpu/kernels/flash_attention.py (:64, call :124) for fp32 with more
// than one query row and a head dim d that is a multiple of 8 up to 128
// (DiT-XL/2's d 72, BERT's 64, the fp32 parity steps' 128). Same function
// as flash_attention.cu: q [bh,sq,d] against k, v [bh,sk,d]; under `causal`
// query row i sees key j iff j <= i + offset. Returns o [bh,sq,d] fp32 and
// lse [bh,sq] fp32; a row that sees no key gives o = 0 and lse = -1e30.
//
// What bounds it on the H100: operations (4 d FLOPs a visible pair, ~36
// FLOPs a byte of q/k/v/o at DiT's 256 x 256, d 72). fp32 on the CUDA
// cores peaks at 67 TFLOP/s; TF32 on the tensor cores at 495, and the three
// TF32 products that keep fp32's accuracy (tf32x3.cuh) at ~165 effective.
//
// What the design does about it: one block per (bh, tile of 128 query
// rows), 4 warps of 32 rows (two m16 tiles) each. The Q tile is staged
// once; K and V tiles of 32 keys (16 at d > 72) are double-buffered in
// shared memory by cp.async. Each warp computes its 32 x 32 scores S = Q K^T
// as mma.sync m16n8k8 products held in registers in the C-fragment layout,
// each K fragment split once for both m-tiles; the online softmax runs on
// them once a tile (row max over the 4 lanes that share a row: two
// shuffles a row a tile; the hardware exp2 of the prescaled logit, once a
// pair, on the lane that owns it; the row sum kept per lane and reduced at
// the end); P then feeds P V as the A operand straight from its registers
// (tf32x3.cuh's renaming), each tile's P V summed from zero in the tensor
// cores and added to the rescaled O by an fp32 multiply-add (the tensor
// cores' accumulation truncates; over thousands of keys a running sum in
// them would gather that bias). Under causal a
// block stops at its last row's diagonal and a warp skips a tile its rows
// do not see; a tile that a warp's rows see whole skips the mask. Ragged
// sq and sk read as zeros and are masked. Every sum runs in a fixed order:
// two launches agree bit for bit. The kernel is issue- and latency-bound
// well below the tensor cores' rate (a third of its instructions split
// operands); see FwdShape for the tiles. The CUDA-core kernel of
// flash_attention.cu keeps fp32 at other head dims and bf16 away from the
// tensor-core head dims.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

// The tile shape of a head-dim bucket: MT m-tiles of 16 query rows a warp
// (4 MT 16 rows a block) and KT keys a K / V tile. Two m-tiles let every K
// and V fragment, split once, serve two products; the key tile keeps the
// registers under 255 without spills and the shared memory at 2 blocks an
// SM (86 KB at d 72). Chosen on the card from MT 1-2 x KT 16-64 (DiT's and
// BERT's shapes, and causal 512 at d 128).
template <int DN>
struct FwdShape {
  static constexpr int MT = 2;
  static constexpr int KT = DN <= 9 ? 32 : 16;
};

template <int DN>
struct FwdLayout {
  static constexpr int MT = FwdShape<DN>::MT, KT = FwdShape<DN>::KT;
  static constexpr int kRows = 64 * MT;   // query rows a block
  static constexpr int kStride = row_stride(DN);
  static constexpr int kQ = kRows * kStride;  // floats of the Q tile
  static constexpr int kKv = KT * kStride;    // of a K or V tile
  static constexpr size_t kSmem = sizeof(float) * (kQ + 4 * kKv);  // Q, K2, V2
};

// Up to d 64 the tiles' shared memory (70 KB at d 64) lets 3 blocks share
// an SM if their registers fit 170 a thread: asked for (BERT's shape ran
// 0.047 ms against 0.062 at 183 registers and 2 blocks).
template <int DN>
__global__ void __launch_bounds__(kThreads, DN <= 8 ? 3 : 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int sq, int sk, int d,
                        int offset, int causal, int n_tiles,
                        float scale_log2) {
  using L = FwdLayout<DN>;
  constexpr int MT = L::MT, KT = L::KT, NT = KT / 8;
  constexpr int S = L::kStride;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                   // [kRows][S]
  float* ks = sm + L::kQ;           // [2][KT][S]
  float* vs = ks + 2 * L::kKv;      // [2][KT][S]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nd = d >> 3;
  // the tiles with the most keys under causal first
  const int tile = n_tiles - 1 - (int)(blockIdx.x % n_tiles);
  const size_t b = blockIdx.x / n_tiles;
  const int i0 = tile * L::kRows;
  const float* qb = q + b * sq * d;
  const float* kb = k + b * sk * d;
  const float* vb = v + b * sk * d;

  // keys [0, kend) can be visible to the block's rows
  const int last = min(i0 + L::kRows, sq) - 1;
  const int kend = causal ? max(0, min(sk, last + offset + 1)) : sk;
  const int n_kt = (kend + KT - 1) / KT;
  load_rows<L::kRows>(qs, qb, i0, sq, d, S);
  if (n_kt > 0) {
    load_rows<KT>(ks, kb, 0, sk, d, S);
    load_rows<KT>(vs, vb, 0, sk, d, S);
  }
  cp_commit();

  const int w0 = i0 + warp * 16 * MT;  // the warp's first row
  float acc[MT][DN][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNeg;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  }
  const float* qa = qs + (warp * 16 * MT + g) * S + t;

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
      // S = Q K^T: 16 MT rows x KT keys; a K fragment serves the MT m-tiles
      float s[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
          s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DN; ++kk) {
        if (kk < nd) {
          FragA fa[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float* a = qa + mt * 16 * S + kk * 8;
            fa[mt].set(a[0], a[8 * S], a[4], a[8 * S + 4]);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float* kp = K + (n * 8 + g) * S + kk * 8 + t;
            FragB fb;
            fb.set(kp[0], kp[4]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma3(s[mt][n], fa[mt], fb);
          }
        }
      }
      // online softmax in log2 units; masked pairs read -inf, so exp2 gives
      // them exactly 0 and the row max (which starts at -1e30) stays finite
      float alpha[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[mt][n][e] * scale_log2;
            if (need) {
              const int i = w0 + mt * 16 + g + 8 * (e >> 1);
              const int j = j0 + n * 8 + 2 * t + (e & 1);
              const bool vis = j < sk && (!causal || j <= i + offset);
              x = vis ? x : masked();
            }
            s[mt][n][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        }
        alpha[mt][0] = exp2_approx(m[mt][0] - mx[0]);
        alpha[mt][1] = exp2_approx(m[mt][1] - mx[1]);
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_approx(s[mt][n][e] - mx[e >> 1]);
            s[mt][n][e] = p;
            rs[e >> 1] += p;
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[mt][r] = l[mt][r] * alpha[mt][r] + rs[r];
          m[mt][r] = mx[r];
        }
      }
      // O = alpha O + P V: the key n-tiles of S are the k-steps, P's C
      // fragment the A operand (keys 2t, 2t + 1 of each step); a V fragment
      // serves the MT m-tiles. Each n-tile's tile sum starts from zero in
      // the tensor cores and joins O by an fp32 multiply-add: the tensor
      // cores truncate what they accumulate, and over thousands of keys a
      // running sum would gather that bias
      FragA fa[NT][MT];
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          fa[kk][mt].set(s[mt][kk][0], s[mt][kk][2], s[mt][kk][1],
                         s[mt][kk][3]);
      }
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        if (n < nd) {
          float tv[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            tv[mt][0] = tv[mt][1] = tv[mt][2] = tv[mt][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < NT; ++kk) {
            const float* vp = V + (kk * 8 + 2 * t) * S + g + n * 8;
            FragB fb;
            fb.set(vp[0], vp[S]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma3(tv[mt], fa[kk][mt], fb);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][n][e] = fmaf(acc[mt][n][e], alpha[mt][e >> 1],
                                   tv[mt][e]);
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
      // each lane summed its own columns: the row sum over the quad
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int i = w0 + mt * 16 + g + 8 * r;
      if (i >= sq) continue;
      // a row that saw no key (l == 0) gives o = 0 and lse = -1e30
      const float inv = lr > 0.f ? 1.f / lr : 0.f;
      float* orow = o + (b * sq + i) * d + 2 * t;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        if (n < nd)
          *reinterpret_cast<float2*>(orow + n * 8) = make_float2(
              acc[mt][n][2 * r] * inv, acc[mt][n][2 * r + 1] * inv);
      }
      if (t == 0)
        lse[b * sq + i] = lr > 0.f ? (m[mt][r] + log2f(lr)) * kLn2 : kNeg;
    }
  }
}

template <int DN>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int bh, int sq, int sk, int hd, int offset,
           int causal, float scale, cudaStream_t stream) {
  using L = FwdLayout<DN>;
  if (const cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_tf32x3_kernel<DN>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem))
    return (int)e;
  const int n_tiles = (sq + L::kRows - 1) / L::kRows;
  const dim3 grid((unsigned)((size_t)bh * n_tiles));
  flash_fwd_tf32x3_kernel<DN><<<grid, kThreads, L::kSmem, stream>>>(
      q, k, v, o, lse, sq, sk, hd, offset, causal, n_tiles, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 q [bh, sq, hd], k, v [bh, sk, hd], o [bh, sq, hd], lse [bh, sq];
// hd a multiple of 8 from 8 to 128; every pointer 16-byte aligned
// (cp.async). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dim the kernel does not take.
extern "C" int pt_flash_attention_fwd_tf32x3(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int bh, int sq,
                                             int sk, int hd, int offset,
                                             int causal, float scale,
                                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hd < 8 || hd > 128 || hd % 8) return (int)cudaErrorInvalidValue;
  if (bh * sq == 0) return (int)cudaGetLastError();
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v;
  float *of = (float*)o, *lf = (float*)lse;
  switch (dn_bucket(hd)) {
    case 2: return launch<2>(qf, kf, vf, of, lf, bh, sq, sk, hd, offset, causal, scale, st);
    case 4: return launch<4>(qf, kf, vf, of, lf, bh, sq, sk, hd, offset, causal, scale, st);
    case 8: return launch<8>(qf, kf, vf, of, lf, bh, sq, sk, hd, offset, causal, scale, st);
    case 9: return launch<9>(qf, kf, vf, of, lf, bh, sq, sk, hd, offset, causal, scale, st);
    case 12: return launch<12>(qf, kf, vf, of, lf, bh, sq, sk, hd, offset, causal, scale, st);
    default: return launch<16>(qf, kf, vf, of, lf, bh, sq, sk, hd, offset, causal, scale, st);
  }
}

// Flash-attention forward on Hopper's tensor cores (sm_90a) at the head dims
// above 128: bf16 inputs, any head dim d that is a multiple of 8 from 136 to
// 256 (Gemma 2B's and GPT-J's 256), fp32 accumulation, per-row log-sum-exp.
// flash_fwd_sm90.cu keeps d <= 128 and hands the rest to this file.
//
// Replaces the TPU kernel `_fwd_kernel` (paddle_tpu/kernels/flash_attention.py
// :64, launched by `_flash_fwd` at :124) for those inputs; the function is
// flash_fwd_sm90.cu's: q [bh,sq,d] against k, v [bh,sk,d]; under `causal`
// row i sees key j iff j <= i + offset; o [bh,sq,d] bf16 and lse [bh,sq]
// fp32; a row that sees no key gives o = 0 and lse = -1e30. P is rounded to
// bf16 before P.V, as the TPU kernel rounds `p.astype(v.dtype)` (:96-98); the
// row sum l adds the fp32 p.
//
// What bounds it on the H100: operations (4 d FLOPs per visible (row, key)
// pair; causal 2048 at d 256 is ~1000 FLOPs per byte of q/k/v/o).
//
// What bounds the design: shared memory and registers, both twice the d 128
// kernel's at the same tiles. 128 query rows and 128-key K/V tiles in a
// 2-stage ring would take 64 KB of Q and 4 x 64 KB of K/V at d 256, past the
// 227 KB a block may use; and each thread holds its rows' O as fp32, DP / 2
// registers (128 at d 256) beside S.
//
// What the design does about it: the K/V tiles are cut to 64 keys. One block
// of two warpgroups per (bh, tile of 128 query rows), each warpgroup owning
// 64 rows: Q 64 KB, a K and a V tile 32 KB each, two stages, ~192 KB in all.
// Each thread then holds O (DP / 2 floats) and S for 64 keys (32 floats),
// with P as 16 bf16x2 registers, under the 255-register limit. Per key tile:
//   S = Q.K^T       wgmma m64n64k16 over DP / 16 k16 steps, both operands
//                   K-major in shared memory;
//   online softmax  on the accumulator fragment in registers, in log2 units;
//   O += P.V        two wgmma a k16 step: N 128 over V's first two 64-column
//                   chunks and N DP - 128 over the rest, P the bf16 register
//                   A operand, V MN-major (transpose bit), O kept as the two
//                   accumulators of those products.
// K and V are loaded by TMA (128-byte swizzle) through "full" / "empty"
// mbarriers, thread 0 issuing the loads between its own tiles. Under causal,
// tiles above the block's diagonal are not loaded, a warpgroup skips the
// tiles none of its rows sees (the TPU kernel's skip at :102-106), and only
// tiles that cross the diagonal or the end of the keys are masked.
//
// Head dims, as in flash_fwd_sm90.cu: an instance for each padded width DP =
// ceil16(d) (144, 160, .., 256), the real d at run time; ceil(DP / 64)
// 64-column chunks a tile, loaded as whole boxes so that TMA fills the
// columns past d with zeros; only the columns below d are written.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 128;  // query rows per block (two warpgroups of 64)
constexpr int kKeys = 64;   // keys per K / V tile
constexpr int kThreads = 256;

template <int DP>
struct WideFwdLayout {
  static_assert(DP > 128 && DP <= 256 && DP % 16 == 0, "DP: 144, .., 256");
  static constexpr int kChunks = (DP + 63) / 64;     // 64-column regions
  static constexpr uint32_t kChunkQ = kRows * 128;   // bytes of a Q chunk
  static constexpr uint32_t kChunkKV = kKeys * 128;  // of a K / V chunk
  static constexpr uint32_t kTileKV = kChunks * kChunkKV;
  static constexpr uint32_t kQ = kChunks * kChunkQ;
  static constexpr uint32_t kBars = kQ + 2 * 2 * kTileKV;  // full[2] empty[2] q
  static constexpr size_t kSmem = kBars + 64 + 1024;       // + alignment slack
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_wide_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int sq, int sk, int d,
                           int offset, int causal, float scale_log2) {
  using L = WideFwdLayout<DP>;
  constexpr int C = L::kChunks;
  constexpr int N1 = DP - 128;  // O's columns past the first two chunks
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + L::kQ;  // stage s: K at + 2 s kTileKV, V after it
  const uint32_t bar = sQ + L::kBars;
  const uint32_t qbar = bar + 32;

  const int b = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest rows first
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row_lo = q0 + wg * 64 + warp * 16 + lane / 4;  // d[i], i % 4 < 2
  const int row_hi = row_lo + 8;                           // d[i], i % 4 >= 2
  const int cq = 2 * (lane % 4);

  const int kend = causal ? min(sk, q0 + kRows + offset) : sk;
  const int n_tiles = kend > 0 ? (kend + kKeys - 1) / kKeys : 0;
  // the last key any row of this warpgroup sees
  const int wg_last = causal ? q0 + wg * 64 + 63 + offset : sk - 1;

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto load_kv = [=](int stage, int tile) {
    const uint32_t full = bar + 8 * stage;
    const uint32_t sK = sKV + 2 * stage * L::kTileKV;
    mbar_expect_tx(full, 2 * L::kTileKV);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tma_load(sK + c * L::kChunkKV, mk, full, 64 * c, tile * kKeys, b);
      tma_load(sK + L::kTileKV + c * L::kChunkKV, mv, full, 64 * c,
               tile * kKeys, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 16 + 8 * s, kThreads);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, L::kQ);
#pragma unroll
    for (int c = 0; c < C; ++c)
      tma_load(sQ + c * L::kChunkQ, &tq, qbar, 64 * c, q0, b);
    for (int s = 0; s < 2 && s < n_tiles; ++s) load_kv(s, s);
  }
  __syncwarp();

  // O's columns 0 .. 127 and 128 .. DP - 1, each an accumulator fragment
  float acc0[64], acc1[N1 / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N1 / 2; ++i) acc1[i] = 0.f;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;
  const uint32_t sQw = sQ + wg * 64 * 128;  // this warpgroup's 64 rows
  mbar_wait(qbar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const uint32_t parity = (it >> 1) & 1;
    const int k0 = it * kKeys;
    const uint32_t sK = sKV + 2 * stage * L::kTileKV;
    const uint32_t sV = sK + L::kTileKV;
    mbar_wait(bar + 8 * stage, parity);

    if (k0 <= wg_last) {  // uniform across the warpgroup
      // S = Q . K^T over DP in k16 steps
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // k within the 64-wide chunk
        wgmma_ss_n64(s, desc(sQw + (kk / 4) * L::kChunkQ + off, 16, 1024),
                     desc(sK + (kk / 4) * L::kChunkKV + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // online softmax in log2 units: v = scale * log2(e) * s, masked -> kNeg
      const bool mask = k0 + kKeys > sk ||
                        (causal && k0 + kKeys - 1 > q0 + wg * 64 + offset);
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float v = s[i] * scale_log2;
        if (mask) {
          const int col = k0 + 8 * (i / 4) + cq + (i & 1);
          const int row = (i & 2) ? row_hi : row_lo;
          if (col >= sk || (causal && col > row + offset)) v = kNeg;
        }
        s[i] = v;
        if (i & 2)
          mx_hi = fmaxf(mx_hi, v);
        else
          mx_lo = fmaxf(mx_lo, v);
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
      }
      const float a_lo = exp2f(m_lo - mx_lo), a_hi = exp2f(m_hi - mx_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      l_lo *= a_lo;
      l_hi *= a_hi;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        // masked entries are zeroed explicitly: in a row that has seen no
        // key yet the max is kNeg too and exp2(0) would be 1
        const float mrow = (i & 2) ? m_hi : m_lo;
        const float p = s[i] > 0.5f * kNeg ? exp2f(s[i] - mrow) : 0.f;
        s[i] = p;
        if (i & 2)
          l_hi += p;
        else
          l_lo += p;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] *= (i & 2) ? a_hi : a_lo;
#pragma unroll
      for (int i = 0; i < N1 / 2; ++i) acc1[i] *= (i & 2) ? a_hi : a_lo;

      // O += P . V over the 64 keys in k16 steps, P rounded to bf16: N 128
      // from V's chunks 0-1, N DP - 128 from chunk 2 on
      uint32_t pa[4][4];
      acc_to_a<32>(s, pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t sVk = sV + kk * 16 * 128;
        wgmma_rs<128>(acc0, pa[kk], desc(sVk, L::kChunkKV, 1024));
        wgmma_rs<N1>(acc1, pa[kk],
                     desc(sVk + 2 * L::kChunkKV, L::kChunkKV, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
    }

    // release the stage; thread 0 refills it with tile it + 2 once all 256
    // threads are done with it
    mbar_arrive(bar + 16 + 8 * stage);
    if (tid == 0 && it + 2 < n_tiles) {
      mbar_wait(bar + 16 + 8 * stage, parity);
      load_kv(stage, it + 2);
    }
    __syncwarp();
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const size_t base = (size_t)b * sq;
  // d > 128: every column of acc0 lies below d
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = (i & 2) ? row_hi : row_lo;
    const float inv = (i & 2) ? inv_hi : inv_lo;
    if (row < sq) {
      const int col = 8 * (i / 4) + cq;
      *reinterpret_cast<__nv_bfloat162*>(o + (base + row) * d + col) =
          __floats2bfloat162_rn(acc0[i] * inv, acc0[i + 1] * inv);
    }
  }
#pragma unroll
  for (int i = 0; i < N1 / 2; i += 2) {
    const int row = (i & 2) ? row_hi : row_lo;
    const float inv = (i & 2) ? inv_hi : inv_lo;
    // d is a multiple of 8: an 8-column group lies wholly below d or not
    if (row < sq && 128 + 8 * (i / 4) < d) {
      const int col = 128 + 8 * (i / 4) + cq;
      *reinterpret_cast<__nv_bfloat162*>(o + (base + row) * d + col) =
          __floats2bfloat162_rn(acc1[i] * inv, acc1[i + 1] * inv);
    }
  }
  if (lane % 4 == 0) {
    // natural-log lse = m ln 2 + ln l; a row that saw no key keeps -1e30
    if (row_lo < sq)
      lse[base + row_lo] = l_lo > 0.f ? m_lo * kLn2 + logf(l_lo) : kNeg;
    if (row_hi < sq)
      lse[base + row_hi] = l_hi > 0.f ? m_hi * kLn2 + logf(l_hi) : kNeg;
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int sq, int sk, int d, int offset, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = WideFwdLayout<DP>::kSmem;
  if (const cudaError_t e = allow_smem(flash_fwd_sm90_wide_kernel<DP>, smem))
    return (int)e;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, sq, d, kRows) ||
      !make_map(&tk, k, bh, sk, d, kKeys) ||
      !make_map(&tv, v, bh, sk, d, kKeys))
    return kMapRefused;
  const dim3 grid((unsigned)((sq + kRows - 1) / kRows), (unsigned)bh);
  flash_fwd_sm90_wide_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, sq, sk, d, offset, causal,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// The instances for hd a multiple of 8 from 136 to 256, called by
// pt_flash_attention_fwd_sm90 (flash_fwd_sm90.cu), which has checked hd and
// bh * sq; its contract otherwise.
int flash_fwd_sm90_wide(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int sq, int sk, int hd,
                        int offset, int causal, float scale,
                        cudaStream_t st) {
  switch ((hd + 15) / 16) {  // the instance of DP = ceil16(hd)
    case 9: return launch<144>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st);
    case 10: return launch<160>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st);
    case 11: return launch<176>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st);
    case 12: return launch<192>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st);
    case 13: return launch<208>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st);
    case 14: return launch<224>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st);
    case 15: return launch<240>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st);
    default: return launch<256>(q, k, v, o, lse, bh, sq, sk, hd, offset, causal, scale, st);
  }
}

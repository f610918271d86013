// Flash-attention dQ backward on Hopper's tensor cores (sm_90a) at the head
// dims above 128: bf16 inputs, any head dim d that is a multiple of 8 from
// 136 to 256 (Gemma 2B's and GPT-J's 256), fp32 accumulation.
// flash_bwd_dq_sm90.cu keeps d <= 128 and hands the rest to this file.
//
// Replaces the TPU kernel `_bwd_dq_kernel` (paddle_tpu/kernels/
// flash_attention.py:206, launched by `_flash_bwd` at :296) for those inputs;
// the function is flash_bwd_dq_sm90.cu's: for every visible pair (i, j)
// (j <= i + offset under `causal`)
//   p_ij = exp(scale q_i.k_j - lse_i),  dp_ij = dO_i.v_j,
//   ds_ij = p_ij (dp_ij - delta_i) scale,   dQ_i += ds_ij k_j,
// masked pairs exactly 0 (p is selected to 0 before any use, so a row that
// sees no key gets dQ = 0), ds rounded to bf16 as the A operand of dS.K,
// fp32 accumulation, dQ written once (no atomics, deterministic).
//
// What bounds it on the H100: operations (6 d FLOPs per visible pair: S,
// dP and dS.K).
//
// What bounds the design: shared memory and registers. The d <= 128 kernel
// keeps the Q and dO of its 128 query rows resident and streams 64-key K / V
// tiles through a 2-stage ring. At d 256 that is 128 KB of Q and dO plus
// 2 x 64 KB of K / V, past the 227 KB a block may use (the wide forward's
// 64-key ring fits only because the forward keeps Q alone). And each thread
// holds its rows' dQ as fp32, DP / 2 registers (128 at d 256), beside S and
// dP.
//
// What the design does about it: the K / V tiles are cut to 32 keys. One
// block of two warpgroups per (bh, tile of 128 query rows), each warpgroup
// owning 64 rows: Q and dO 64 KB each at d 256, loaded once by TMA; a K and
// a V tile of 32 keys, 16 KB each, through a 3-stage TMA ring (96 KB); ~225
// KB in all. A thread holds dQ (DP / 2 floats), S and dP (16 each) and its
// two rows' lse and delta (4). Per key tile and warpgroup:
//   S  = Q.K^T      wgmma m64n32k16 over DP / 16 k16 steps, both operands
//                   K-major in shared memory;
//   dP = dO.V^T     the same;
//   P, dS           on the accumulator fragments in registers;
//   dQ += dS.K      two k16 steps of two wgmma each: N 128 over K's first
//                   two 64-column chunks and N DP - 128 from chunk 2 on, dS
//                   the bf16 register A operand, K read MN-major (keys down
//                   the rows, the transpose bit set), dQ kept as the two
//                   accumulators of those products.
// Each warpgroup computes S and dP for its own rows only: 6 d FLOPs a pair,
// the function's count (a dQ column split between warpgroups that both
// computed S and dP, as the wide dK/dV kernel splits its columns, would
// compute 10 d). Against 64 query rows a block with 64-key tiles (~192 KB
// for a single warpgroup), two warpgroups a block let one warpgroup's
// products overlap the other's P and dS. The ring's third
// stage, which a 32-key tile leaves room for, was chosen on the card
// (tools/torch_dq_sweep.py --kernel sm90_wide): it hides the loads where a
// tile's products are short (d 136), and costs nothing measurable at 256.
// K and V are loaded by TMA (128-byte swizzle) through "full" / "empty"
// mbarriers, thread 0 issuing the loads between its own tiles. Under causal
// the key loop stops at the block's last visible key (the TPU kernel's skip
// at :241-246), a warpgroup skips the tiles that none of its rows sees, and
// only tiles on the diagonal or the ragged end of the keys pay for the mask.
//
// Head dims, as in the wide forward and dK/dV: an instance for each padded
// width DP = ceil16(d) (144, 160, .., 256), the real d at run time; ceil(DP
// / 64) 64-column chunks a tile, loaded as whole boxes so that TMA fills the
// columns past d with zeros; only the columns below d are written.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 128;  // query rows per block (two warpgroups of 64)
constexpr int kKeys = 32;   // keys per streamed K / V tile
constexpr int kStages = 3;  // K / V tiles in flight
constexpr int kThreads = 256;

template <int DP>
struct WideDqLayout {
  static_assert(DP > 128 && DP <= 256 && DP % 16 == 0, "DP: 144, .., 256");
  static constexpr int kChunks = (DP + 63) / 64;     // 64-column regions
  static constexpr uint32_t kChunkQ = kRows * 128;   // bytes of a Q/dO chunk
  static constexpr uint32_t kChunkKV = kKeys * 128;  // of a K/V chunk
  static constexpr uint32_t kQ = kChunks * kChunkQ;
  static constexpr uint32_t kTileKV = kChunks * kChunkKV;
  // [Q][dO][stage s: K, V][full[kStages] empty[kStages] q]
  static constexpr uint32_t kStage0 = 2 * kQ;
  static constexpr uint32_t kBars = kStage0 + kStages * 2 * kTileKV;
  static constexpr size_t kSmem =
      kBars + 8 * (2 * kStages + 1) + 1024;  // + alignment slack
  static_assert(kSmem <= 232448, "a block may use 227 KB");
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_wide_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int sq, int sk,
                              int d, int offset, int causal, float scale,
                              float scale_log2) {
  using L = WideDqLayout<DP>;
  constexpr int C = L::kChunks;
  constexpr int N1 = DP - 128;  // dQ's columns past the first two chunks
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + L::kQ;
  const uint32_t sKV0 = sQ + L::kStage0;  // stage s: K, then V
  const uint32_t bar = sQ + L::kBars;     // full[s], then empty[s]
  const uint32_t qbar = bar + 16 * kStages;

  const int b = blockIdx.y;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest rows first
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row_lo = i0 + wg * 64 + warp * 16 + lane / 4;  // d[i], i % 4 < 2
  const int row_hi = row_lo + 8;                           // d[i], i % 4 >= 2
  const int cq = 2 * (lane % 4);

  // keys past the block's last row's last visible key are never loaded
  const int kend = causal ? min(sk, i0 + kRows + offset) : sk;
  const int n_tiles = kend > 0 ? (kend + kKeys - 1) / kKeys : 0;
  // the last key any row of this warpgroup sees
  const int wg_last = causal ? i0 + wg * 64 + 63 + offset : sk - 1;

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto load_kv = [=](int stage, int tile) {
    const uint32_t full = bar + 8 * stage;
    const uint32_t sK = sKV0 + 2 * stage * L::kTileKV;
    mbar_expect_tx(full, 2 * L::kTileKV);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tma_load(sK + c * L::kChunkKV, mk, full, 64 * c, tile * kKeys, b);
      tma_load(sK + L::kTileKV + c * L::kChunkKV, mv, full, 64 * c,
               tile * kKeys, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (kStages + s), kThreads);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, 2 * L::kQ);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tma_load(sQ + c * L::kChunkQ, &tq, qbar, 64 * c, i0, b);
      tma_load(sDO + c * L::kChunkQ, &tdo, qbar, 64 * c, i0, b);
    }
    for (int s = 0; s < kStages && s < n_tiles; ++s) load_kv(s, s);
  }
  __syncwarp();

  // dQ's columns 0 .. 127 and 128 .. DP - 1, each an accumulator fragment
  float acc0[64], acc1[N1 / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N1 / 2; ++i) acc1[i] = 0.f;
  // lse (in log2 units) and delta of this thread's two rows
  const size_t rbase = (size_t)b * sq;
  const float l_lo = row_lo < sq ? lse[rbase + row_lo] * kLog2e : 0.f;
  const float l_hi = row_hi < sq ? lse[rbase + row_hi] * kLog2e : 0.f;
  const float d_lo = row_lo < sq ? delta[rbase + row_lo] : 0.f;
  const float d_hi = row_hi < sq ? delta[rbase + row_hi] : 0.f;
  const uint32_t sQw = sQ + wg * 64 * 128;  // this warpgroup's 64 rows
  const uint32_t sDOw = sDO + wg * 64 * 128;
  mbar_wait(qbar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int k0 = it * kKeys;
    const uint32_t sK = sKV0 + 2 * stage * L::kTileKV;
    const uint32_t sV = sK + L::kTileKV;
    mbar_wait(bar + 8 * stage, parity);

    if (k0 <= wg_last) {  // uniform across the warpgroup
      // S = Q . K^T and dP = dO . V^T over DP in k16 steps
      float s[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t offq = (kk / 4) * L::kChunkQ + (kk % 4) * 32;
        const uint32_t offk = (kk / 4) * L::kChunkKV + (kk % 4) * 32;
        wgmma_ss_n32(s, desc(sQw + offq, 16, 1024), desc(sK + offk, 16, 1024),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t offq = (kk / 4) * L::kChunkQ + (kk % 4) * 32;
        const uint32_t offk = (kk / 4) * L::kChunkKV + (kk % 4) * 32;
        wgmma_ss_n32(dp, desc(sDOw + offq, 16, 1024),
                     desc(sV + offk, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P and dS on the fragments (rows queries, columns keys)
      const bool mask = k0 + kKeys > sk ||
                        (causal && k0 + kKeys - 1 > i0 + wg * 64 + offset);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool hi = (i & 2) != 0;
        float p = exp2f(fmaf(s[i], scale_log2, hi ? -l_hi : -l_lo));
        if (mask) {
          const int key = k0 + 8 * (i / 4) + cq + (i & 1);
          const int row = hi ? row_hi : row_lo;
          if (key >= sk || (causal && key > row + offset)) p = 0.f;
        }
        s[i] = p * (dp[i] - (hi ? d_hi : d_lo)) * scale;
      }

      // dQ += dS . K over the 32 keys in k16 steps, dS rounded to bf16: N
      // 128 from K's chunks 0-1, N DP - 128 from chunk 2 on
      uint32_t sa[2][4];
      acc_to_a<16>(s, sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t sKk = sK + kk * 16 * 128;
        wgmma_rs<128>(acc0, sa[kk], desc(sKk, L::kChunkKV, 1024));
        wgmma_rs<N1>(acc1, sa[kk],
                     desc(sKk + 2 * L::kChunkKV, L::kChunkKV, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
    }

    // release the stage; thread 0 refills it with tile it + kStages once
    // all 256 threads are done with it
    mbar_arrive(bar + 8 * (kStages + stage));
    if (tid == 0 && it + kStages < n_tiles) {
      mbar_wait(bar + 8 * (kStages + stage), parity);
      load_kv(stage, it + kStages);
    }
    __syncwarp();
  }

  // d > 128: every column of acc0 lies below d
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = (i & 2) ? row_hi : row_lo;
    if (row < sq) {
      const int col = 8 * (i / 4) + cq;
      *reinterpret_cast<__nv_bfloat162*>(dq + (rbase + row) * d + col) =
          __floats2bfloat162_rn(acc0[i], acc0[i + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < N1 / 2; i += 2) {
    const int row = (i & 2) ? row_hi : row_lo;
    // d is a multiple of 8: an 8-column group lies wholly below d or not
    if (row < sq && 128 + 8 * (i / 4) < d) {
      const int col = 128 + 8 * (i / 4) + cq;
      *reinterpret_cast<__nv_bfloat162*>(dq + (rbase + row) * d + col) =
          __floats2bfloat162_rn(acc1[i], acc1[i + 1]);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int bh, int sq,
           int sk, int d, int offset, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = WideDqLayout<DP>::kSmem;
  if (const cudaError_t e =
          allow_smem(flash_bwd_dq_sm90_wide_kernel<DP>, smem))
    return (int)e;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, bh, sq, d, kRows) ||
      !make_map(&tk, k, bh, sk, d, kKeys) ||
      !make_map(&tv, v, bh, sk, d, kKeys) ||
      !make_map(&tdo, dout, bh, sq, d, kRows))
    return kMapRefused;
  const dim3 grid((unsigned)((sq + kRows - 1) / kRows), (unsigned)bh);
  flash_bwd_dq_sm90_wide_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, (__nv_bfloat16*)dq, sq, sk, d, offset,
      causal, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// The instances for hd a multiple of 8 from 136 to 256, called by
// pt_flash_attention_bwd_dq_sm90 (flash_bwd_dq_sm90.cu), which has checked
// hd and bh * sq; its contract otherwise.
int flash_bwd_dq_sm90_wide(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int bh, int sq,
                           int sk, int hd, int offset, int causal,
                           float scale, cudaStream_t st) {
  switch ((hd + 15) / 16) {  // the instance of DP = ceil16(hd)
    case 9: return launch<144>(q, k, v, dout, lse, delta, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 10: return launch<160>(q, k, v, dout, lse, delta, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 11: return launch<176>(q, k, v, dout, lse, delta, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 12: return launch<192>(q, k, v, dout, lse, delta, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 13: return launch<208>(q, k, v, dout, lse, delta, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 14: return launch<224>(q, k, v, dout, lse, delta, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 15: return launch<240>(q, k, v, dout, lse, delta, dq, bh, sq, sk, hd, offset, causal, scale, st);
    default: return launch<256>(q, k, v, dout, lse, delta, dq, bh, sq, sk, hd, offset, causal, scale, st);
  }
}

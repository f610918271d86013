// Flash-attention dQ backward on Hopper's tensor cores (sm_90a): bf16
// inputs, any head dim d that is a multiple of 8 from 8 to 128, fp32
// accumulation; the entry point also takes 136 to 256, which
// flash_bwd_dq_sm90_wide.cu's instances serve (32-key tiles: see there).
//
// Replaces the TPU kernel `_bwd_dq_kernel` (paddle_tpu/kernels/
// flash_attention.py:206, launched by `_flash_bwd` at :296) for the inputs it
// takes; fp32 has its own tensor-core kernel (flash_bwd_dq_tf32x3.cu), and
// other head dims (d % 8 != 0, fp32 above 128) stay on the CUDA-core kernel
// of flash_attention_bwd.cu.
// Same function, from the same inputs as the dK/dV kernel
// (flash_bwd_dkv_sm90.cu): q, dO [bh, sq, d], k, v [bh, sk, d] and fp32 lse,
// delta = rowsum(dO*O) - dlse [bh, sq]. For every visible pair (i, j)
// (j <= i + offset under `causal`)
//   p_ij = exp(scale q_i.k_j - lse_i),  dp_ij = dO_i.v_j,
//   ds_ij = p_ij (dp_ij - delta_i) scale,   dQ_i += ds_ij k_j.
// Masked pairs give exactly 0 (p is selected to 0 before any use), so a row
// that sees no key (lse -1e30) gets dQ = 0. ds is computed in fp32 and
// rounded to bf16 as the A operand of dS.K (the TPU kernel keeps it in fp32:
// `sm90_dq_bound` in flash_attention.py counts that rounding).
//
// What bounds it on the H100: operations (6 d FLOPs per visible pair: S,
// dP and dS.K; causal 2048 at d 128 is some 700 FLOPs per byte moved).
//
// What the design does about it: all three products run as wgmma on the
// tensor cores, the mirror image of the dK/dV kernel. One block of two
// warpgroups per (bh, tile of 128 query rows); each warpgroup owns 64 rows.
// Q and dO are loaded once by TMA; dQ is an fp32 accumulator in registers.
// K and V tiles of 64 keys stream through a 2-stage TMA ring (128-byte
// swizzle, "full" / "empty" mbarriers, thread 0 issuing the loads). Per key
// tile and warpgroup:
//   S  = Q.K^T      wgmma m64n64k16, both operands K-major in shared memory;
//   dP = dO.V^T     the same;
//   P, dS           on the accumulator fragments in registers; each thread
//                   holds 2 query rows, so lse and delta are 2 + 2 registers;
//   dQ += dS.K      wgmma, dS the bf16 register A operand, K read MN-major
//                   (keys down the rows, the transpose bit set).
// Under causal the key loop stops at the block's last visible key (the TPU
// kernel's skip at :241-246), a warpgroup skips the tiles that none of its
// rows sees, and only tiles on the diagonal or the ragged end of the keys
// pay for the mask. dQ is written once: no atomics, deterministic.
//
// Head dims, as in flash_bwd_dkv_sm90.cu: an instance for each padded width
// DP = ceil16(d), the real d at run time; ceil(DP / 64) 64-column chunks a
// tile, the columns past d zeros from TMA; S and dP run DP / 16 k16 steps,
// dQ accumulates at N = DP, and only the columns below d are written.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 128;  // query rows per block (two warpgroups of 64)
constexpr int kKeys = 64;   // keys per streamed K / V tile
constexpr int kThreads = 256;

template <int DP>
struct DqLayout {
  static constexpr int kChunks = (DP + 63) / 64;     // 64-column regions
  static constexpr uint32_t kChunkQ = kRows * 128;   // bytes of a Q/dO chunk
  static constexpr uint32_t kChunkKV = kKeys * 128;  // of a K/V chunk
  static constexpr uint32_t kQ = kChunks * kChunkQ;
  static constexpr uint32_t kTileKV = kChunks * kChunkKV;
  // [Q][dO][stage 0: K, V][stage 1: K, V][full[2] empty[2] q]
  static constexpr uint32_t kStages = 2 * kQ;
  static constexpr uint32_t kBars = kStages + 2 * 2 * kTileKV;
  static constexpr size_t kSmem = kBars + 64 + 1024;  // + alignment slack
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int sq, int sk,
                         int d, int offset, int causal, float scale,
                         float scale_log2) {
  using L = DqLayout<DP>;
  constexpr int C = L::kChunks;
  constexpr int NA = DP / 2;  // accumulator floats of dQ
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + L::kQ;
  const uint32_t sKV0 = sQ + L::kStages;  // stage s: K, then V
  const uint32_t bar = sQ + L::kBars;
  const uint32_t qbar = bar + 32;

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
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 16 + 8 * s, kThreads);
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
    for (int s = 0; s < 2 && s < n_tiles; ++s) load_kv(s, s);
  }
  __syncwarp();

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
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
    const int stage = it & 1;
    const uint32_t parity = (it >> 1) & 1;
    const int k0 = it * kKeys;
    const uint32_t sK = sKV0 + 2 * stage * L::kTileKV;
    const uint32_t sV = sK + L::kTileKV;
    mbar_wait(bar + 8 * stage, parity);

    if (k0 <= wg_last) {  // uniform across the warpgroup
      // S = Q . K^T and dP = dO . V^T over DP in k16 steps
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t offq = (kk / 4) * L::kChunkQ + (kk % 4) * 32;
        const uint32_t offk = (kk / 4) * L::kChunkKV + (kk % 4) * 32;
        wgmma_ss_n64(s, desc(sQw + offq, 16, 1024), desc(sK + offk, 16, 1024),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t offq = (kk / 4) * L::kChunkQ + (kk % 4) * 32;
        const uint32_t offk = (kk / 4) * L::kChunkKV + (kk % 4) * 32;
        wgmma_ss_n64(dp, desc(sDOw + offq, 16, 1024),
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
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i & 2) != 0;
        float p = exp2f(fmaf(s[i], scale_log2, hi ? -l_hi : -l_lo));
        if (mask) {
          const int key = k0 + 8 * (i / 4) + cq + (i & 1);
          const int row = hi ? row_hi : row_lo;
          if (key >= sk || (causal && key > row + offset)) p = 0.f;
        }
        s[i] = p * (dp[i] - (hi ? d_hi : d_lo)) * scale;
      }

      // dQ += dS . K over the 64 keys in k16 steps, dS rounded to bf16
      uint32_t sa[4][4];
      acc_to_a<32>(s, sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DP>(acc, sa[kk], desc(sK + kk * 16 * 128, L::kChunkKV, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
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
  for (int i = 0; i < NA; i += 2) {
    const int row = (i & 2) ? row_hi : row_lo;
    // d is a multiple of 8: an 8-column group lies wholly below d or not
    if (row < sq && 8 * (i / 4) < d) {
      const int col = 8 * (i / 4) + cq;
      *reinterpret_cast<__nv_bfloat162*>(dq + (rbase + row) * d + col) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int bh, int sq,
           int sk, int d, int offset, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = DqLayout<DP>::kSmem;
  if (const cudaError_t e = allow_smem(flash_bwd_dq_sm90_kernel<DP>, smem))
    return (int)e;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, bh, sq, d, kRows) ||
      !make_map(&tk, k, bh, sk, d, kKeys) ||
      !make_map(&tv, v, bh, sk, d, kKeys) ||
      !make_map(&tdo, dout, bh, sq, d, kRows))
    return kMapRefused;
  const dim3 grid((unsigned)((sq + kRows - 1) / kRows), (unsigned)bh);
  flash_bwd_dq_sm90_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, (__nv_bfloat16*)dq, sq, sk, d, offset,
      causal, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// hd a multiple of 8 from 136 to 256 (flash_bwd_dq_sm90_wide.cu)
int flash_bwd_dq_sm90_wide(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int bh, int sq,
                           int sk, int hd, int offset, int causal,
                           float scale, cudaStream_t st);

// bf16 q, dout, dq [bh, sq, hd]; k, v [bh, sk, hd]; lse, delta [bh, sq]
// fp32; hd a multiple of 8 from 8 to 256; every bf16 pointer 16-byte
// aligned (TMA). Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a head dim the kernel does not take, or
// kMapRefused (-1) for a tensor map that cuTensorMapEncodeTiled refuses.
extern "C" int pt_flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
    int hd, int offset, int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hd % 8 != 0 || hd < 8 || hd > 256) return (int)cudaErrorInvalidValue;
  if (bh * sq == 0) return (int)cudaGetLastError();
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (hd > 128)
    return flash_bwd_dq_sm90_wide(q, k, v, dout, l, dl, dq, bh, sq, sk, hd,
                                  offset, causal, scale, st);
  switch ((hd + 15) / 16) {  // the instance of DP = ceil16(hd)
    case 1: return launch<16>(q, k, v, dout, l, dl, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 2: return launch<32>(q, k, v, dout, l, dl, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 3: return launch<48>(q, k, v, dout, l, dl, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 4: return launch<64>(q, k, v, dout, l, dl, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 5: return launch<80>(q, k, v, dout, l, dl, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 6: return launch<96>(q, k, v, dout, l, dl, dq, bh, sq, sk, hd, offset, causal, scale, st);
    case 7: return launch<112>(q, k, v, dout, l, dl, dq, bh, sq, sk, hd, offset, causal, scale, st);
    default: return launch<128>(q, k, v, dout, l, dl, dq, bh, sq, sk, hd, offset, causal, scale, st);
  }
}

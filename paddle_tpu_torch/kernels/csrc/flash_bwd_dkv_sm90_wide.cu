// Flash-attention dK/dV backward on Hopper's tensor cores (sm_90a) at the
// head dims above 128: bf16 inputs, any head dim d that is a multiple of 8
// from 136 to 256 (Gemma 2B's and GPT-J's 256), fp32 accumulation.
// flash_bwd_dkv_sm90.cu keeps d <= 128 and hands the rest to this file.
//
// Replaces the TPU kernel `_bwd_dkv_kernel` (paddle_tpu/kernels/
// flash_attention.py:154, launched by `_flash_bwd` at :268) for those inputs;
// the function is flash_bwd_dkv_sm90.cu's: for every visible pair (i, j)
//   p_ij = exp(scale q_i.k_j - lse_i),  dp_ij = dO_i.v_j,
//   ds_ij = p_ij (dp_ij - delta_i) scale,
//   dV_j += p_ij dO_i,  dK_j += ds_ij q_i,
// masked pairs exactly 0, p and ds rounded to bf16 as the A operands of the
// two accumulating products. dQ above 128 stays on the CUDA-core kernel of
// flash_attention_bwd.cu.
//
// What bounds it on the H100: operations (8 d FLOPs per visible pair).
//
// What bounds the design: registers and shared memory. The d <= 128 kernel
// gives each warpgroup 64 keys and holds their dK and dV as fp32
// accumulators: 2 x 64 x 256 / 128 = 256 registers a thread at d 256, past
// the limit of 255 before S^T and dP^T are counted. And K and V at 128 keys
// take 128 KB at d 256, two stages of Q and dO at 64 rows another 128 KB.
//
// What the design does about it: each warpgroup owns a column half of both
// dK and dV for the block's 64 keys: warpgroup 0 columns 0 ..
// 127, warpgroup 1 columns 128 .. DP - 1, so a thread holds 2 x 64 fp32
// accumulators at most, the d 128 kernel's budget. Both warpgroups compute
// the whole S^T and dP^T of the 64 keys (so 12 d FLOPs a pair where the
// function needs 8 d): no exchange between them, no named barriers, the P^T
// and dS^T fragments stay in each warpgroup's registers as A operands, and
// dK and dV are still written once at the end (no atomics, deterministic).
// Against splitting dK from dV between the warpgroups, which does 8 d (or
// 10 d, recomputing S^T) and passes P^T and dS^T through shared memory, this
// is the simplest that fits; its tensor-core work is 1.5x the function's.
// Shared memory: K and V of the 64 keys 32 KB each at d 256, loaded once;
// Q and dO tiles of 64 rows through a 2-stage TMA ring, 128 KB; ~192 KB.
// Beside each stage's Q and dO, warp 0 stages the tile's lse (in log2
// units) and delta (512 bytes), which every thread then reads from shared
// memory: held in 32 registers a thread through the products, as the
// d <= 128 kernel holds them, they push the accumulators past 255
// registers into local memory (ptxas: up to 112 bytes of spills).
// Per query tile and warpgroup:
//   S^T  = K.Q^T     wgmma m64n64k16 over DP / 16 k16 steps, K-major;
//   dP^T = V.dO^T    the same;
//   P^T, dS^T        on the fragments in registers, with the staged lse and
//                    delta of the fragment's query columns;
//   dV  += P^T.dO    wgmma over this warpgroup's columns of dO (MN-major,
//                    from its first 64-column chunk, LBO to the next);
//   dK  += dS^T.Q    the same with Q.
// The query loop starts at the first tile that sees key j0 (the TPU kernel's
// skip at :193-195).
//
// Head dims: an instance for each padded width DP = ceil16(d) (144, 160, ..,
// 256), the real d at run time; ceil(DP / 64) 64-column chunks a tile, the
// columns past d zeros from TMA; only the columns below d are written.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kKeys = 64;  // keys per block, both warpgroups
constexpr int kRows = 64;  // query rows per streamed tile
constexpr int kThreads = 256;

template <int DP>
struct WideDkvLayout {
  static_assert(DP > 128 && DP <= 256 && DP % 16 == 0, "DP: 144, .., 256");
  static constexpr int kChunks = (DP + 63) / 64;     // 64-column regions
  static constexpr uint32_t kChunkKV = kKeys * 128;  // bytes of a K/V chunk
  static constexpr uint32_t kChunkQ = kRows * 128;   // of a Q/dO chunk
  static constexpr uint32_t kKV = kChunks * kChunkKV;
  static constexpr uint32_t kTileQ = kChunks * kChunkQ;
  // [K][V][stage 0: Q, dO][stage 1: Q, dO][stage 0, 1: lse, delta]
  // [full[2] empty[2] kv]
  static constexpr uint32_t kStages = 2 * kKV;
  static constexpr uint32_t kStats = kStages + 2 * 2 * kTileQ;
  static constexpr uint32_t kBars = kStats + 2 * 2 * kRows * 4;
  static constexpr size_t kSmem = kBars + 64 + 1024;  // + alignment slack
};

// What a warpgroup's loop reads: the shared-memory regions (`stats`: each
// stage's lse in log2 units, then delta, kRows floats each), the barriers,
// the block's keys and the query tiles it walks.
struct DkvBlock {
  uint32_t sK, sV, sQ0, bar;
  const float* stats;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b, j0, sq, sk, d, offset, causal, t0, n_it;
  float scale, scale_log2;
};

// The query loop and the epilogue of one warpgroup, which accumulates the N
// columns of dK and dV from 64-column chunk C0 on; warp 0 (warpgroup 0)
// also refills the ring through `load_q`.
template <int DP, int C0, int N, typename LoadQ>
__device__ __forceinline__ void dkv_columns(const DkvBlock& k, LoadQ load_q) {
  using L = WideDkvLayout<DP>;
  const int tid = threadIdx.x;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int key_lo = k.j0 + warp * 16 + lane / 4;  // d[i], i % 4 < 2
  const int key_hi = key_lo + 8;                   // d[i], i % 4 >= 2
  const int cq = 2 * (lane % 4);
  const uint32_t col_off = C0 * L::kChunkQ;  // this warpgroup's columns

  float dka[N / 2], dva[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < k.n_it; ++it) {
    const int stage = it & 1;
    const uint32_t parity = (it >> 1) & 1;
    const int i0 = (k.t0 + it) * kRows;
    const uint32_t sQ = k.sQ0 + 2 * stage * L::kTileQ;
    const uint32_t sDO = sQ + L::kTileQ;
    const float* sl = k.stats + stage * 2 * kRows;  // lse log2 e, delta
    mbar_wait(k.bar + 8 * stage, parity);

    // S^T = K . Q^T and dP^T = V . dO^T over DP in k16 steps
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kChunkKV + (kk % 4) * 32;
      const uint32_t offq = (kk / 4) * L::kChunkQ + (kk % 4) * 32;
      wgmma_ss_n64(st, desc(k.sK + off, 16, 1024), desc(sQ + offq, 16, 1024),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kChunkKV + (kk % 4) * 32;
      const uint32_t offq = (kk / 4) * L::kChunkQ + (kk % 4) * 32;
      wgmma_ss_n64(dpt, desc(k.sV + off, 16, 1024),
                   desc(sDO + offq, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T on the fragments (rows keys, columns queries)
    const bool mask = i0 + kRows > k.sq || k.j0 + kKeys > k.sk ||
                      (k.causal && k.j0 + kKeys - 1 > i0 + k.offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + cq + (i & 1);  // the query within the tile
      float p = exp2f(fmaf(st[i], k.scale_log2, -sl[c]));
      if (mask) {
        const int key = (i & 2) ? key_hi : key_lo;
        const int qi = i0 + c;
        if (qi >= k.sq || key >= k.sk || (k.causal && key > qi + k.offset))
          p = 0.f;
      }
      st[i] = p;
      dpt[i] = p * (dpt[i] - sl[kRows + c]) * k.scale;
    }

    // dV += P^T . dO and dK += dS^T . Q over the 64 queries in k16 steps,
    // on this warpgroup's N columns
    uint32_t pa[4][4], sa[4][4];
    acc_to_a<32>(st, pa);
    acc_to_a<32>(dpt, sa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t at = col_off + kk * 16 * 128;
      wgmma_rs<N>(dva, pa[kk], desc(sDO + at, L::kChunkQ, 1024));
      wgmma_rs<N>(dka, sa[kk], desc(sQ + at, L::kChunkQ, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);

    // release the stage; warp 0 refills it with tile it + 2 once all 256
    // threads are done with it
    mbar_arrive(k.bar + 16 + 8 * stage);
    if (tid < 32 && it + 2 < k.n_it) {
      mbar_wait(k.bar + 16 + 8 * stage, parity);
      load_q(stage, k.t0 + it + 2);
    }
    __syncwarp();
  }

  const size_t kbase = (size_t)k.b * k.sk;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int key = (i & 2) ? key_hi : key_lo;
    const int col = 64 * C0 + 8 * (i / 4);
    // d is a multiple of 8: an 8-column group lies wholly below d or not
    if (key < k.sk && col < k.d) {
      const size_t at = (kbase + key) * k.d + col + cq;
      *reinterpret_cast<__nv_bfloat162*>(k.dk + at) =
          __floats2bfloat162_rn(dka[i], dka[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(k.dv + at) =
          __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int sq, int sk,
                               int d, int offset, int causal, float scale,
                               float scale_log2) {
  using L = WideDkvLayout<DP>;
  constexpr int C = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  DkvBlock k;
  k.sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  k.sV = k.sK + L::kKV;
  k.sQ0 = k.sK + L::kStages;  // stage s: Q at + 2 s kTileQ, dO after it
  k.bar = k.sK + L::kBars;
  const uint32_t kvbar = k.bar + 32;
  float* const stats =
      reinterpret_cast<float*>(smem_raw + (k.sK + L::kStats - smem_u32(smem_raw)));
  k.stats = stats;
  k.dk = dk;
  k.dv = dv;
  k.b = blockIdx.y;
  k.j0 = blockIdx.x * kKeys;
  k.sq = sq;
  k.sk = sk;
  k.d = d;
  k.offset = offset;
  k.causal = causal;
  k.scale = scale;
  k.scale_log2 = scale_log2;
  // the first query tile that can see key j0; earlier rows see none
  k.t0 = (causal ? max(0, k.j0 - offset) : 0) / kRows;
  k.n_it = max(0, (sq + kRows - 1) / kRows - k.t0);
  const int tid = threadIdx.x, lane = tid % 32;

  const CUtensorMap* mq = &tq;
  const CUtensorMap* mdo = &tdo;
  const uint32_t sQ0 = k.sQ0, bar = k.bar;
  const int b = k.b;
  const size_t rbase = (size_t)b * sq;
  // called by the 32 lanes of warp 0: the tile's lse (in log2 units) and
  // delta into the stage (0 past sq), then lane 0's TMA loads of its Q and
  // dO, whose arrival on "full" also publishes the lanes' stores
  auto load_q = [=](int stage, int tile) {
    float* sl = stats + stage * 2 * kRows;
    for (int r = lane; r < kRows; r += 32) {
      const int i = tile * kRows + r;
      sl[r] = i < sq ? lse[rbase + i] * kLog2e : 0.f;
      sl[kRows + r] = i < sq ? delta[rbase + i] : 0.f;
    }
    __syncwarp();
    if (lane != 0) return;
    const uint32_t full = bar + 8 * stage;
    const uint32_t sQ = sQ0 + 2 * stage * L::kTileQ;
    mbar_expect_tx(full, 2 * L::kTileQ);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tma_load(sQ + c * L::kChunkQ, mq, full, 64 * c, tile * kRows, b);
      tma_load(sQ + L::kTileQ + c * L::kChunkQ, mdo, full, 64 * c,
               tile * kRows, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 16 + 8 * s, kThreads);
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kvbar, 2 * L::kKV);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tma_load(k.sK + c * L::kChunkKV, &tk, kvbar, 64 * c, k.j0, b);
      tma_load(k.sV + c * L::kChunkKV, &tv, kvbar, 64 * c, k.j0, b);
    }
  }
  if (tid < 32)
    for (int s = 0; s < 2 && s < k.n_it; ++s) load_q(s, k.t0 + s);
  __syncwarp();
  mbar_wait(kvbar, 0);

  // warpgroup 0: columns 0 .. 127 (chunks 0-1); warpgroup 1: 128 .. DP - 1
  if (tid < 128)
    dkv_columns<DP, 0, 128>(k, load_q);
  else
    dkv_columns<DP, 2, DP - 128>(k, load_q);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int bh,
           int sq, int sk, int d, int offset, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = WideDkvLayout<DP>::kSmem;
  if (const cudaError_t e =
          allow_smem(flash_bwd_dkv_sm90_wide_kernel<DP>, smem))
    return (int)e;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, bh, sq, d, kRows) ||
      !make_map(&tk, k, bh, sk, d, kKeys) ||
      !make_map(&tv, v, bh, sk, d, kKeys) ||
      !make_map(&tdo, dout, bh, sq, d, kRows))
    return kMapRefused;
  const dim3 grid((unsigned)((sk + kKeys - 1) / kKeys), (unsigned)bh);
  flash_bwd_dkv_sm90_wide_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      sq, sk, d, offset, causal, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// The instances for hd a multiple of 8 from 136 to 256, called by
// pt_flash_attention_bwd_dkv_sm90 (flash_bwd_dkv_sm90.cu), which has checked
// hd and bh * sk; its contract otherwise.
int flash_bwd_dkv_sm90_wide(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int bh,
                            int sq, int sk, int hd, int offset, int causal,
                            float scale, cudaStream_t st) {
  switch ((hd + 15) / 16) {  // the instance of DP = ceil16(hd)
    case 9: return launch<144>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 10: return launch<160>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 11: return launch<176>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 12: return launch<192>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 13: return launch<208>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 14: return launch<224>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 15: return launch<240>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    default: return launch<256>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
  }
}

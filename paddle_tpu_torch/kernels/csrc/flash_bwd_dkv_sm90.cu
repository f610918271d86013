// Flash-attention dK/dV backward on Hopper's tensor cores (sm_90a): bf16
// inputs, any head dim d that is a multiple of 8 from 8 to 128, fp32
// accumulation. The entry point also takes d from 136 to 256, which
// flash_bwd_dkv_sm90_wide.cu's instances serve (a column half of dK and dV
// a warpgroup: see there).
//
// Replaces the TPU kernel `_bwd_dkv_kernel` (paddle_tpu/kernels/
// flash_attention.py:154, launched by `_flash_bwd` at :268) for the inputs it
// takes; fp32 has its own tensor-core kernel (flash_bwd_dkv_tf32x3.cu), and
// other head dims stay on the CUDA-core kernel of flash_attention_bwd.cu.
// dQ (`_bwd_dq_kernel`, :206) is flash_bwd_dq_sm90.cu's. Same function,
// from q, dO [bh, sq, d], k, v [bh, sk, d] and fp32 lse, delta = rowsum(dO*O)
// - dlse [bh, sq]: for every visible pair (i, j) (j <= i + offset under
// `causal`)
//   p_ij = exp(scale q_i.k_j - lse_i),  dp_ij = dO_i.v_j,
//   ds_ij = p_ij (dp_ij - delta_i) scale,
//   dV_j += p_ij dO_i,  dK_j += ds_ij q_i.
// Masked pairs give exactly 0 (p is selected to 0 before any use), so a row
// that sees no key adds nothing. p and ds are computed in fp32 and rounded
// to bf16 as the A operands of the two accumulating products (the TPU
// kernel keeps them in fp32: the tolerance in chip_smoke.py and the tests
// counts that rounding).
//
// What bounds it on the H100: operations (8 d FLOPs per visible pair).
//
// What the design does about it: all four products run as wgmma on the
// tensor cores. One block of two warpgroups per (bh, tile of 128 keys);
// each warpgroup owns 64 keys. K and V are loaded once by TMA; dK and dV
// are fp32 accumulators in registers. The block loops over query tiles of
// 64 rows from max(0, j0 - offset) (the TPU kernel's skip at :193-195);
// Q and dO stream through a 2-stage TMA ring (128-byte swizzle, mbarriers).
// Per query tile and warpgroup:
//   S^T  = K.Q^T     wgmma m64n64k16, both K-major in shared memory;
//   dP^T = V.dO^T    the same;
//   P^T, dS^T        on the accumulator fragments in registers, with lse and
//                    delta of the fragment's query columns;
//   dV  += P^T.dO    wgmma, P^T the bf16 register A operand, dO MN-major;
//   dK  += dS^T.Q    the same with Q.
// dK and dV are written once at the end: no atomics, deterministic.
//
// Head dims, as in flash_fwd_sm90.cu: an instance for each padded width
// DP = ceil16(d), the real d at run time; ceil(DP / 64) 64-column chunks a
// tile, the columns past d zeros from TMA; S^T and dP^T run DP / 16 k16
// steps, dV and dK accumulate at N = DP, and only the columns below d are
// written.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kKeys = 128;  // keys per block (two warpgroups of 64)
constexpr int kRows = 64;   // query rows per streamed tile
constexpr int kThreads = 256;

template <int DP>
struct DkvLayout {
  static constexpr int kChunks = (DP + 63) / 64;     // 64-column regions
  static constexpr uint32_t kChunkKV = kKeys * 128;  // bytes of a K/V chunk
  static constexpr uint32_t kChunkQ = kRows * 128;   // of a Q/dO chunk
  static constexpr uint32_t kKV = kChunks * kChunkKV;
  static constexpr uint32_t kTileQ = kChunks * kChunkQ;
  // [K][V][stage 0: Q, dO][stage 1: Q, dO][full[2] empty[2] kv]
  static constexpr uint32_t kStages = 2 * kKV;
  static constexpr uint32_t kBars = kStages + 2 * 2 * kTileQ;
  static constexpr size_t kSmem = kBars + 64 + 1024;  // + alignment slack
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int sq, int sk,
                          int d, int offset, int causal, float scale,
                          float scale_log2) {
  using L = DkvLayout<DP>;
  constexpr int C = L::kChunks;
  constexpr int NA = DP / 2;  // accumulator floats of dK (and of dV)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + L::kKV;
  const uint32_t sQ0 = sK + L::kStages;  // stage s: Q at + 2 s kTileQ, dO after
  const uint32_t bar = sK + L::kBars;
  const uint32_t kvbar = bar + 32;

  const int b = blockIdx.y;
  const int j0 = blockIdx.x * kKeys;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int key_lo = j0 + wg * 64 + warp * 16 + lane / 4;  // d[i], i % 4 < 2
  const int key_hi = key_lo + 8;                           // d[i], i % 4 >= 2
  const int cq = 2 * (lane % 4);

  // the first query tile that can see key j0; earlier rows see none
  const int t0 = (causal ? max(0, j0 - offset) : 0) / kRows;
  const int n_it = max(0, (sq + kRows - 1) / kRows - t0);

  const CUtensorMap* mq = &tq;
  const CUtensorMap* mdo = &tdo;
  auto load_q = [=](int stage, int tile) {
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
      tma_load(sK + c * L::kChunkKV, &tk, kvbar, 64 * c, j0, b);
      tma_load(sV + c * L::kChunkKV, &tv, kvbar, 64 * c, j0, b);
    }
    for (int s = 0; s < 2 && s < n_it; ++s) load_q(s, t0 + s);
  }
  __syncwarp();

  float dka[NA], dva[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t sKw = sK + wg * 64 * 128;  // this warpgroup's 64 keys
  const uint32_t sVw = sV + wg * 64 * 128;
  const size_t rbase = (size_t)b * sq;
  mbar_wait(kvbar, 0);

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    const uint32_t parity = (it >> 1) & 1;
    const int i0 = (t0 + it) * kRows;
    const uint32_t sQ = sQ0 + 2 * stage * L::kTileQ;
    const uint32_t sDO = sQ + L::kTileQ;
    mbar_wait(bar + 8 * stage, parity);

    // S^T = K . Q^T and dP^T = V . dO^T over DP in k16 steps
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kChunkKV + (kk % 4) * 32;
      const uint32_t offq = (kk / 4) * L::kChunkQ + (kk % 4) * 32;
      wgmma_ss_n64(st, desc(sKw + off, 16, 1024), desc(sQ + offq, 16, 1024),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kChunkKV + (kk % 4) * 32;
      const uint32_t offq = (kk / 4) * L::kChunkQ + (kk % 4) * 32;
      wgmma_ss_n64(dpt, desc(sVw + off, 16, 1024),
                   desc(sDO + offq, 16, 1024), kk > 0);
    }
    wgmma_commit();
    // lse (in log2 units) and delta of this thread's 16 query columns,
    // fetched while the products run
    float lq[16], dq[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int i = i0 + 8 * (c / 2) + cq + (c & 1);
      lq[c] = i < sq ? lse[rbase + i] * kLog2e : 0.f;
      dq[c] = i < sq ? delta[rbase + i] : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T on the fragments (rows keys, columns queries)
    const bool mask = i0 + kRows > sq || j0 + kKeys > sk ||
                      (causal && j0 + wg * 64 + 63 > i0 + offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 2 * (i / 4) + (i & 1);
      float p = exp2f(fmaf(st[i], scale_log2, -lq[c]));
      if (mask) {
        const int key = (i & 2) ? key_hi : key_lo;
        const int qi = i0 + 8 * (i / 4) + cq + (i & 1);
        if (qi >= sq || key >= sk || (causal && key > qi + offset)) p = 0.f;
      }
      st[i] = p;
      dpt[i] = p * (dpt[i] - dq[c]) * scale;
    }

    // dV += P^T . dO and dK += dS^T . Q over the 64 queries in k16 steps
    uint32_t pa[4][4], sa[4][4];
    acc_to_a<32>(st, pa);
    acc_to_a<32>(dpt, sa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<DP>(dva, pa[kk], desc(sDO + kk * 16 * 128, L::kChunkQ, 1024));
      wgmma_rs<DP>(dka, sa[kk], desc(sQ + kk * 16 * 128, L::kChunkQ, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);

    // release the stage; thread 0 refills it with tile it + 2 once all 256
    // threads are done with it
    mbar_arrive(bar + 16 + 8 * stage);
    if (tid == 0 && it + 2 < n_it) {
      mbar_wait(bar + 16 + 8 * stage, parity);
      load_q(stage, t0 + it + 2);
    }
    __syncwarp();
  }

  const size_t kbase = (size_t)b * sk;
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int key = (i & 2) ? key_hi : key_lo;
    // d is a multiple of 8: an 8-column group lies wholly below d or not
    if (key < sk && 8 * (i / 4) < d) {
      const size_t at = (kbase + key) * d + 8 * (i / 4) + cq;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[i], dka[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int bh,
           int sq, int sk, int d, int offset, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = DkvLayout<DP>::kSmem;
  if (const cudaError_t e = allow_smem(flash_bwd_dkv_sm90_kernel<DP>, smem))
    return (int)e;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, bh, sq, d, kRows) ||
      !make_map(&tk, k, bh, sk, d, kKeys) ||
      !make_map(&tv, v, bh, sk, d, kKeys) ||
      !make_map(&tdo, dout, bh, sq, d, kRows))
    return kMapRefused;
  const dim3 grid((unsigned)((sk + kKeys - 1) / kKeys), (unsigned)bh);
  flash_bwd_dkv_sm90_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      sq, sk, d, offset, causal, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// hd a multiple of 8 from 136 to 256 (flash_bwd_dkv_sm90_wide.cu)
int flash_bwd_dkv_sm90_wide(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int bh,
                            int sq, int sk, int hd, int offset, int causal,
                            float scale, cudaStream_t st);

// bf16 q, dout [bh, sq, hd]; k, v, dk, dv [bh, sk, hd]; lse, delta [bh, sq]
// fp32; hd a multiple of 8 from 8 to 256; every bf16 pointer 16-byte
// aligned (TMA). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a head dim
// the kernel does not take, or kMapRefused (-1) for a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int pt_flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
    int sk, int hd, int offset, int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hd % 8 != 0 || hd < 8 || hd > 256) return (int)cudaErrorInvalidValue;
  if (bh * sk == 0) return (int)cudaGetLastError();
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (hd > 128)
    return flash_bwd_dkv_sm90_wide(q, k, v, dout, l, dl, dk, dv, bh, sq, sk,
                                   hd, offset, causal, scale, st);
  switch ((hd + 15) / 16) {  // the instance of DP = ceil16(hd)
    case 1: return launch<16>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 2: return launch<32>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 3: return launch<48>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 4: return launch<64>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 5: return launch<80>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 6: return launch<96>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    case 7: return launch<112>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
    default: return launch<128>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, hd, offset, causal, scale, st);
  }
}

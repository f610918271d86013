// Fused multi-tensor optimizer update for Hopper (sm_90a): gradient
// clipping, coupled or decoupled weight decay and the rule of every
// optimizer of the JAX package over every parameter of a step in a few
// launches, and GradScaler's check_finite_and_unscale.
//
// Replaces what XLA fuses for the JAX package: `Optimizer._get_fused`
// (paddle_tpu/optimizer/optimizer.py:117-147) over `Adam._rule` (:265-276),
// `Adafactor._rule` (:443-473), the rules of SGD, Momentum, Adagrad,
// Adamax, RMSProp and Adadelta (:212-332, 476-498; section (e)) and of Lamb
// and LarsMomentum (:335-407; section (f)), with the clips of
// paddle_tpu/nn/clip.py (:22-52) applied first; and the jitted finiteness
// test and unscale of paddle_tpu/amp/grad_scaler.py:21-67 (section (g)).
// No Pallas kernel exists for any of them: the TPU gets the fusion from
// XLA's jit of one function over all parameters.
//
// The chunk table (built by paddle_tpu_torch/kernels/optimizer.py when the
// step's tensors change, copied to the device from pinned memory on the
// stream):
//   words [0, 3): int32 view [lr as fp32 bits, step, n_tensors, n_chunks,
//                 skip, 0]
//   then n_tensors entries of kTensorWords int64 (pointers, sizes, flags)
//   then n_chunks chunk words: tensor << 40 | chunk index in the tensor
//   then n_matrices matrix words (Adafactor): tensor << 40 | leading index
// A chunk is a contiguous element range: kSpan elements of a flat tensor,
// or a tile of kSpan whole rows of one [R, C] matrix of a factored one
// (Adafactor's tensors of 2+ dimensions; rows are over the last axis).
// One block takes one chunk. The learning rate and the step are read from
// the table on the device, and Adam's bias corrections 1 - b^t and
// Adafactor's 1 - t^-decay are computed here from the step, in fp32 as the
// JAX package takes them (`Adam._rule`, optimizer.py:270-272): nothing that
// changes from step to step is a kernel argument. The host rewrites the
// header alone before each step (or each replay of a CUDA graph that
// captured these launches), and the rest of the table only when a pointer
// changes. A step whose skip and count live on the device (the in-graph
// GradScaler: an update skipped where a gradient was not finite, Adam's t
// the count of updates applied) has the two header words written from
// device tensors on the stream, after the host's copy and before these
// kernels (kernels/optimizer.py StepBatch.bind_device_step). Every kernel
// that writes a parameter or a state returns at once where the skip word
// is set; the sums of squares, the finiteness test and the unscale run
// whatever it says. The host writes skip 0, so a step without a device
// flag runs as before.
//
// A gradient has its parameter's dtype, or is fp32 beside a bf16 parameter
// (kGradF32: the fp32 sums of TrainStep.accumulate). Such a gradient is
// clipped in fp32 and then rounded to bf16, as the reference's updater
// (paddle_tpu/jit/__init__.py:105-110) casts g to p's dtype after the clip.
//
// Rounding follows the JAX package's order (and the plain versions in
// kernels/optimizer.py, which the card tests hold these kernels to): each
// fp32 operation is rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn,
// so nvcc contracts nothing into an FMA); the clip's product is rounded to
// the gradient's dtype, then to the parameter's, the coupled decay g +
// wd p is taken in the parameter's dtype (wd a constant of that dtype, as
// the JAX package takes a Python float beside p), and p, m, v are each
// cast back to their dtype after the rule; the decoupled decay subtracts
// bf16(lr * wd * p_old) from the rounded new p.
//
// Sums across blocks take a second pass in a fixed order, never atomics,
// so two runs give the same bits: the clip's per-tensor sums of squares
// and their global sum (pt_opt_sumsq, 2 launches), Adafactor's column sums,
// mean(vr) and parameter sum of squares (pt_opt_adafactor_stats, 2
// launches), and its per-tensor sum of u^2, which every block of the apply
// pass re-sums from the first pass's partials in the same order
// (pt_opt_adafactor_update, 2 launches), and Lamb's and LARS's per-tensor
// norms, whose fp64 chunk partials every block of the update pass re-sums
// in the same order (pt_opt_norm_rule, 2 launches). pt_opt_adam and
// pt_opt_rule are one launch; the unscale is a check (one launch, a flag
// any block may set) and, where the host finds the flag clear, one more.
//
// What bounds it on the H100: bytes. AdamW reads p, g, m, v and writes p,
// m, v (14 B per bf16 parameter: 4.84 ms for 1.16B parameters at 3.35
// TB/s; 16 B with an fp32 gradient). Adafactor's update depends on two
// whole-tensor sums (the RMS of u and of p), so it reads g three times: g
// and p (stats), g (sum of u^2), g and p and writes p (apply), about 12 B
// per bf16 parameter (18 B with an fp32 gradient).
// The rules of (e) read p, g and their state and write p and the state
// once: SGD 3 bf16 passes, Momentum and Adagrad 5, Adamax, Adadelta and
// RMSProp 7 (centered 9). Lamb reads g, p, m, v twice (pass 2 recomputes
// r rather than reading a rounded moment) and writes p, m, v: 11 passes;
// LARS reads g and p twice and v once and writes p and v: 7.
// What the design does about it: 16-byte vector loads of 8 elements per
// thread (two vectors for fp32), one block per chunk of 64K elements or
// 256K-element row tiles, many blocks in flight; a tensor's operands that
// are not all 16-byte aligned take a scalar loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "vec16.cuh"

namespace {

constexpr int kTensorWords = 16;
constexpr int kHeaderWords = 3;
// tensor entry words
constexpr int kP = 0, kG = 1, kS0 = 2, kS1 = 3, kS2 = 4, kNumel = 5,
              kCols = 6, kRows = 7, kSpan = 8, kTiles = 9, kChunkBegin = 10,
              kChunkEnd = 11, kFlags = 12, kMatBase = 13, kColBase = 14,
              kSplitBase = 15;  // factored: vc offset << 32 | vr offset, of
                                // the step's row and column sum buffers
// flags
constexpr int64_t kBf16 = 1, kDecay = 2, kVec = 4, kFactored = 8,
                  kGradF32 = 16;  // fp32 gradient, bf16 parameter
constexpr int kThreads = 256;     // sumsq, adam and Adafactor's u passes
constexpr int kStatsThreads = 128;  // Adafactor's stats pass: 4 warps
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kFinishThreads = 1024;
constexpr int kMaxTileRows = 1024;  // kernels/optimizer.py MAX_TILE_ROWS

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// jnp.maximum / jnp.minimum and torch's clamp: NaN in, NaN out
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float nanmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static __device__ __forceinline__ void ld8(const float* p, float* o) {
    pt::Vec16<float>::load(p, o);
    pt::Vec16<float>::load(p + 4, o + 4);
  }
  static __device__ __forceinline__ void st8(float* p, const float* v) {
    pt::Vec16<float>::store(p, v);
    pt::Vec16<float>::store(p + 4, v + 4);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void ld8(const __nv_bfloat16* p, float* o) {
    pt::Vec16<__nv_bfloat16>::load(p, o);
  }
  static __device__ __forceinline__ void st8(__nv_bfloat16* p, const float* v) {
    pt::Vec16<__nv_bfloat16>::store(p, v);
  }
};

// every lane ends with the same bits: each butterfly step adds the same
// two values on both lanes, and fp32 addition commutes
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fadd(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the block's sum in a fixed order, returned to every thread; `sm` holds
// one float a warp
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* sm) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) sm[w] = v;
  __syncthreads();
  return warp_sum(lane < NT / 32 ? sm[lane] : 0.f);
}

struct Header {
  float lr;
  int step, n_tensors, n_chunks, skip;
};
__device__ __forceinline__ Header header(const int64_t* table) {
  const int32_t* h = reinterpret_cast<const int32_t*>(table);
  return {__int_as_float(h[0]), h[1], h[2], h[3], h[4]};
}
__device__ __forceinline__ const int64_t* entry(const int64_t* table, int i) {
  return table + kHeaderWords + (int64_t)i * kTensorWords;
}
__device__ __forceinline__ const int64_t* chunk_words(const int64_t* table,
                                                      int n_tensors) {
  return table + kHeaderWords + (int64_t)n_tensors * kTensorWords;
}

struct Chunk {
  int tensor;
  int64_t k;     // chunk index within the tensor
  int64_t off;   // first element
  int64_t len;   // elements
  int64_t b;     // factored: leading (matrix) index
  int64_t r0;    // factored: first row within the matrix
  int64_t nr;    // factored: rows
};
__device__ __forceinline__ Chunk chunk_at(const int64_t* table, int n_tensors,
                                          int c) {
  const int64_t w = chunk_words(table, n_tensors)[c];
  Chunk ch;
  ch.tensor = (int)(w >> 40);
  ch.k = w & ((1LL << 40) - 1);
  const int64_t* e = entry(table, ch.tensor);
  const int64_t span = e[kSpan];
  if (e[kFlags] & kFactored) {
    const int64_t R = e[kRows], C = e[kCols], tiles = e[kTiles];
    ch.b = ch.k / tiles;
    ch.r0 = (ch.k % tiles) * span;
    ch.nr = R - ch.r0 < span ? R - ch.r0 : span;
    ch.off = (ch.b * R + ch.r0) * C;
    ch.len = ch.nr * C;
  } else {
    ch.b = 0;
    ch.r0 = 0;
    ch.nr = 0;
    ch.off = ch.k * span;
    const int64_t rest = e[kNumel] - ch.off;
    ch.len = rest < span ? rest : span;
  }
  return ch;
}

// the clip and the coupled decay, in the JAX package's order
// (optimizer.py:128-134): g = clip(g) in g's dtype TG, cast to p's dtype
// TP, then g + wd * p in p's
struct Clip {
  int mode;  // 0 none, 1 scale from norms[n_tensors + i], 2 value [lo, hi]
  float lo, hi;
};
template <typename TP, typename TG>
struct Prep {
  int mode;
  float scale, lo, hi, wd;
  bool coupled;
  __device__ __forceinline__ float operator()(float g, float p) const {
    if (mode == 1) {
      g = Elem<TG>::rnd(fmul(g, scale));
    } else if (mode == 2) {
      g = g < lo ? lo : g;
      g = g > hi ? hi : g;
    }
    if constexpr (!std::is_same<TP, TG>::value) g = Elem<TP>::rnd(g);
    if (coupled) g = Elem<TP>::rnd(fadd(g, Elem<TP>::rnd(fmul(wd, p))));
    return g;
  }
};
template <typename TP, typename TG>
__device__ __forceinline__ Prep<TP, TG> make_prep(const Clip& c,
                                                  const float* norms,
                                                  int n_tensors, int i,
                                                  float wd, bool coupled) {
  Prep<TP, TG> r;
  r.mode = c.mode;
  r.scale = c.mode == 1 ? norms[n_tensors + i] : 1.f;
  r.lo = Elem<TG>::rnd(c.lo);
  r.hi = Elem<TG>::rnd(c.hi);
  r.wd = Elem<TP>::rnd(wd);  // a Python float beside p: a constant of p's dtype
  r.coupled = coupled;
  return r;
}

// the (parameter, gradient) types of tensor entry e: (fp32, fp32), (bf16,
// bf16) or (bf16, fp32); `f` is called with one value of each
template <typename F>
__device__ __forceinline__ auto by_types(const int64_t* e, F&& f) {
  const int64_t fl = e[kFlags];
  if (fl & kGradF32) return f(__nv_bfloat16(), float());
  if (fl & kBf16) return f(__nv_bfloat16(), __nv_bfloat16());
  return f(float(), float());
}

// ---------------------------------------------------------------------------
// (a) sums of squares of the gradients: per chunk, then per tensor and in all

template <typename T>
__device__ float sumsq_chunk(const T* g, int64_t len, bool vec) {
  float acc = 0.f;
  const int64_t vend = vec ? (len & ~(int64_t)7) : 0;
  for (int64_t j = (int64_t)threadIdx.x * 8; j < vend; j += kThreads * 8) {
    float x[8];
    Elem<T>::ld8(g + j, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fadd(acc, fmul(x[e], x[e]));
  }
  for (int64_t j = vend + threadIdx.x; j < len; j += kThreads) {
    const float x = Elem<T>::ld(g + j);
    acc = fadd(acc, fmul(x, x));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
sumsq_partial_kernel(const int64_t* __restrict__ table, float* __restrict__ partial) {
  __shared__ float sm[kThreads / 32];
  const Header h = header(table);
  const Chunk ch = chunk_at(table, h.n_tensors, blockIdx.x);
  const int64_t* e = entry(table, ch.tensor);
  const bool vec = e[kFlags] & kVec;
  float acc = by_types(e, [&](auto, auto tg) {
    using TG = decltype(tg);
    return sumsq_chunk(reinterpret_cast<const TG*>(e[kG]) + ch.off, ch.len, vec);
  });
  acc = block_sum<kThreads>(acc, sm);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// one block: warp w sums the chunk partials of tensors w, w + 32, ...; then
// one thread adds the tensors' sums in tensor order (as the JAX package's
// Python `sum` does) and every tensor gets its clip scale
// min(clip / max(norm, 1e-12), 1), of its own norm or of the global one
__global__ void __launch_bounds__(kFinishThreads)
sumsq_finish_kernel(const int64_t* __restrict__ table, const float* __restrict__ partial,
                    float clip_norm, int scale_mode, float* __restrict__ out) {
  __shared__ float total_sm;
  const Header h = header(table);
  const int n = h.n_tensors;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = w; i < n; i += kFinishThreads / 32) {
    const int64_t* e = entry(table, i);
    float acc = 0.f;
    for (int64_t c = e[kChunkBegin] + lane; c < e[kChunkEnd]; c += 32)
      acc = fadd(acc, partial[c]);
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int i = 0; i < n; ++i) t = fadd(t, out[i]);
    out[2 * n] = t;
    total_sm = t;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kFinishThreads) {
    float s = 1.f;
    if (scale_mode != 0) {
      const float norm = sqrtf(scale_mode == 2 ? total_sm : out[i]);
      s = nanmin(fdiv(clip_norm, nanmax(norm, 1e-12f)), 1.f);
    }
    out[n + i] = s;
  }
}

// ---------------------------------------------------------------------------
// (b) Adam / AdamW (optimizer.py:265-276, decays :133-140)

struct AdamArgs {
  float b1, b2, omb1, omb2, eps, wd;
  int decoupled;
  Clip clip;
};

template <typename T, typename TG>
__device__ void adam_chunk(const int64_t* e, int i, const Chunk& ch,
                           const AdamArgs& a, const float* norms, int n,
                           float lr, float c1, float c2) {
  T* p = reinterpret_cast<T*>(e[kP]) + ch.off;
  const TG* g = reinterpret_cast<const TG*>(e[kG]) + ch.off;
  T* m = reinterpret_cast<T*>(e[kS0]) + ch.off;
  T* v = reinterpret_cast<T*>(e[kS1]) + ch.off;
  const int64_t fl = e[kFlags];
  const bool flag = (fl & kDecay) && a.wd != 0.f;
  const Prep<T, TG> prep = make_prep<T, TG>(a.clip, norms, n, i, a.wd,
                                            flag && !a.decoupled);
  const bool dec = flag && a.decoupled;
  const float lrwd = fmul(lr, a.wd);
  auto rule = [&](float& pf, float gf, float& mf, float& vf) {
    gf = prep(gf, pf);
    mf = fadd(fmul(a.b1, mf), fmul(a.omb1, gf));
    vf = fadd(fmul(a.b2, vf), fmul(fmul(a.omb2, gf), gf));
    const float upd = fdiv(fmul(lr, fdiv(mf, c1)),
                           fadd(sqrtf(fdiv(vf, c2)), a.eps));
    float pn = Elem<T>::rnd(fsub(pf, upd));
    if (dec) pn = Elem<T>::rnd(fsub(pn, Elem<T>::rnd(fmul(lrwd, pf))));
    pf = pn;
  };
  const int64_t len = ch.len;
  const int64_t vend = (fl & kVec) ? (len & ~(int64_t)7) : 0;
  for (int64_t j = (int64_t)threadIdx.x * 8; j < vend; j += kThreads * 8) {
    float pf[8], gf[8], mf[8], vf[8];
    Elem<T>::ld8(p + j, pf);
    Elem<TG>::ld8(g + j, gf);
    Elem<T>::ld8(m + j, mf);
    Elem<T>::ld8(v + j, vf);
#pragma unroll
    for (int q = 0; q < 8; ++q) rule(pf[q], gf[q], mf[q], vf[q]);
    Elem<T>::st8(p + j, pf);
    Elem<T>::st8(m + j, mf);
    Elem<T>::st8(v + j, vf);
  }
  for (int64_t j = vend + threadIdx.x; j < len; j += kThreads) {
    float pf = Elem<T>::ld(p + j), mf = Elem<T>::ld(m + j),
          vf = Elem<T>::ld(v + j);
    rule(pf, Elem<TG>::ld(g + j), mf, vf);
    Elem<T>::st(p + j, pf);
    Elem<T>::st(m + j, mf);
    Elem<T>::st(v + j, vf);
  }
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const int64_t* __restrict__ table, const float* __restrict__ norms,
            AdamArgs a) {
  const Header h = header(table);
  if (h.skip) return;  // a non-finite step: nothing is written
  const Chunk ch = chunk_at(table, h.n_tensors, blockIdx.x);
  const int64_t* e = entry(table, ch.tensor);
  // 1 - b^t in fp32 from the fp32 beta, as `Adam._rule` takes it
  const float t = (float)h.step;
  const float c1 = fsub(1.f, powf(a.b1, t));
  const float c2 = fsub(1.f, powf(a.b2, t));
  by_types(e, [&](auto tp, auto tg) {
    adam_chunk<decltype(tp), decltype(tg)>(e, ch.tensor, ch, a, norms,
                                           h.n_tensors, h.lr, c1, c2);
  });
}

// ---------------------------------------------------------------------------
// (c) Adafactor statistics (optimizer.py:448-458): g2 = g^2 + eps1 after the
// clip and decay; vr from whole row sums, vc from column partials finished
// in a fixed order, mean(vr) per matrix; the plain v of flat tensors; the
// parameter's sum of squares for its RMS (:470-472)

struct FactorArgs {
  float decay, eps1, wd;
  Clip clip;
  int need_p;      // read p: the parameter scale or the coupled decay
  int seg_cols;    // columns per pass over a tile (shared memory)
  // the update pass
  float b1, omb1, eps2, clip_threshold;
  int pscale;
};

__device__ __forceinline__ void beta2(int step, float decay, float& bt, float& om) {
  bt = fsub(1.f, powf((float)step, -decay));
  om = fsub(1.f, bt);
}

template <typename T, typename TG>
__device__ float stats_chunk(const int64_t* e, int i, const Chunk& ch,
                             const FactorArgs& a, const float* norms, int n,
                             float bt, float om, float* colpart, float* smem,
                             float* rowsum) {
  const TG* g = reinterpret_cast<const TG*>(e[kG]);
  const T* p = reinterpret_cast<const T*>(e[kP]);
  const int64_t fl = e[kFlags];
  const bool vec = fl & kVec;
  const Prep<T, TG> prep = make_prep<T, TG>(a.clip, norms, n, i, a.wd,
                                            (fl & kDecay) && a.wd != 0.f);
  const bool need_p = a.need_p;
  float psum = 0.f;
  if (!(fl & kFactored)) {
    float* v = reinterpret_cast<float*>(e[kS0]) + ch.off;
    g += ch.off;
    p += ch.off;
    const int64_t len = ch.len;
    const int64_t vend = vec ? (len & ~(int64_t)7) : 0;
    for (int64_t j = (int64_t)threadIdx.x * 8; j < vend; j += kStatsThreads * 8) {
      float gf[8], pf[8], vf[8];
      Elem<TG>::ld8(g + j, gf);
      if (need_p) Elem<T>::ld8(p + j, pf);
      Elem<float>::ld8(v + j, vf);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float pq = need_p ? pf[q] : 0.f;
        const float x = prep(gf[q], pq);
        vf[q] = fadd(fmul(bt, vf[q]), fmul(om, fadd(fmul(x, x), a.eps1)));
        psum = fadd(psum, fmul(pq, pq));
      }
      Elem<float>::st8(v + j, vf);
    }
    for (int64_t j = vend + threadIdx.x; j < len; j += kStatsThreads) {
      const float pq = need_p ? Elem<T>::ld(p + j) : 0.f;
      const float x = prep(Elem<TG>::ld(g + j), pq);
      v[j] = fadd(fmul(bt, v[j]), fmul(om, fadd(fmul(x, x), a.eps1)));
      psum = fadd(psum, fmul(pq, pq));
    }
    return psum;
  }
  // a tile of nr whole rows of matrix b: warp w takes rows w, w + 4, ...;
  // a lane takes 8 columns (or 1 where the tensor is not vectorised) in
  // steps of 256 (32); row sums by warp_sum, column partials per warp in
  // shared memory, summed over the warps in order, a pass per seg_cols
  const int64_t C = e[kCols], R = e[kRows];
  float* vr = reinterpret_cast<float*>(e[kS0]);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* rowacc = smem;                                // kMaxTileRows
  float* colacc = smem + kMaxTileRows + w * a.seg_cols;  // this warp's
  float* cols = colpart + e[kColBase] + ch.k * C;
  for (int64_t s0 = 0; s0 < C; s0 += a.seg_cols) {
    const int sw = (int)(C - s0 < a.seg_cols ? C - s0 : a.seg_cols);
    for (int c = lane; c < sw; c += 32) colacc[c] = 0.f;
    __syncwarp();
    for (int r = w; r < ch.nr; r += kStatsWarps) {
      const int64_t row = (ch.b * R + ch.r0 + r) * C + s0;
      const TG* gr = g + row;
      const T* pr = p + row;
      float racc = 0.f;
      if (vec) {
        for (int c = lane * 8; c < sw; c += 256) {
          float gf[8], pf[8];
          Elem<TG>::ld8(gr + c, gf);
          if (need_p) Elem<T>::ld8(pr + c, pf);
          float ca[8];
          Elem<float>::ld8(colacc + c, ca);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float pq = need_p ? pf[q] : 0.f;
            const float x = prep(gf[q], pq);
            const float g2 = fadd(fmul(x, x), a.eps1);
            racc = fadd(racc, g2);
            ca[q] = fadd(ca[q], g2);
            psum = fadd(psum, fmul(pq, pq));
          }
          Elem<float>::st8(colacc + c, ca);
        }
      } else {
        for (int c = lane; c < sw; c += 32) {
          const float pq = need_p ? Elem<T>::ld(pr + c) : 0.f;
          const float x = prep(Elem<TG>::ld(gr + c), pq);
          const float g2 = fadd(fmul(x, x), a.eps1);
          racc = fadd(racc, g2);
          colacc[c] = fadd(colacc[c], g2);
          psum = fadd(psum, fmul(pq, pq));
        }
      }
      racc = warp_sum(racc);
      if (lane == 0) rowacc[r] = s0 == 0 ? racc : fadd(rowacc[r], racc);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < sw; c += kStatsThreads) {
      const float* base = smem + kMaxTileRows + c;
      float s = base[0];
#pragma unroll
      for (int q = 1; q < kStatsWarps; ++q) s = fadd(s, base[q * a.seg_cols]);
      cols[s0 + c] = s;
    }
    __syncthreads();
  }
  if (rowsum != nullptr) {  // a split tensor: the raw sums, summed over
    // the ranks before the finish pass takes the mean over every column
    float* rs = rowsum + (e[kSplitBase] & 0xffffffffLL) + ch.b * R + ch.r0;
    for (int r = threadIdx.x; r < ch.nr; r += kStatsThreads) rs[r] = rowacc[r];
    return psum;
  }
  // vr = beta2t * vr + (1 - beta2t) * mean over the row
  const float fc = (float)C;
  for (int r = threadIdx.x; r < ch.nr; r += kStatsThreads) {
    float* x = vr + ch.b * R + ch.r0 + r;
    *x = fadd(fmul(bt, *x), fmul(om, fdiv(rowacc[r], fc)));
  }
  return psum;
}

__global__ void __launch_bounds__(kStatsThreads)
adafactor_stats_kernel(const int64_t* __restrict__ table, const float* __restrict__ norms,
                       FactorArgs a, float* __restrict__ colpart,
                       float* __restrict__ pspart, float* __restrict__ rowsum) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kStatsWarps];
  const Header h = header(table);
  if (h.skip) return;  // a non-finite step: nothing is written
  const Chunk ch = chunk_at(table, h.n_tensors, blockIdx.x);
  const int64_t* e = entry(table, ch.tensor);
  float bt, om;
  beta2(h.step, a.decay, bt, om);
  float psum = by_types(e, [&](auto tp, auto tg) {
    return stats_chunk<decltype(tp), decltype(tg)>(
        e, ch.tensor, ch, a, norms, h.n_tensors, bt, om, colpart, smem,
        rowsum);
  });
  psum = block_sum<kStatsThreads>(psum, red);
  if (threadIdx.x == 0) pspart[blockIdx.x] = psum;
}

// blocks [0, n_matrices): one matrix each, vc from its tiles' column
// partials in tile order, then mean(vr); blocks [n_matrices, + n_tensors):
// one tensor each, its sum of p^2 from its chunk partials in order.
// stats = [sum p^2 per tensor | mean(vr) per matrix]. With colsum (a
// split step) a matrix block writes its raw column sums there instead,
// and vc, vr and the means wait for the sums over the ranks.
__global__ void __launch_bounds__(kThreads)
adafactor_finish_kernel(const int64_t* __restrict__ table, int n_matrices,
                        FactorArgs a, const float* __restrict__ colpart,
                        const float* __restrict__ pspart, float* __restrict__ stats,
                        float* __restrict__ colsum) {
  __shared__ float red[kThreads / 32];
  const Header h = header(table);
  if (h.skip) return;  // a non-finite step: nothing is written
  const int n = h.n_tensors;
  if ((int)blockIdx.x >= n_matrices) {
    const int i = blockIdx.x - n_matrices;
    const int64_t* e = entry(table, i);
    float acc = 0.f;
    for (int64_t c = e[kChunkBegin] + threadIdx.x; c < e[kChunkEnd]; c += kThreads)
      acc = fadd(acc, pspart[c]);
    acc = block_sum<kThreads>(acc, red);
    if (threadIdx.x == 0) stats[i] = acc;
    return;
  }
  const int64_t mw = chunk_words(table, n)[h.n_chunks + blockIdx.x];
  const int i = (int)(mw >> 40);
  const int64_t b = mw & ((1LL << 40) - 1);
  const int64_t* e = entry(table, i);
  const int64_t C = e[kCols], R = e[kRows], tiles = e[kTiles];
  float bt, om;
  beta2(h.step, a.decay, bt, om);
  float* vc = reinterpret_cast<float*>(e[kS1]) + b * C;
  const float* cols = colpart + e[kColBase] + b * tiles * C;
  const float fr = (float)R;
  if (colsum != nullptr) {
    float* cs = colsum + (e[kSplitBase] >> 32) + b * C;
    for (int64_t c = threadIdx.x; c < C; c += kThreads) {
      float s = cols[c];
      for (int64_t t = 1; t < tiles; ++t) s = fadd(s, cols[t * C + c]);
      cs[c] = s;
    }
    return;
  }
  for (int64_t c = threadIdx.x; c < C; c += kThreads) {
    float s = cols[c];
    for (int64_t t = 1; t < tiles; ++t) s = fadd(s, cols[t * C + c]);
    vc[c] = fadd(fmul(bt, vc[c]), fmul(om, fdiv(s, fr)));
  }
  const float* vr = reinterpret_cast<const float*>(e[kS0]) + b * R;
  float acc = 0.f;
  for (int64_t r = threadIdx.x; r < R; r += kThreads) acc = fadd(acc, vr[r]);
  acc = block_sum<kThreads>(acc, red);
  if (threadIdx.x == 0) stats[n + e[kMatBase] + b] = fdiv(acc, fr);
}

// A split step's finish, after the row and column sums were summed over
// the ranks that split the columns and the rows: per matrix, vr and vc
// from the sums over the whole tensor (fulls: numel, C, R of each whole
// tensor) and the sum of the new vr into stats[n + matrix], in the order
// of adafactor_finish_kernel's mean (the host sums it over the ranks that
// split the rows, then divides by the whole R).
__global__ void __launch_bounds__(kThreads)
adafactor_split_finish_kernel(const int64_t* __restrict__ table, FactorArgs a,
                              const float* __restrict__ rowsum,
                              const float* __restrict__ colsum,
                              const float* __restrict__ fulls,
                              float* __restrict__ stats) {
  __shared__ float red[kThreads / 32];
  const Header h = header(table);
  if (h.skip) return;  // a non-finite step: nothing is written
  const int n = h.n_tensors;
  const int64_t mw = chunk_words(table, n)[h.n_chunks + blockIdx.x];
  const int i = (int)(mw >> 40);
  const int64_t b = mw & ((1LL << 40) - 1);
  const int64_t* e = entry(table, i);
  const int64_t C = e[kCols], R = e[kRows];
  float bt, om;
  beta2(h.step, a.decay, bt, om);
  const float fc = fulls[3 * i + 1], fr = fulls[3 * i + 2];
  float* vc = reinterpret_cast<float*>(e[kS1]) + b * C;
  const float* cs = colsum + (e[kSplitBase] >> 32) + b * C;
  for (int64_t c = threadIdx.x; c < C; c += kThreads)
    vc[c] = fadd(fmul(bt, vc[c]), fmul(om, fdiv(cs[c], fr)));
  float* vr = reinterpret_cast<float*>(e[kS0]) + b * R;
  const float* rs = rowsum + (e[kSplitBase] & 0xffffffffLL) + b * R;
  float acc = 0.f;
  for (int64_t r = threadIdx.x; r < R; r += kThreads) {
    const float x = fadd(fmul(bt, vr[r]), fmul(om, fdiv(rs[r], fc)));
    vr[r] = x;
    acc = fadd(acc, x);
  }
  acc = block_sum<kThreads>(acc, red);
  if (threadIdx.x == 0) stats[n + e[kMatBase] + b] = acc;
}

// ---------------------------------------------------------------------------
// (d) Adafactor's update (optimizer.py:462-473): u = g / sqrt(vhat), vhat =
// (vr / mean(vr)) * vc rebuilt per element, never stored; pass 1 sums u^2
// per chunk, pass 2 re-sums a tensor's partials in order, clips u by its
// RMS, applies the first moment and the parameter scale. The IEEE square
// root and divisions cost more issue slots than the pass's bytes, so pass
// 1 takes each term as x^2 / vhat (approximate division, no root): the
// RMS is a sum in another order than the reference's anyway, and its
// terms move by ~1e-7 of themselves; pass 2 skips the division by the
// clip's divisor where it is 1 (x / 1 is x).

template <typename T, typename TG, bool kApply>
__device__ float update_chunk(const int64_t* e, int i, const Chunk& ch,
                              const FactorArgs& a, const float* norms, int n,
                              const float* stats, float den, float lrs) {
  T* p = reinterpret_cast<T*>(e[kP]);
  const TG* g = reinterpret_cast<const TG*>(e[kG]);
  T* m = reinterpret_cast<T*>(e[kS2]);  // null without a first moment
  const int64_t fl = e[kFlags];
  const bool vec = fl & kVec;
  const Prep<T, TG> prep = make_prep<T, TG>(a.clip, norms, n, i, a.wd,
                                            (fl & kDecay) && a.wd != 0.f);
  const bool need_p = kApply || prep.coupled;
  const bool has_m = m != nullptr;
  float usq = 0.f;
  // the first pass: u^2 = x^2 / vhat, with one approximate division (2
  // ulp) and no square root; the apply pass: u = x / sqrt(vhat), each
  // rounded as the JAX package rounds, then its new p (and m)
  auto one = [&](float gf, float& pf, float& mf, float vh) {
    const float x = prep(gf, pf);
    if (!kApply) {
      usq = fadd(usq, __fdividef(fmul(x, x), vh));
      return;
    }
    float u = fdiv(x, sqrtf(vh));
    if (den != 1.f) u = fdiv(u, den);
    if (has_m) {
      mf = fadd(fmul(a.b1, mf), fmul(a.omb1, u));
      u = mf;
    }
    pf = Elem<T>::rnd(fsub(pf, fmul(lrs, u)));
  };
  if (!(fl & kFactored)) {
    const float* v = reinterpret_cast<const float*>(e[kS0]) + ch.off;
    p += ch.off;
    g += ch.off;
    if (has_m) m += ch.off;
    const int64_t len = ch.len;
    const int64_t vend = vec ? (len & ~(int64_t)7) : 0;
    for (int64_t j = (int64_t)threadIdx.x * 8; j < vend; j += kThreads * 8) {
      float gf[8], pf[8], mf[8], vf[8];
      Elem<TG>::ld8(g + j, gf);
      if (need_p) Elem<T>::ld8(p + j, pf);
      if (kApply && has_m) Elem<T>::ld8(m + j, mf);
      Elem<float>::ld8(v + j, vf);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (!need_p) pf[q] = 0.f;
        one(gf[q], pf[q], mf[q], vf[q]);
      }
      if (kApply) {
        Elem<T>::st8(p + j, pf);
        if (has_m) Elem<T>::st8(m + j, mf);
      }
    }
    for (int64_t j = vend + threadIdx.x; j < len; j += kThreads) {
      float pf = need_p ? Elem<T>::ld(p + j) : 0.f;
      float mf = (kApply && has_m) ? Elem<T>::ld(m + j) : 0.f;
      one(Elem<TG>::ld(g + j), pf, mf, v[j]);
      if (kApply) {
        Elem<T>::st(p + j, pf);
        if (has_m) Elem<T>::st(m + j, mf);
      }
    }
    return usq;
  }
  const int64_t C = e[kCols], R = e[kRows];
  const float* vr = reinterpret_cast<const float*>(e[kS0]) + ch.b * R + ch.r0;
  const float* vc = reinterpret_cast<const float*>(e[kS1]) + ch.b * C;
  const float mean_vr = stats[n + e[kMatBase] + ch.b];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = w; r < ch.nr; r += kThreads / 32) {
    const int64_t row = (ch.b * R + ch.r0 + r) * C;
    const float rs = fdiv(vr[r], mean_vr);
    T* pr = p + row;
    const TG* gr = g + row;
    T* mr = has_m ? m + row : nullptr;
    if (vec) {
      for (int64_t c = lane * 8; c < C; c += 256) {
        float gf[8], pf[8], mf[8], vcf[8];
        Elem<TG>::ld8(gr + c, gf);
        if (need_p) Elem<T>::ld8(pr + c, pf);
        if (kApply && has_m) Elem<T>::ld8(mr + c, mf);
        Elem<float>::ld8(vc + c, vcf);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (!need_p) pf[q] = 0.f;
          one(gf[q], pf[q], mf[q], fmul(rs, vcf[q]));
        }
        if (kApply) {
          Elem<T>::st8(pr + c, pf);
          if (has_m) Elem<T>::st8(mr + c, mf);
        }
      }
    } else {
      for (int64_t c = lane; c < C; c += 32) {
        float pf = need_p ? Elem<T>::ld(pr + c) : 0.f;
        float mf = (kApply && has_m) ? Elem<T>::ld(mr + c) : 0.f;
        one(Elem<TG>::ld(gr + c), pf, mf, fmul(rs, vc[c]));
        if (kApply) {
          Elem<T>::st(pr + c, pf);
          if (has_m) Elem<T>::st(mr + c, mf);
        }
      }
    }
  }
  return usq;
}

__global__ void __launch_bounds__(kThreads)
adafactor_usq_kernel(const int64_t* __restrict__ table, const float* __restrict__ norms,
                     FactorArgs a, const float* __restrict__ stats,
                     float* __restrict__ uspart) {
  __shared__ float red[kThreads / 32];
  const Header h = header(table);
  if (h.skip) return;  // a non-finite step: nothing is written
  const Chunk ch = chunk_at(table, h.n_tensors, blockIdx.x);
  const int64_t* e = entry(table, ch.tensor);
  float usq = by_types(e, [&](auto tp, auto tg) {
    return update_chunk<decltype(tp), decltype(tg), false>(
        e, ch.tensor, ch, a, norms, h.n_tensors, stats, 1.f, 0.f);
  });
  usq = block_sum<kThreads>(usq, red);
  if (threadIdx.x == 0) uspart[blockIdx.x] = usq;
}

// a tensor's sum of u^2 from its chunk partials, in the order every block
// of adafactor_apply_kernel takes it (one block a tensor)
__device__ __forceinline__ float tensor_usq(const int64_t* e,
                                            const float* uspart, float* red) {
  float usq = 0.f;
  for (int64_t c = e[kChunkBegin] + threadIdx.x; c < e[kChunkEnd]; c += kThreads)
    usq = fadd(usq, uspart[c]);
  return block_sum<kThreads>(usq, red);
}

// a split step: each tensor's sum of u^2 into usq, for the sum over ranks
__global__ void __launch_bounds__(kThreads)
adafactor_usq_sum_kernel(const int64_t* __restrict__ table,
                         const float* __restrict__ uspart, float* __restrict__ usq) {
  __shared__ float red[kThreads / 32];
  const Header h = header(table);
  if (h.skip) return;
  const float s = tensor_usq(entry(table, blockIdx.x), uspart, red);
  if (threadIdx.x == 0) usq[blockIdx.x] = s;
}

// usq_all and fulls (a split step): each tensor's sum of u^2 over the
// ranks, and its whole numel (fulls[3 i]); null: this rank's alone
__global__ void __launch_bounds__(kThreads)
adafactor_apply_kernel(const int64_t* __restrict__ table, const float* __restrict__ norms,
                       FactorArgs a, const float* __restrict__ stats,
                       const float* __restrict__ uspart,
                       const float* __restrict__ usq_all,
                       const float* __restrict__ fulls) {
  __shared__ float red[kThreads / 32];
  const Header h = header(table);
  if (h.skip) return;  // a non-finite step: nothing is written
  const Chunk ch = chunk_at(table, h.n_tensors, blockIdx.x);
  const int64_t* e = entry(table, ch.tensor);
  // the tensor's sum of u^2, in the same order in every one of its blocks
  const float usq = usq_all != nullptr ? usq_all[ch.tensor]
                                       : tensor_usq(e, uspart, red);
  const float numel = fulls != nullptr ? fulls[3 * ch.tensor]
                                       : (float)e[kNumel];
  const float rms = sqrtf(fdiv(usq, numel));
  const float den = nanmax(1.f, fdiv(rms, a.clip_threshold));
  const float scale = a.pscale
      ? nanmax(a.eps2, sqrtf(fdiv(stats[ch.tensor], numel))) : 1.f;
  const float lrs = fmul(h.lr, scale);
  by_types(e, [&](auto tp, auto tg) {
    update_chunk<decltype(tp), decltype(tg), true>(
        e, ch.tensor, ch, a, norms, h.n_tensors, stats, den, lrs);
  });
}

// ---------------------------------------------------------------------------
// (e) the rules computed in the parameter's dtype (optimizer.py:212-332,
// 476-498): SGD, Momentum (Nesterov), Adagrad, Adamax, RMSProp (centered or
// not, with momentum) and Adadelta, one kernel per rule over the chunk table.
// The JAX rule runs each operation in p's dtype: for a bf16 parameter every
// product, sum, quotient and root is a bf16 result (here the fp32 operation,
// then Elem<T>::rnd: fp32 keeps more than twice bf16's bits plus two, so the
// second rounding gives the correctly rounded bf16 result), and the
// Python-float hyperparameters and the rate (lr.astype(p.dtype)) are
// constants of p's dtype. Adamax alone takes its rate lr / (1 - b1^t) in fp32
// before the cast (:306). Each operation in the order of the Python
// expression: Adagrad (lr g) / (sqrt(m) + eps), Adadelta's update from the
// old avg_squared_update (:493-496).

constexpr int kSGD = 0, kMomentum = 1, kAdagrad = 2, kAdamax = 3,
              kRMSProp = 4, kAdadelta = 5;

struct RuleArgs {
  // Momentum mu; Adagrad eps; Adamax b1, 1 - b1, b2, eps; RMSProp rho,
  // 1 - rho, eps, mu; Adadelta rho, 1 - rho, eps (each 1 - x taken in
  // double on the host, as Python takes it)
  float h[4];
  int opt;   // Momentum: Nesterov; RMSProp: centered
  float wd;  // the base path's coupled decay
  Clip clip;
};

template <int RULE, typename T>
struct RuleOp {
  float lr, c0, c1, c2, c3;  // the rate and the hyperparameters in T
  int opt;
  static __device__ __forceinline__ float R(float x) { return Elem<T>::rnd(x); }
  // one element: p and the state (s0, s1, s2 in the slot order of
  // kernels/optimizer.py) in place, g clipped and decayed
  __device__ __forceinline__ void operator()(float& p, float g, float& s0,
                                             float& s1, float& s2) const {
    if constexpr (RULE == kSGD) {
      p = R(fsub(p, R(fmul(lr, g))));
    } else if constexpr (RULE == kMomentum) {  // s0 velocity
      s0 = R(fadd(R(fmul(c0, s0)), g));
      const float upd = opt ? R(fadd(g, R(fmul(c0, s0)))) : s0;
      p = R(fsub(p, R(fmul(lr, upd))));
    } else if constexpr (RULE == kAdagrad) {  // s0 moment
      s0 = R(fadd(s0, R(fmul(g, g))));
      p = R(fsub(p, R(fdiv(R(fmul(lr, g)), R(fadd(R(sqrtf(s0)), c0))))));
    } else if constexpr (RULE == kAdamax) {  // s0 moment, s1 inf_norm
      s0 = R(fadd(R(fmul(c0, s0)), R(fmul(c1, g))));
      s1 = nanmax(R(fmul(c2, s1)), fabsf(g));
      p = R(fsub(p, R(fdiv(R(fmul(lr, s0)), R(fadd(s1, c3))))));
    } else if constexpr (RULE == kRMSProp) {
      // s0 mean_square, s1 mean_grad (centered only), s2 velocity
      s0 = R(fadd(R(fmul(c0, s0)), R(fmul(R(fmul(c1, g)), g))));
      float den;
      if (opt) {
        s1 = R(fadd(R(fmul(c0, s1)), R(fmul(c1, g))));
        den = R(sqrtf(R(fadd(R(fsub(s0, R(fmul(s1, s1)))), c2))));
      } else {
        den = R(sqrtf(R(fadd(s0, c2))));
      }
      s2 = R(fadd(R(fmul(c3, s2)), R(fdiv(R(fmul(lr, g)), den))));
      p = R(fsub(p, s2));
    } else {  // Adadelta: s0 avg_squared_grad, s1 avg_squared_update
      s0 = R(fadd(R(fmul(c0, s0)), R(fmul(R(fmul(c1, g)), g))));
      const float upd = R(fmul(R(fdiv(-R(sqrtf(R(fadd(s1, c2)))),
                                      R(sqrtf(R(fadd(s0, c2)))))), g));
      s1 = R(fadd(R(fmul(c0, s1)), R(fmul(R(fmul(c1, upd)), upd))));
      p = R(fadd(p, R(fmul(lr, upd))));
    }
  }
};

template <int RULE, typename T, typename TG>
__device__ void rule_chunk(const int64_t* e, int i, const Chunk& ch,
                           const RuleArgs& a, const float* norms, int n,
                           float lr) {
  T* p = reinterpret_cast<T*>(e[kP]) + ch.off;
  const TG* g = reinterpret_cast<const TG*>(e[kG]) + ch.off;
  // the slots this rule reads and writes (RMSProp's mean_grad if centered)
  constexpr bool u0 = RULE != kSGD;
  const bool u1 = RULE == kAdamax || RULE == kAdadelta ||
                  (RULE == kRMSProp && a.opt);
  constexpr bool u2 = RULE == kRMSProp;
  T* s0 = u0 ? reinterpret_cast<T*>(e[kS0]) + ch.off : nullptr;
  T* s1 = u1 ? reinterpret_cast<T*>(e[kS1]) + ch.off : nullptr;
  T* s2 = u2 ? reinterpret_cast<T*>(e[kS2]) + ch.off : nullptr;
  const int64_t fl = e[kFlags];
  const Prep<T, TG> prep = make_prep<T, TG>(a.clip, norms, n, i, a.wd,
                                            (fl & kDecay) && a.wd != 0.f);
  RuleOp<RULE, T> op;
  op.lr = Elem<T>::rnd(lr);
  op.c0 = Elem<T>::rnd(a.h[0]);
  op.c1 = Elem<T>::rnd(a.h[1]);
  op.c2 = Elem<T>::rnd(a.h[2]);
  op.c3 = Elem<T>::rnd(a.h[3]);
  op.opt = a.opt;
  const int64_t len = ch.len;
  const int64_t vend = (fl & kVec) ? (len & ~(int64_t)7) : 0;
  for (int64_t j = (int64_t)threadIdx.x * 8; j < vend; j += kThreads * 8) {
    float pf[8], gf[8], x0[8] = {}, x1[8] = {}, x2[8] = {};
    Elem<T>::ld8(p + j, pf);
    Elem<TG>::ld8(g + j, gf);
    if (u0) Elem<T>::ld8(s0 + j, x0);
    if (u1) Elem<T>::ld8(s1 + j, x1);
    if (u2) Elem<T>::ld8(s2 + j, x2);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      op(pf[q], prep(gf[q], pf[q]), x0[q], x1[q], x2[q]);
    Elem<T>::st8(p + j, pf);
    if (u0) Elem<T>::st8(s0 + j, x0);
    if (u1) Elem<T>::st8(s1 + j, x1);
    if (u2) Elem<T>::st8(s2 + j, x2);
  }
  for (int64_t j = vend + threadIdx.x; j < len; j += kThreads) {
    float pf = Elem<T>::ld(p + j);
    float x0 = u0 ? Elem<T>::ld(s0 + j) : 0.f;
    float x1 = u1 ? Elem<T>::ld(s1 + j) : 0.f;
    float x2 = u2 ? Elem<T>::ld(s2 + j) : 0.f;
    op(pf, prep(Elem<TG>::ld(g + j), pf), x0, x1, x2);
    Elem<T>::st(p + j, pf);
    if (u0) Elem<T>::st(s0 + j, x0);
    if (u1) Elem<T>::st(s1 + j, x1);
    if (u2) Elem<T>::st(s2 + j, x2);
  }
}

template <int RULE>
__global__ void __launch_bounds__(kThreads)
rule_kernel(const int64_t* __restrict__ table, const float* __restrict__ norms,
            RuleArgs a) {
  const Header h = header(table);
  if (h.skip) return;  // a non-finite step: nothing is written
  const Chunk ch = chunk_at(table, h.n_tensors, blockIdx.x);
  const int64_t* e = entry(table, ch.tensor);
  float lr = h.lr;
  // Adamax: lr / (1 - b1^t) in fp32 from the fp32 b1 (optimizer.py:305-306)
  if (RULE == kAdamax) lr = fdiv(lr, fsub(1.f, powf(a.h[0], (float)h.step)));
  by_types(e, [&](auto tp, auto tg) {
    rule_chunk<RULE, decltype(tp), decltype(tg)>(e, ch.tensor, ch, a, norms,
                                                 h.n_tensors, lr);
  });
}

// ---------------------------------------------------------------------------
// (f) Lamb (optimizer.py:335-366) and LarsMomentum (:369-407): computed in
// fp32 and cast back, each scaled by norms of whole tensors. Pass 1
// (norms_kernel): per chunk, the sums of squares of a (Lamb's r = mhat /
// (sqrt(vhat) + eps) + wd p; LARS's gradient after the clip) and of p,
// into partial[2 c] and partial[2 c + 1]. Pass 2 (norm_apply_kernel): each
// block re-sums its tensor's partials in chunk order, so every block of a
// tensor holds the same norms, rounds them to fp32 and takes their roots,
// then updates: Lamb p - (lr trust) r with trust = |p| / |r| (1 where
// either is 0), recomputing m, v and r from the old state (pass 1 writes
// nothing but its partials: a bf16 m or v written there would give pass 2
// a rounded moment, which the reference's r never sees); LARS v = mu v +
// local_lr (g + wd p) with local_lr = lr coeff |p| / (|g| + wd |p| + eps)
// where |p| > 0 and that denominator > 0, else lr. The decay is the rule's
// own, zeroed for a tensor without the decay flag (:135-137).
// The sums are fp64: an fp32 square is exact in fp64 and a sum of 2^26 of
// them is within ~2^-40 of itself, far under half an fp32 ulp, so the
// plain version's sum in another order rounds to the same fp32 value but
// at a rounding boundary.

constexpr int kLamb = 0, kLars = 1;

struct NormArgs {
  float b1, b2, omb1, omb2, eps, wd, coeff, mu;  // Lamb: b*, eps, wd; LARS:
  Clip clip;                                     // wd, coeff, mu, eps
};

__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsq(float x) {
  return __dmul_rn((double)x, (double)x);
}
__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = dadd(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ double block_sum_d(double v, double* sm) {
  v = warp_sum_d(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) sm[w] = v;
  __syncthreads();
  return warp_sum_d(lane < kThreads / 32 ? sm[lane] : 0.0);
}

// Lamb's new m, v and its r for one element (optimizer.py:353-359)
__device__ __forceinline__ float lamb_r(const NormArgs& a, float c1, float c2,
                                        float wd, float g, float p, float& m,
                                        float& v) {
  m = fadd(fmul(a.b1, m), fmul(a.omb1, g));
  v = fadd(fmul(a.b2, v), fmul(fmul(a.omb2, g), g));
  return fadd(fdiv(fdiv(m, c1), fadd(sqrtf(fdiv(v, c2)), a.eps)), fmul(wd, p));
}

template <int RULE, typename T, typename TG>
__device__ void norms_chunk(const int64_t* e, int i, const Chunk& ch,
                            const NormArgs& a, const float* norms, int n,
                            float c1, float c2, double& sa, double& sp) {
  const T* p = reinterpret_cast<const T*>(e[kP]) + ch.off;
  const TG* g = reinterpret_cast<const TG*>(e[kG]) + ch.off;
  const T* m = RULE == kLamb ? reinterpret_cast<const T*>(e[kS0]) + ch.off : nullptr;
  const T* v = RULE == kLamb ? reinterpret_cast<const T*>(e[kS1]) + ch.off : nullptr;
  const int64_t fl = e[kFlags];
  const float wd = (fl & kDecay) ? a.wd : 0.f;
  const Prep<T, TG> prep = make_prep<T, TG>(a.clip, norms, n, i, 0.f, false);
  auto one = [&](float gq, float pq, float mq, float vq) {
    const float x = prep(gq, pq);
    const float y = RULE == kLamb ? lamb_r(a, c1, c2, wd, x, pq, mq, vq) : x;
    sa = dadd(sa, dsq(y));
    sp = dadd(sp, dsq(pq));
  };
  const int64_t len = ch.len;
  const int64_t vend = (fl & kVec) ? (len & ~(int64_t)7) : 0;
  for (int64_t j = (int64_t)threadIdx.x * 8; j < vend; j += kThreads * 8) {
    float pf[8], gf[8], mf[8] = {}, vf[8] = {};
    Elem<T>::ld8(p + j, pf);
    Elem<TG>::ld8(g + j, gf);
    if (RULE == kLamb) {
      Elem<T>::ld8(m + j, mf);
      Elem<T>::ld8(v + j, vf);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) one(gf[q], pf[q], mf[q], vf[q]);
  }
  for (int64_t j = vend + threadIdx.x; j < len; j += kThreads)
    one(Elem<TG>::ld(g + j), Elem<T>::ld(p + j),
        RULE == kLamb ? Elem<T>::ld(m + j) : 0.f,
        RULE == kLamb ? Elem<T>::ld(v + j) : 0.f);
}

__device__ __forceinline__ void corrections(const NormArgs& a, int step,
                                            float& c1, float& c2) {
  // 1 - b^t in fp32 from the fp32 beta, as `Lamb._rule` takes it (:356-358)
  const float t = (float)step;
  c1 = fsub(1.f, powf(a.b1, t));
  c2 = fsub(1.f, powf(a.b2, t));
}

template <int RULE>
__global__ void __launch_bounds__(kThreads)
norms_kernel(const int64_t* __restrict__ table, const float* __restrict__ norms,
             NormArgs a, double* __restrict__ partial) {
  __shared__ double red[kThreads / 32];
  const Header h = header(table);
  if (h.skip) return;  // a non-finite step: nothing is written
  const Chunk ch = chunk_at(table, h.n_tensors, blockIdx.x);
  const int64_t* e = entry(table, ch.tensor);
  float c1 = 1.f, c2 = 1.f;
  if (RULE == kLamb) corrections(a, h.step, c1, c2);
  double sa = 0.0, sp = 0.0;
  by_types(e, [&](auto tp, auto tg) {
    norms_chunk<RULE, decltype(tp), decltype(tg)>(e, ch.tensor, ch, a, norms,
                                                  h.n_tensors, c1, c2, sa, sp);
  });
  sa = block_sum_d(sa, red);
  sp = block_sum_d(sp, red);
  if (threadIdx.x == 0) {
    partial[2 * (int64_t)blockIdx.x] = sa;
    partial[2 * (int64_t)blockIdx.x + 1] = sp;
  }
}

template <int RULE, typename T, typename TG>
__device__ void norm_apply_chunk(const int64_t* e, int i, const Chunk& ch,
                                 const NormArgs& a, const float* norms, int n,
                                 float c1, float c2, float wd, float rate) {
  T* p = reinterpret_cast<T*>(e[kP]) + ch.off;
  const TG* g = reinterpret_cast<const TG*>(e[kG]) + ch.off;
  T* m = reinterpret_cast<T*>(e[kS0]) + ch.off;  // Lamb moment1, LARS velocity
  T* v = RULE == kLamb ? reinterpret_cast<T*>(e[kS1]) + ch.off : nullptr;
  const int64_t fl = e[kFlags];
  const Prep<T, TG> prep = make_prep<T, TG>(a.clip, norms, n, i, 0.f, false);
  // rate: Lamb lr * trust, LARS local_lr
  auto one = [&](float& pf, float gq, float& mf, float& vf) {
    const float x = prep(gq, pf);
    if (RULE == kLamb) {
      const float r = lamb_r(a, c1, c2, wd, x, pf, mf, vf);
      pf = Elem<T>::rnd(fsub(pf, fmul(rate, r)));
    } else {
      mf = fadd(fmul(a.mu, mf), fmul(rate, fadd(x, fmul(wd, pf))));
      pf = Elem<T>::rnd(fsub(pf, mf));
    }
  };
  const int64_t len = ch.len;
  const int64_t vend = (fl & kVec) ? (len & ~(int64_t)7) : 0;
  for (int64_t j = (int64_t)threadIdx.x * 8; j < vend; j += kThreads * 8) {
    float pf[8], gf[8], mf[8], vf[8] = {};
    Elem<T>::ld8(p + j, pf);
    Elem<TG>::ld8(g + j, gf);
    Elem<T>::ld8(m + j, mf);
    if (RULE == kLamb) Elem<T>::ld8(v + j, vf);
#pragma unroll
    for (int q = 0; q < 8; ++q) one(pf[q], gf[q], mf[q], vf[q]);
    Elem<T>::st8(p + j, pf);
    Elem<T>::st8(m + j, mf);
    if (RULE == kLamb) Elem<T>::st8(v + j, vf);
  }
  for (int64_t j = vend + threadIdx.x; j < len; j += kThreads) {
    float pf = Elem<T>::ld(p + j), mf = Elem<T>::ld(m + j);
    float vf = RULE == kLamb ? Elem<T>::ld(v + j) : 0.f;
    one(pf, Elem<TG>::ld(g + j), mf, vf);
    Elem<T>::st(p + j, pf);
    Elem<T>::st(m + j, mf);
    if (RULE == kLamb) Elem<T>::st(v + j, vf);
  }
}

// a tensor's two sums from its chunk partials, in the order every block of
// norm_apply_kernel takes them
__device__ __forceinline__ void tensor_sums(const int64_t* e,
                                            const double* partial, double* red,
                                            double& sa, double& sp) {
  sa = 0.0;
  sp = 0.0;
  for (int64_t c = e[kChunkBegin] + threadIdx.x; c < e[kChunkEnd]; c += kThreads) {
    sa = dadd(sa, partial[2 * c]);
    sp = dadd(sp, partial[2 * c + 1]);
  }
  sa = block_sum_d(sa, red);
  sp = block_sum_d(sp, red);
}

// a split step: each tensor's two sums into sums[2 i], sums[2 i + 1], for
// the sums over the ranks that split it (one block a tensor)
__global__ void __launch_bounds__(kThreads)
norm_sums_kernel(const int64_t* __restrict__ table,
                 const double* __restrict__ partial, double* __restrict__ sums) {
  __shared__ double red[kThreads / 32];
  const Header h = header(table);
  if (h.skip) return;
  double sa, sp;
  tensor_sums(entry(table, blockIdx.x), partial, red, sa, sp);
  if (threadIdx.x == 0) {
    sums[2 * blockIdx.x] = sa;
    sums[2 * blockIdx.x + 1] = sp;
  }
}

// sums (a split step): each tensor's sums over the ranks; null: re-summed
// from this rank's partials
template <int RULE>
__global__ void __launch_bounds__(kThreads)
norm_apply_kernel(const int64_t* __restrict__ table, const float* __restrict__ norms,
                  NormArgs a, const double* __restrict__ partial,
                  const double* __restrict__ sums) {
  __shared__ double red[kThreads / 32];
  const Header h = header(table);
  if (h.skip) return;  // a non-finite step: nothing is written
  const Chunk ch = chunk_at(table, h.n_tensors, blockIdx.x);
  const int64_t* e = entry(table, ch.tensor);
  // the tensor's sums, in the same order in every one of its blocks
  double sa, sp;
  if (sums != nullptr) {
    sa = sums[2 * ch.tensor];
    sp = sums[2 * ch.tensor + 1];
  } else {
    tensor_sums(e, partial, red, sa, sp);
  }
  const float an = sqrtf((float)sa), pn = sqrtf((float)sp);
  const float wd = (e[kFlags] & kDecay) ? a.wd : 0.f;
  float c1 = 1.f, c2 = 1.f, rate;
  if (RULE == kLamb) {
    corrections(a, h.step, c1, c2);
    const float trust = (pn > 0.f && an > 0.f) ? fdiv(pn, an) : 1.f;
    rate = fmul(h.lr, trust);
  } else {
    const float den = fadd(fadd(an, fmul(wd, pn)), a.eps);
    rate = (pn > 0.f && den > 0.f) ? fdiv(fmul(fmul(h.lr, a.coeff), pn), den)
                                   : h.lr;
  }
  by_types(e, [&](auto tp, auto tg) {
    norm_apply_chunk<RULE, decltype(tp), decltype(tg)>(
        e, ch.tensor, ch, a, norms, h.n_tensors, c1, c2, wd, rate);
  });
}

// ---------------------------------------------------------------------------
// (g) GradScaler's unscale (paddle_tpu/amp/grad_scaler.py:52-67; Paddle's
// check_finite_and_unscale): finite_kernel tests every g * (1 / scale) in
// fp32 and sets one flag where any is not finite (any block may set it, in
// any order: nothing is summed); the host reads the flag, and only where
// it is 0 launches unscale_kernel, which writes cast(g * inv) in place.
// Bytes bound them: the check reads g, the unscale reads and writes it.

constexpr float kFloatMax = 3.402823466e38f;

template <typename TG>
__device__ bool finite_chunk(const TG* g, int64_t len, bool vec, float inv) {
  bool bad = false;
  const int64_t vend = vec ? (len & ~(int64_t)7) : 0;
  for (int64_t j = (int64_t)threadIdx.x * 8; j < vend; j += kThreads * 8) {
    float x[8];
    Elem<TG>::ld8(g + j, x);
#pragma unroll
    for (int q = 0; q < 8; ++q) bad |= !(fabsf(fmul(x[q], inv)) <= kFloatMax);
  }
  for (int64_t j = vend + threadIdx.x; j < len; j += kThreads)
    bad |= !(fabsf(fmul(Elem<TG>::ld(g + j), inv)) <= kFloatMax);
  return bad;
}

__global__ void __launch_bounds__(kThreads)
finite_kernel(const int64_t* __restrict__ table, float inv,
              const float* __restrict__ inv_dev, int* __restrict__ flag) {
  if (inv_dev) inv = *inv_dev;
  const Header h = header(table);
  const Chunk ch = chunk_at(table, h.n_tensors, blockIdx.x);
  const int64_t* e = entry(table, ch.tensor);
  const bool vec = e[kFlags] & kVec;
  const bool bad = by_types(e, [&](auto, auto tg) {
    using TG = decltype(tg);
    return finite_chunk(reinterpret_cast<const TG*>(e[kG]) + ch.off, ch.len,
                        vec, inv);
  });
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1;
}

template <typename TG>
__device__ void unscale_chunk(TG* g, int64_t len, bool vec, float inv) {
  const int64_t vend = vec ? (len & ~(int64_t)7) : 0;
  for (int64_t j = (int64_t)threadIdx.x * 8; j < vend; j += kThreads * 8) {
    float x[8];
    Elem<TG>::ld8(g + j, x);
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = fmul(x[q], inv);
    Elem<TG>::st8(g + j, x);
  }
  for (int64_t j = vend + threadIdx.x; j < len; j += kThreads)
    Elem<TG>::st(g + j, fmul(Elem<TG>::ld(g + j), inv));
}

__global__ void __launch_bounds__(kThreads)
unscale_kernel(const int64_t* __restrict__ table, float inv,
               const float* __restrict__ inv_dev) {
  if (inv_dev) inv = *inv_dev;
  const Header h = header(table);
  const Chunk ch = chunk_at(table, h.n_tensors, blockIdx.x);
  const int64_t* e = entry(table, ch.tensor);
  const bool vec = e[kFlags] & kVec;
  by_types(e, [&](auto, auto tg) {
    using TG = decltype(tg);
    unscale_chunk(reinterpret_cast<TG*>(e[kG]) + ch.off, ch.len, vec, inv);
  });
}

Clip make_clip(int mode, float lo, float hi) {
  Clip c;
  c.mode = mode;
  c.lo = lo;
  c.hi = hi;
  return c;
}

}  // namespace

// (a): partial [n_chunks] scratch; out [2 n_tensors + 1] = per-tensor sums
// of squares, per-tensor clip scales, global sum; scale_mode 0 gives every
// scale 1, 1 scales each tensor by its own norm, 2 all by the global norm
extern "C" int pt_opt_sumsq(const void* table, int n_chunks, void* partial,
                            float clip_norm, int scale_mode, void* out,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* t = (const int64_t*)table;
  if (n_chunks > 0)
    sumsq_partial_kernel<<<n_chunks, kThreads, 0, st>>>(t, (float*)partial);
  sumsq_finish_kernel<<<1, kFinishThreads, 0, st>>>(
      t, (const float*)partial, clip_norm, scale_mode, (float*)out);
  return (int)cudaGetLastError();
}

// (b): norms from pt_opt_sumsq (clip_mode 1) or null
extern "C" int pt_opt_adam(const void* table, int n_chunks, const void* norms,
                           float b1, float b2, float omb1, float omb2,
                           float eps, float wd, int decoupled, int clip_mode,
                           float lo, float hi, void* stream) {
  if (n_chunks == 0) return (int)cudaGetLastError();
  AdamArgs a;
  a.b1 = b1;
  a.b2 = b2;
  a.omb1 = omb1;
  a.omb2 = omb2;
  a.eps = eps;
  a.wd = wd;
  a.decoupled = decoupled;
  a.clip = make_clip(clip_mode, lo, hi);
  adam_kernel<<<n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)table, (const float*)norms, a);
  return (int)cudaGetLastError();
}

static FactorArgs factor_args(float decay, float eps1, float wd, int clip_mode,
                              float lo, float hi, int need_p, int seg_cols,
                              float b1, float omb1, float eps2,
                              float clip_threshold, int pscale) {
  FactorArgs a;
  a.decay = decay;
  a.eps1 = eps1;
  a.wd = wd;
  a.clip = make_clip(clip_mode, lo, hi);
  a.need_p = need_p;
  a.seg_cols = seg_cols;
  a.b1 = b1;
  a.omb1 = omb1;
  a.eps2 = eps2;
  a.clip_threshold = clip_threshold;
  a.pscale = pscale;
  return a;
}

// (c): colpart [sum over factored chunks of C] and pspart [n_chunks] scratch;
// stats [n_tensors + n_matrices] out
// rowsum and colsum (nullable; a split step): each factored tensor's raw
// row sums and column sums land there (at its kSplitBase offsets) and its
// vr, vc and mean(vr) are left to pt_opt_adafactor_split_finish
extern "C" int pt_opt_adafactor_stats(const void* table, int n_tensors,
                                      int n_chunks, int n_matrices,
                                      const void* norms, float decay,
                                      float eps1, float wd, int clip_mode,
                                      float lo, float hi, int need_p,
                                      int seg_cols, void* colpart,
                                      void* pspart, void* stats,
                                      void* rowsum, void* colsum,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* t = (const int64_t*)table;
  const FactorArgs a = factor_args(decay, eps1, wd, clip_mode, lo, hi, need_p,
                                   seg_cols, 0.f, 0.f, 0.f, 1.f, 0);
  const size_t smem = sizeof(float) * ((size_t)kMaxTileRows +
                                       (size_t)kStatsWarps * seg_cols);
  cudaError_t err = cudaFuncSetAttribute(
      adafactor_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_chunks > 0)
    adafactor_stats_kernel<<<n_chunks, kStatsThreads, smem, st>>>(
        t, (const float*)norms, a, (float*)colpart, (float*)pspart,
        (float*)rowsum);
  if (n_matrices + n_tensors > 0)
    adafactor_finish_kernel<<<n_matrices + n_tensors, kThreads, 0, st>>>(
        t, n_matrices, a, (const float*)colpart, (const float*)pspart,
        (float*)stats, (float*)colsum);
  return (int)cudaGetLastError();
}

// (c) over split tensors, the finish after the sums over the ranks:
// rowsum and colsum as pt_opt_adafactor_stats wrote them and the ranks
// summed them; fulls [3 n_tensors] each whole tensor's numel, C, R;
// stats[n_tensors + m] gets each matrix's sum of its new vr
extern "C" int pt_opt_adafactor_split_finish(const void* table, int n_matrices,
                                             float decay, const void* rowsum,
                                             const void* colsum,
                                             const void* fulls, void* stats,
                                             void* stream) {
  if (n_matrices == 0) return (int)cudaGetLastError();
  const FactorArgs a = factor_args(decay, 0.f, 0.f, 0, 0.f, 0.f, 0, 0, 0.f,
                                   0.f, 0.f, 1.f, 0);
  adafactor_split_finish_kernel<<<n_matrices, kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const int64_t*)table, a, (const float*)rowsum, (const float*)colsum,
      (const float*)fulls, (float*)stats);
  return (int)cudaGetLastError();
}

// (d): stats from pt_opt_adafactor_stats; uspart [n_chunks] scratch.
// phase 0: both passes. A split step runs phase 1 (the u^2 pass and each
// tensor's sum into usq [n_tensors]), sums usq over the ranks, then phase
// 2 (the update from usq, with fulls' whole numels)
extern "C" int pt_opt_adafactor_update(const void* table, int n_tensors,
                                       int n_chunks, const void* norms,
                                       const void* stats, void* uspart,
                                       float b1, float omb1, float eps2,
                                       float clip_threshold, int pscale,
                                       float wd, int clip_mode, float lo,
                                       float hi, int phase, void* usq,
                                       const void* fulls, void* stream) {
  if (n_chunks == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* t = (const int64_t*)table;
  const FactorArgs a = factor_args(0.f, 0.f, wd, clip_mode, lo, hi, 1, 0, b1,
                                   omb1, eps2, clip_threshold, pscale);
  if (phase != 2)
    adafactor_usq_kernel<<<n_chunks, kThreads, 0, st>>>(
        t, (const float*)norms, a, (const float*)stats, (float*)uspart);
  if (phase == 1) {
    adafactor_usq_sum_kernel<<<n_tensors, kThreads, 0, st>>>(
        t, (const float*)uspart, (float*)usq);
    return (int)cudaGetLastError();
  }
  adafactor_apply_kernel<<<n_chunks, kThreads, 0, st>>>(
      t, (const float*)norms, a, (const float*)stats, (const float*)uspart,
      phase == 2 ? (const float*)usq : nullptr,
      phase == 2 ? (const float*)fulls : nullptr);
  return (int)cudaGetLastError();
}

// (e): rule kSGD..kAdadelta, h and opt as RuleArgs; norms from pt_opt_sumsq
// (clip_mode 1) or null
extern "C" int pt_opt_rule(const void* table, int n_chunks, const void* norms,
                           int rule, float h0, float h1, float h2, float h3,
                           int opt, float wd, int clip_mode, float lo,
                           float hi, void* stream) {
  if (rule < kSGD || rule > kAdadelta) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaGetLastError();
  RuleArgs a;
  a.h[0] = h0;
  a.h[1] = h1;
  a.h[2] = h2;
  a.h[3] = h3;
  a.opt = opt;
  a.wd = wd;
  a.clip = make_clip(clip_mode, lo, hi);
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* t = (const int64_t*)table;
  const float* nm = (const float*)norms;
  switch (rule) {
    case kSGD: rule_kernel<kSGD><<<n_chunks, kThreads, 0, st>>>(t, nm, a); break;
    case kMomentum: rule_kernel<kMomentum><<<n_chunks, kThreads, 0, st>>>(t, nm, a); break;
    case kAdagrad: rule_kernel<kAdagrad><<<n_chunks, kThreads, 0, st>>>(t, nm, a); break;
    case kAdamax: rule_kernel<kAdamax><<<n_chunks, kThreads, 0, st>>>(t, nm, a); break;
    case kRMSProp: rule_kernel<kRMSProp><<<n_chunks, kThreads, 0, st>>>(t, nm, a); break;
    default: rule_kernel<kAdadelta><<<n_chunks, kThreads, 0, st>>>(t, nm, a); break;
  }
  return (int)cudaGetLastError();
}

// (f): rule kLamb or kLars; partial [2 n_chunks] fp64 scratch. phase 0:
// both passes. A split step runs phase 1 (the norms pass and each
// tensor's two sums into sums [2 n_tensors]), sums them over the ranks,
// then phase 2 (the update from sums)
extern "C" int pt_opt_norm_rule(const void* table, int n_tensors,
                                int n_chunks, const void* norms, int rule,
                                float b1, float b2, float omb1, float omb2,
                                float eps, float wd, float coeff, float mu,
                                int clip_mode, float lo, float hi,
                                void* partial, int phase, void* sums,
                                void* stream) {
  if (rule != kLamb && rule != kLars) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaGetLastError();
  NormArgs a;
  a.b1 = b1;
  a.b2 = b2;
  a.omb1 = omb1;
  a.omb2 = omb2;
  a.eps = eps;
  a.wd = wd;
  a.coeff = coeff;
  a.mu = mu;
  a.clip = make_clip(clip_mode, lo, hi);
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* t = (const int64_t*)table;
  const float* nm = (const float*)norms;
  double* part = (double*)partial;
  const double* all = phase == 2 ? (const double*)sums : nullptr;
  if (phase != 2) {
    if (rule == kLamb)
      norms_kernel<kLamb><<<n_chunks, kThreads, 0, st>>>(t, nm, a, part);
    else
      norms_kernel<kLars><<<n_chunks, kThreads, 0, st>>>(t, nm, a, part);
  }
  if (phase == 1) {
    norm_sums_kernel<<<n_tensors, kThreads, 0, st>>>(t, part, (double*)sums);
    return (int)cudaGetLastError();
  }
  if (rule == kLamb)
    norm_apply_kernel<kLamb><<<n_chunks, kThreads, 0, st>>>(t, nm, a, part, all);
  else
    norm_apply_kernel<kLars><<<n_chunks, kThreads, 0, st>>>(t, nm, a, part, all);
  return (int)cudaGetLastError();
}

// (g): flag [1] int32, zeroed here, then 1 where some g * inv is not finite;
// inv_dev (fp32 [1] on the device, nullable) gives the inverse scale in
// place of inv, so a captured graph reads the scale of each replay
extern "C" int pt_opt_check_finite(const void* table, int n_chunks, float inv,
                                   const void* inv_dev, void* flag,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n_chunks > 0)
    finite_kernel<<<n_chunks, kThreads, 0, st>>>(
        (const int64_t*)table, inv, (const float*)inv_dev, (int*)flag);
  return (int)cudaGetLastError();
}

extern "C" int pt_opt_unscale(const void* table, int n_chunks, float inv,
                              const void* inv_dev, void* stream) {
  if (n_chunks > 0)
    unscale_kernel<<<n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)table, inv, (const float*)inv_dev);
  return (int)cudaGetLastError();
}

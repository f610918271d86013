// Rotate-half rotary position embedding (RoPE) for Hopper (sm_90a), and its
// inverse, which is its VJP.
//
// Replaces the TPU kernel `_rope_kernel` (paddle_tpu/kernels/pallas/rope.py:50),
// launched by `_rope_pallas` (:63, call :66). Same function on x [b, s, h, d],
// d even, with half = d / 2:
//   out[..., i]        = x1 * cos(f) - x2 * sin(f)
//   out[..., half + i] = x2 * cos(f) + x1 * sin(f)
// where x1 = x[..., i], x2 = x[..., half + i], f = (pos_offset + s) * inv_i
// and inv_i = exp(i * (-2/d) * ln(theta)), computed in fp32 in the kernel as
// `_angles` (:38-47) does: no cos/sin tables in device memory. `inverse`
// negates sin: a rotation is orthogonal, so the VJP applies the inverse
// rotation to the cotangent and saves nothing (`_rope4_bwd`, :108).
//
// Angles use the precise sincosf (this library is built without
// --use_fast_math): at position 2047 the argument is about 2000 rad, where
// the fast intrinsics lose the angle.
//
// What bounds it on the H100: bytes (one read and one write of x, a few
// FLOPs per element pair, well under the tensor-core ratio of ~295 FLOPs per
// byte): [4, 2048, 16, 128] bf16 is 0.0200 ms over 3.35 TB/s.
//
// What the design does about it:
// - Angles once per (position, frequency) per block. A block takes a tile
//   of positions and a share of the batch rows (all of them at the training
//   shapes), computes cos and sin for its tile's positions x d/2
//   frequencies into shared memory, and reuses them for every head and
//   batch row it covers: the precise sincosf runs b*h times less often than
//   once per element pair.
// - 16-byte vectors. A thread's unit is a vector of the first half of one
//   (b, s, h) row and the matching vector of the second half: 8 bf16 or 4
//   fp32 pairs rotated per unit. A thread issues the loads of kBatch units
//   before its first store, and keeps them raw (16 bytes) until it rotates
//   them. Threads along x take the units of one (b, s) slab (heads x
//   vectors), so a warp reads whole runs of each head row. The first batch
//   is loaded before the angle table is computed.
// - Many small blocks: a tile of a few positions (2 at the training
//   shapes) and about 8 blocks a SM, which measured faster on the H100 than
//   2 blocks a SM with 4 times the tile.
// - 32-bit index arithmetic from blockIdx and loop counters (the head and
//   vector of a unit are divided out once per thread); 64-bit only in the
//   strided offsets.
// - x is read through its (b, s, h) strides with d contiguous, so the
//   inverse reads the cotangent in the layout the attention backward leaves
//   it ([b, s, h, d] view of [b, h, s, d]) and the transpose happens here;
//   out is written contiguous [b, s, h, d].
// - The scalar instance (VEC 1) takes rows that are not whole 16-byte
//   vectors or that start off a 16-byte boundary, one pair per unit. The
//   caller picks the instance (`rope_plan` in rope.py).

#include <type_traits>

#include "attention_common.cuh"
#include "vec16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;            // units whose loads precede the stores
constexpr int kBlocksPerSm = 8;      // the grid aims at this many blocks a SM
constexpr int kTableBytes = 48 * 1024;

// One half of a unit as it is loaded (16 raw bytes, or one element for the
// scalar instance), converted to fp32 only when it is rotated: keeping the
// loads raw halves the registers that kBatch units in flight take.
template <typename T, int VEC>
struct Units {
  using Raw = typename std::conditional<VEC == 1, T, uint4>::type;

  __device__ __forceinline__ static Raw load(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ static void to_f(const Raw& r, float* v) {
    if constexpr (VEC == 1) {
      v[0] = pt::to_f(r);
    } else {
      pt::Vec16<T>::load(reinterpret_cast<const T*>(&r), v);
    }
  }
  // VEC angles from the shared table (16-byte aligned for VEC 4 and 8)
  __device__ __forceinline__ static void angles(const float* t, float* v) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q)
        *reinterpret_cast<float4*>(v + 4 * q) =
            reinterpret_cast<const float4*>(t)[q];
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = t[e];
    }
  }
  __device__ __forceinline__ static void store(T* p, const float* v) {
    if constexpr (VEC == 1) {
      *p = pt::from_f<T>(v[0]);
    } else {
      pt::Vec16<T>::store(p, v);
    }
  }
};

// grid (ceil(S / tile), bsplit): block (x, y) takes positions
// [x * tile, x * tile + tile) of batch rows y, y + bsplit, ...; tx_n threads
// along the units of a slab, blockDim.x / tx_n slabs at a time. A thread's
// first kBatch units are loaded before the angle table is computed, so
// their latency overlaps the sincosf work.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int S,
            int H, int half, long long sb, long long ss, long long sh,
            int tile, int tx_n, float neg2_over_d, float ln_theta,
            int pos_offset, float sin_sign) {
  using U = Units<T, VEC>;
  extern __shared__ __align__(16) float table[];  // cos, then sin [tile][half]
  const int s0 = blockIdx.x * tile;
  const int len = min(tile, S - s0);
  float* cos_t = table;
  float* sin_t = table + tile * half;
  const int vph = half / VEC;  // units per half row
  const int units = H * vph;   // units per (b, s) slab
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int ty_n = blockDim.x / tx_n;
  const int bsplit = gridDim.y;
  const int rows = (B - (int)blockIdx.y + bsplit - 1) / bsplit;
  const int slabs = rows * len;

  // units j0 + r * ty_n (r < kBatch) of column u: slab j is batch row
  // blockIdx.y + (j / len) * bsplit at position s0 + j % len
  typename U::Raw a[kBatch], c[kBatch];
  auto load_batch = [&](int u, int j0) {
    const int head = u / vph, i0 = (u - head * vph) * VEC;
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int j = j0 + r * ty_n;
      if (j < slabs) {
        const int bl = j / len, p = j - bl * len;
        const T* row = x + ((int)blockIdx.y + bl * bsplit) * sb +
                       (s0 + p) * ss + head * sh;
        a[r] = U::load(row + i0);
        c[r] = U::load(row + half + i0);
      }
    }
  };
  bool loaded = tx < units && ty < slabs;
  if (loaded) load_batch(tx, ty);

  for (int e = threadIdx.x; e < len * half; e += blockDim.x) {
    const int p = e / half, i = e - p * half;
    const float inv = expf((float)i * neg2_over_d * ln_theta);
    const float f = (float)(pos_offset + s0 + p) * inv;
    float sn, cs;
    sincosf(f, &sn, &cs);
    cos_t[e] = cs;
    sin_t[e] = sn * sin_sign;
  }
  __syncthreads();

  for (int u = tx; u < units; u += tx_n) {
    const int head = u / vph, i0 = (u - head * vph) * VEC;
    for (int j0 = ty; j0 < slabs; j0 += ty_n * kBatch) {
      if (!loaded) load_batch(u, j0);
      loaded = false;
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int j = j0 + r * ty_n;
        if (j < slabs) {
          const int bl = j / len, p = j - bl * len;
          const int bb = (int)blockIdx.y + bl * bsplit;
          float x1[VEC], x2[VEC], cs[VEC], sn[VEC], o1[VEC], o2[VEC];
          U::to_f(a[r], x1);
          U::to_f(c[r], x2);
          U::angles(cos_t + p * half + i0, cs);
          U::angles(sin_t + p * half + i0, sn);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            o1[e] = x1[e] * cs[e] - x2[e] * sn[e];
            o2[e] = x2[e] * cs[e] + x1[e] * sn[e];
          }
          T* orow = out + (((long long)bb * S + s0 + p) * H + head) *
                              (2 * half);
          U::store(orow + i0, o1);
          U::store(orow + half + i0, o2);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* out, int b, int S, int H, int d,
           float ln_theta, int pos_offset, int inverse, int vec,
           long long sb, long long ss, long long sh, int sms,
           cudaStream_t st) {
  const int half = d / 2;
  constexpr int V = pt::Vec16<T>::N;
  const int units = H * (vec ? half / V : half);
  const int tx_n = units < kThreads ? units : kThreads;
  const int threads = tx_n * (kThreads / tx_n);
  // about kBlocksPerSm blocks a SM over the positions; the batch rows are
  // split over grid.y only when the positions give too few blocks (decode)
  const int want = kBlocksPerSm * (sms > 0 ? sms : 1);
  int tile = (S + want - 1) / want;
  const int fit = kTableBytes / (2 * (int)sizeof(float) * half);
  if (fit < 1) return (int)cudaErrorInvalidValue;
  if (tile > fit) tile = fit;
  const int gx = (S + tile - 1) / tile;
  int gy = want / gx;
  gy = gy < 1 ? 1 : gy > b ? b : gy;
  const size_t smem = 2 * sizeof(float) * (size_t)tile * half;
  const dim3 grid(gx, gy);
  const float neg2 = -2.0f / (float)d, sign = inverse ? -1.f : 1.f;
  if (vec)
    rope_kernel<T, V><<<grid, threads, smem, st>>>(
        (const T*)x, (T*)out, b, S, H, half, sb, ss, sh, tile, tx_n, neg2,
        ln_theta, pos_offset, sign);
  else
    rope_kernel<T, 1><<<grid, threads, smem, st>>>(
        (const T*)x, (T*)out, b, S, H, half, sb, ss, sh, tile, tx_n, neg2,
        ln_theta, pos_offset, sign);
  return (int)cudaGetLastError();
}

}  // namespace

// x [b, S, H, d] read through its strides sb, ss, sh (in elements; d
// contiguous), out [b, S, H, d] contiguous, d even. ln_theta = ln(theta) in
// fp32. dtype: 0 = float32, 1 = bfloat16. vec 1: the 16-byte vector
// instance (d/2 elements a whole number of 16-byte vectors; x, and every
// stride of a dim longer than 1, 16-byte aligned); vec 0: the scalar one.
// sms: the card's SM count. Returns the first CUDA error.
extern "C" int pt_rope(const void* x, void* out, int b, int S, int H, int d,
                       float ln_theta, int pos_offset, int inverse, int dtype,
                       long long sb, long long ss, long long sh, int vec,
                       int sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)b * S * H * d == 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return launch<float>(x, out, b, S, H, d, ln_theta, pos_offset, inverse,
                         vec, sb, ss, sh, sms, st);
  return launch<__nv_bfloat16>(x, out, b, S, H, d, ln_theta, pos_offset,
                               inverse, vec, sb, ss, sh, sms, st);
}

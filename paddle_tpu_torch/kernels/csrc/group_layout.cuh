// The device-side row-group schedule of the grouped GEMM kernels
// (grouped_matmul.cu on the CUDA cores, grouped_matmul_sm90.cu on the
// tensor cores). The group sizes stay on the device: each block of 256
// threads scans the <= 128 sizes in shared memory, so the host never learns
// them and a step does not wait on the card.
#pragma once

#include <cuda_runtime.h>

namespace pt {

constexpr int kGroupThreads = 256;  // threads of every block that calls it
constexpr int kGroupTile = 128;     // rows of one forward / dgrad row tile
constexpr int kMaxGroups = 128;

// Row range of every group in shared memory: group g < G covers rows
// [start[g], end[g]) (exclusive prefix of the sizes, negatives as 0,
// clamped to [0, M)); entry G covers the rows past the last group. tile0[g]
// is the exclusive prefix of the groups' kGroupTile-row tile counts, so a
// grid of ceil(M / kGroupTile) + G + 1 row tiles covers every group (each
// wastes at most one partial tile) and the rows past the last one.
struct GroupLayout {
  int start[kMaxGroups + 1];
  int end[kMaxGroups + 1];
  int tile0[kMaxGroups + 2];
  long long wsum[kGroupThreads / 32];
  int wtiles[kGroupThreads / 32];
};

// All kGroupThreads threads of the block call it; it ends in
// __syncthreads().
__device__ inline void group_layout(const int* __restrict__ sizes, int G,
                                    int M, GroupLayout& L) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  long long size = t < G ? (long long)max(sizes[t], 0) : 0;
  // inclusive scan of the sizes over t (warp shuffles, then warp totals)
  long long inc = size;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long n = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += n;
  }
  if (lane == 31) L.wsum[warp] = inc;
  __syncthreads();
  for (int w = 0; w < warp; ++w) inc += L.wsum[w];
  int s = 0, e = 0;
  if (t < G) {
    s = (int)min(inc - size, (long long)M);
    e = (int)min(inc, (long long)M);
  }
  if (t == G) {
    // rows past the last group: the scan's value at G is the full sum
    s = (int)min(inc, (long long)M);
    e = M;
  }
  if (t <= G) {
    L.start[t] = s;
    L.end[t] = e;
  }
  int nt = t <= G ? (e - s + kGroupTile - 1) / kGroupTile : 0;
  int tinc = nt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, tinc, d);
    if (lane >= d) tinc += n;
  }
  if (lane == 31) L.wtiles[warp] = tinc;
  __syncthreads();
  for (int w = 0; w < warp; ++w) tinc += L.wtiles[w];
  if (t <= G) L.tile0[t] = tinc - nt;
  if (t == G) L.tile0[G + 1] = tinc;
  __syncthreads();
}

// The row tile `tile` of a forward / dgrad grid: its group (G for the rows
// past the last group, -1 past the last tile), first row and row count, the
// same for every thread of the block. Ends in __syncthreads().
struct RowTile {
  int group, row0, rows;
};

__device__ inline RowTile row_tile(const GroupLayout& L, int G, int tile,
                                   RowTile& shared) {
  const int t = threadIdx.x;
  if (t == 0) shared.group = -1;
  __syncthreads();
  if (t <= G && tile >= L.tile0[t] && tile < L.tile0[t + 1]) {
    shared.group = t;
    shared.row0 = L.start[t] + (tile - L.tile0[t]) * kGroupTile;
    shared.rows = min(kGroupTile, L.end[t] - shared.row0);
  }
  __syncthreads();
  return shared;
}

}  // namespace pt

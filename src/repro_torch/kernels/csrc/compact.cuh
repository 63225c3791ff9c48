// Ordered stream compaction, shared by compact.cu and fused_compact.cu.
//
// out[0 .. min(count, capacity)) receives value(i) for every i with
// flags[i] != 0, in ascending i; out[count .. capacity) holds the sentinel;
// *count is the full number of set flags, also when it exceeds capacity.
// value(i) is values[i], or i itself when values is null.
//
// Three launches, no atomics, so the order never depends on scheduling:
//   1. tile_counts: each block counts the set flags of its tile of kTile
//      flags (__syncthreads_count, one round of kThreads flags at a time);
//   2. scan_counts: one block turns the tile counts into exclusive tile
//      offsets in place and writes the total to *count;
//   3. tile_write: each block walks its tile again in the same rounds and
//      ranks every set flag by its tile offset, the counts of the rounds
//      before it, the counts of the warps before it (__ballot_sync and
//      __popc, warp totals in shared memory) and its lane rank; the grid
//      then fills out[count .. capacity) with the sentinel.
// The TPU kernel carries a running offset through its sequential grid in
// SMEM; CUDA blocks run concurrently, so the tile offsets come from pass 2.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace compact {

constexpr int kThreads = 256;
constexpr int kRounds = 8;
constexpr int kTile = kThreads * kRounds;
constexpr int kScanThreads = 1024;

inline int n_tiles(int64_t n) {
  const int64_t t = (n + kTile - 1) / kTile;
  return t < 1 ? 1 : (int)t;
}

__global__ void __launch_bounds__(kThreads)
tile_counts(const uint8_t* __restrict__ flags, int64_t n,
            int* __restrict__ counts) {
  const int64_t start = (int64_t)blockIdx.x * kTile + threadIdx.x;
  int total = 0;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + (int64_t)r * kThreads;
    total += __syncthreads_count(i < n && flags[i] != 0);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
scan_counts(int* __restrict__ counts, int n_tiles, int* __restrict__ total) {
  __shared__ int sums[kScanThreads];
  const int t = threadIdx.x;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = t * per;
  const int hi = min(lo + per, n_tiles);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += counts[i];
  sums[t] = own;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int add = t >= off ? sums[t - off] : 0;
    __syncthreads();
    sums[t] += add;
    __syncthreads();
  }
  int run = sums[t] - own;
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (t == kScanThreads - 1) *total = sums[t];
}

__global__ void __launch_bounds__(kThreads)
tile_write(const uint8_t* __restrict__ flags, const int* __restrict__ values,
           int64_t n, const int* __restrict__ offsets,
           const int* __restrict__ total, int* __restrict__ out,
           int64_t capacity, int sentinel) {
  __shared__ int warp_counts[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t start = (int64_t)blockIdx.x * kTile + threadIdx.x;
  int64_t run = offsets[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + (int64_t)r * kThreads;
    const bool f = i < n && flags[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, round_total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int c = warp_counts[w];
      before += w < warp ? c : 0;
      round_total += c;
    }
    if (f) {
      const int64_t pos = run + before + __popc(ballot & ((1u << lane) - 1u));
      if (pos < capacity) out[pos] = values != nullptr ? values[i] : (int)i;
    }
    run += round_total;
    __syncthreads();
  }
  const int64_t count = *total;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x; p < capacity;
       p += stride)
    if (p >= count) out[p] = sentinel;
}

// scratch holds n_tiles(n) ints. Returns a cudaError_t code.
inline int launch(const uint8_t* flags, const int* values, int64_t n,
                  int64_t capacity, int sentinel, int* out, int* count,
                  int* scratch, cudaStream_t stream) {
  const int tiles = n_tiles(n);
  tile_counts<<<tiles, kThreads, 0, stream>>>(flags, n, scratch);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scan_counts<<<1, kScanThreads, 0, stream>>>(scratch, tiles, count);
  err = (int)cudaGetLastError();
  if (err) return err;
  tile_write<<<tiles, kThreads, 0, stream>>>(flags, values, n, scratch, count,
                                             out, capacity, sentinel);
  return (int)cudaGetLastError();
}

}  // namespace compact

// Ordered stream compaction, shared by compact.cu and fused_compact.cu.
//
// out[0 .. min(count, capacity)) receives value(i) for every i with
// flags[i] != 0, in ascending i; out[count .. capacity) holds the sentinel;
// *count is the full number of set flags, also when it exceeds capacity.
// value(i) is values[i], or i itself when values is null.
//
// One kernel launch, a single-pass scan with decoupled look-back:
//   - each block takes a ticket from a device-wide counter. Tickets below
//     the number of scan tiles T are scan tiles of kTile flags in ticket
//     order, so a tile only ever waits on tiles that have already started
//     (and publish without waiting): no deadlock, however many tiles there
//     are beside the resident ones;
//   - a scan tile reads its flags once (two 16-byte loads a thread into
//     shared memory), counts them with one warp ballot per round of
//     kThreads flags (the ballots kept in shared memory, so that the
//     kernel fits 32 registers and 8 blocks an SM), scans the (round,
//     warp) counts and publishes its aggregate in its status word. Its
//     first warp then looks back over the status words of the 32 tiles
//     before it at a time, summing aggregates until it meets an inclusive
//     prefix, and publishes its own inclusive prefix. Every set flag is
//     ranked by the tile's exclusive prefix, the counts of the (round,
//     warp) pairs before it and its lane rank in the ballot: positions
//     never come from atomics, so the order never depends on scheduling.
//     Tile T - 1 writes *count;
//   - tickets from T on are fill blocks of kTile output slots each: they
//     wait only on tile T - 1's inclusive prefix, the count, and write the
//     sentinel at their slots from the count on.
// A status word is 64 bits: the state (0 not ready, kAggregate, kInclusive)
// in the top two bits and the value below, stored with release and loaded
// with acquire semantics at device scope. The ticket and the T status
// words are zeroed by one cudaMemsetAsync on the same stream just before
// the launch; a memset is a stream operation of its own, not a kernel.
// The TPU kernel carries a running offset through its sequential grid in
// SMEM; CUDA blocks run concurrently, so the offsets come from the
// look-back.
#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace compact {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 2;                   // 16-byte flag loads a thread
constexpr int kRounds = 16 * kLoads;        // ballot rounds a tile
constexpr int kTile = kThreads * kRounds;   // 8192 flags or output slots
constexpr int kPairs = kRounds * kWarps;    // (round, warp) counts: 256
constexpr unsigned kFull = 0xffffffffu;
// the (round, warp) counts are scanned by whole warps, one count a thread
static_assert(kPairs % 32 == 0 && kPairs <= kThreads, "pair scan");

constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kStateMask = 3ull << 62;
constexpr unsigned long long kValueMask = ~kStateMask;

using Status = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

// Scan tiles of n flags (at least one, so that a tile writes the count).
inline int64_t scan_tiles(int64_t n) {
  const int64_t t = (n + kTile - 1) / kTile;
  return t < 1 ? 1 : t;
}

// 64-bit words of the per-call state: the ticket, then one status word per
// scan tile.
inline int64_t state_words(int64_t n) { return scan_tiles(n) + 1; }

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long state,
                                        long long value) {
  Status(*word).store(state | (unsigned long long)value,
                      cuda::memory_order_release);
}

__device__ __forceinline__ unsigned long long peek(unsigned long long* word) {
  return Status(*word).load(cuda::memory_order_acquire);
}

// The exclusive prefix of scan tile `tile` >= 1, by the 32 lanes of one
// warp: lane l reads the status word of tile base - l, every lane spins
// until each of the 32 words is published, and the window's values up to
// the nearest inclusive prefix are summed; without one the window slides
// 32 tiles back. Tile 0 publishes an inclusive prefix at once, so the walk
// ends there at the latest (lanes past it read nothing). Every lane takes
// every vote.
__device__ long long look_back(unsigned long long* status, int64_t tile) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (int64_t base = tile - 1;; base -= 32) {
    const int64_t j = base - lane;
    unsigned long long s = j < 0 ? kInclusive : 0ull;
    for (;;) {
      if ((s & kStateMask) == 0) s = peek(status + j);
      if (__all_sync(kFull, (s & kStateMask) != 0)) break;
    }
    const unsigned incl = __ballot_sync(kFull, (s & kStateMask) == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    long long v = lane <= stop ? (long long)(s & kValueMask) : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    excl += v;
    if (incl) return excl;
  }
}

__global__ void __launch_bounds__(kThreads, 8)
scan_kernel(const uint8_t* __restrict__ flags, const int* __restrict__ values,
            int64_t n, int64_t capacity, int sentinel, int* __restrict__ out,
            int* __restrict__ count, unsigned long long* __restrict__ state,
            int64_t n_scan) {
  __shared__ uint4 tile_flags[kThreads * kLoads];   // kTile flag bytes
  __shared__ unsigned ballots[kPairs];        // by (round, warp)
  __shared__ int pair_offset[kPairs];         // (round, warp) offsets
  __shared__ int part[kPairs / 32];
  __shared__ long long shared_ticket, shared_prefix;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  unsigned long long* status = state + 1;
  if (t == 0)
    shared_ticket = atomicAdd(reinterpret_cast<unsigned int*>(state), 1u);
  __syncthreads();
  const int64_t tile = shared_ticket;

  if (tile >= n_scan) {
    // a fill block: the sentinel at its slots from the count on
    const int64_t lo = (tile - n_scan) * kTile;
    if (t == 0) {
      unsigned long long s;
      do {
        s = peek(status + n_scan - 1);
      } while ((s & kStateMask) != kInclusive);
      shared_prefix = (long long)(s & kValueMask);
    }
    __syncthreads();
    const int64_t total = shared_prefix;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int64_t p = lo + r * kThreads + t;
      if (p >= total && p < capacity) out[p] = sentinel;
    }
    return;
  }

  // the tile's flags, read once
  const int64_t start = tile * kTile;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(tile_flags);
  if (start + kTile <= n && (reinterpret_cast<uintptr_t>(flags) & 15) == 0) {
    const uint4* words = reinterpret_cast<const uint4*>(flags + start);
#pragma unroll
    for (int q = 0; q < kLoads; ++q)
      tile_flags[q * kThreads + t] = __ldg(words + q * kThreads + t);
  } else {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int64_t i = start + r * kThreads + t;
      bytes[r * kThreads + t] = i < n ? flags[i] : 0;
    }
  }
  __syncthreads();

  // one ballot per round of kThreads flags; flag r * kThreads + t is lane
  // (t & 31)'s of warp (t >> 5) in round r
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned b = __ballot_sync(kFull, bytes[r * kThreads + t] != 0);
    if (lane == 0) {
      ballots[r * kWarps + warp] = b;
      pair_offset[r * kWarps + warp] = __popc(b);
    }
  }
  __syncthreads();
  // exclusive scan of the kPairs counts in (round, warp) order
  int own = 0, incl = 0;
  if (t < kPairs) {
    own = incl = pair_offset[t];
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += x;
    }
    if (lane == 31) part[warp] = incl;
  }
  __syncthreads();
  int aggregate = 0;
#pragma unroll
  for (int w = 0; w < kPairs / 32; ++w) aggregate += part[w];
  if (t < kPairs) {
    int before = 0;
#pragma unroll
    for (int w = 0; w < kPairs / 32; ++w) before += w < warp ? part[w] : 0;
    pair_offset[t] = before + incl - own;
  }

  // publish the aggregate, look back, publish the inclusive prefix
  if (warp == 0) {
    long long prefix = 0;
    if (tile == 0) {
      if (lane == 0) publish(status, kInclusive, aggregate);
    } else {
      if (lane == 0) publish(status + tile, kAggregate, aggregate);
      prefix = look_back(status, tile);
      if (lane == 0) publish(status + tile, kInclusive, prefix + aggregate);
    }
    if (lane == 0) {
      shared_prefix = prefix;
      if (tile == n_scan - 1) *count = (int)(prefix + aggregate);
    }
  }
  __syncthreads();

  // rank and write the tile's set flags
  const int64_t prefix = shared_prefix;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned b = ballots[r * kWarps + warp];
    if (b >> lane & 1u) {
      const int64_t pos = prefix + pair_offset[r * kWarps + warp] +
                          __popc(b & below);
      const int64_t i = start + r * kThreads + t;
      if (pos < capacity) out[pos] = values != nullptr ? values[i] : (int)i;
    }
  }
}

// state holds state_words(n) 64-bit words (their contents need not be
// zero: the memset below resets them). Returns a cudaError_t code.
inline int launch(const uint8_t* flags, const int* values, int64_t n,
                  int64_t capacity, int sentinel, int* out, int* count,
                  unsigned long long* state, cudaStream_t stream) {
  const int64_t n_scan = scan_tiles(n);
  const int64_t n_fill = (capacity + kTile - 1) / kTile;
  int err = (int)cudaMemsetAsync(state, 0, sizeof(*state) * state_words(n),
                                 stream);
  if (err) return err;
  scan_kernel<<<(unsigned)(n_scan + n_fill), kThreads, 0, stream>>>(
      flags, values, n, capacity, sentinel, out, count, state, n_scan);
  return (int)cudaGetLastError();
}

}  // namespace compact

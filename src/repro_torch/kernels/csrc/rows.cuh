// Shared row machinery of the row kernels (mex_window, conflict,
// fused_compact, fused_step, jpl_prio, frontier): a group of
// LPR = 2^lpr_log2 lanes (1..32) owns one row, the lanes stride over the
// row's entries, and an XOR-shuffle reduction combines their partial
// results. Groups never straddle a warp (LPR divides 32 and the block size
// is a multiple of 32), so every lane of a warp takes part in each shuffle,
// also lanes past the last row. conflict and fused_compact walk the graph's
// ELL rows themselves through the gathered-row reader at the end.
//
// Block size: kThreads by default; a launch given tile_rows > 0 (the
// tile tuner's knob, kernels/tune.py) takes tile_rows << lpr_log2 threads,
// raised to a whole number of warps and capped at kMaxThreads, so a block
// owns tile_rows rows where that fits. Any block size gives the same
// result. The kernels are instantiated twice, bounded at kThreads (the
// default and every smaller block) and at kMaxThreads, so the default
// launch keeps its register budget.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rows {

constexpr int kThreads = 256;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWindow = 256;           // 8 bitmap words of 32 bits
constexpr unsigned kFull = 0xffffffffu;

// Smallest power of two >= k, at most 32; returns its log2.
inline int lanes_log2(int k) {
  int l = 0;
  while ((1 << l) < k && l < 5) ++l;
  return l;
}

// Threads of one block for rows of 1 << lpr_log2 lanes (see the top).
inline int block_threads(int tile_rows, int lpr_log2) {
  if (tile_rows <= 0) return kThreads;
  int64_t t = ((int64_t)tile_rows << lpr_log2) + 31;
  t -= t % 32;
  return (int)(t < kMaxThreads ? t : kMaxThreads);
}

inline unsigned blocks_for(int64_t rows, int lpr_log2,
                           int threads = kThreads) {
  int64_t all = rows << lpr_log2;
  return (unsigned)((all + threads - 1) / threads);
}

// Forbidden bitmap of a color window [base, base+W), NW = ceil(W/32) words
// held in registers: every word index is a compile-time constant.
template <int NW>
struct Bitmap {
  unsigned w[NW];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = 0u;
  }
  // Marks slot rel; callers guarantee 0 <= rel < W.
  __device__ __forceinline__ void set(int rel) {
    const unsigned bit = 1u << (rel & 31);
    const int word = rel >> 5;
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] |= (word == i) ? bit : 0u;
  }
  // Marks the slot a neighbour color takes in the window, if any.
  __device__ __forceinline__ void add_color(int c, int base, int window) {
    const int rel = c - base;
    if (c >= 0 && rel >= 0 && rel < window) set(rel);
  }
  // ORs the lane group's bitmaps together (LPR = 1 << lpr_log2).
  __device__ __forceinline__ void reduce(int lpr_log2) {
    for (int off = (1 << lpr_log2) >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] |= __shfl_xor_sync(kFull, w[i], off);
    }
  }
  // First free slot of the window, or -1 when all W slots are forbidden.
  __device__ __forceinline__ int first_free(int window) const {
    int first = -1;
#pragma unroll
    for (int i = NW - 1; i >= 0; --i) {
      const int left = window - 32 * i;
      const unsigned valid = left >= 32 ? kFull : ((1u << left) - 1u);
      const unsigned avail = ~w[i] & valid;
      if (avail) first = 32 * i + __ffs(avail) - 1;
    }
    return first;
  }
};

// ORs an int flag over the lane group.
__device__ __forceinline__ int reduce_or(int v, int lpr_log2) {
  for (int off = (1 << lpr_log2) >> 1; off > 0; off >>= 1)
    v |= __shfl_xor_sync(kFull, v, off);
  return v;
}

// Max of an int over the lane group.
__device__ __forceinline__ int reduce_max(int v, int lpr_log2) {
  for (int off = (1 << lpr_log2) >> 1; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Min of an int over the lane group.
__device__ __forceinline__ int reduce_min(int v, int lpr_log2) {
  for (int off = (1 << lpr_log2) >> 1; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// --- gathered rows -----------------------------------------------------------
// The in-kernel-gather kernels (conflict, fused_compact) read a row's
// neighbour ids straight from the graph's (Rg, K) ELL tile and load what
// they need at each id themselves (colors[v], priority[v]). The layout
// left-packs every ELL row: entry k of row r is neighbour k of r's sorted
// CSR row and every later entry is the pad id N, so a row ends at its first
// padding entry. T is int4 (four entries per 16-byte load: K % 4 == 0 and
// a 16-byte aligned tile) or int (one entry per load).

// Entries a lane group reads per pass over a gathered row.
constexpr int kPassEntries = 32;

// Lanes per row (log2) for rows of `width` loads of `per_load` entries:
// as many as make one pass cover kPassEntries entries, fewer for short rows.
inline int gather_lanes_log2(int width, int per_load) {
  int l = 0;
  while ((1 << l) < width && (per_load << (l + 1)) <= kPassEntries) ++l;
  return l;
}

// Calls f(v) for a real entry v; returns true for a padding entry.
template <typename F>
__device__ __forceinline__ bool visit(int v, int pad, F& f) {
  if (v == pad) return true;
  f(v);
  return false;
}

template <typename F>
__device__ __forceinline__ bool visit(int4 e, int pad, F& f) {
  bool saw = visit(e.x, pad, f);
  saw = visit(e.y, pad, f) || saw;
  saw = visit(e.z, pad, f) || saw;
  return visit(e.w, pad, f) || saw;
}

// Calls f(v) for every neighbour id v of one left-packed ELL row (`row`
// points at its first load; `width` loads per row) and stops at the row's
// first padding entry. The lane group of 1 << lpr_log2 lanes owns the row:
// each pass reads one load per lane, then one warp ballot tells every group
// whether any of its lanes met padding, which ends that group's row. The
// loop is warp-uniform (every lane takes each vote, also the lanes of rows
// with nothing to do and of rows past the last), and the warp leaves it as
// soon as all its groups are done. With `work` false nothing is read.
template <typename T, typename F>
__device__ __forceinline__ void for_each_neighbour(const T* __restrict__ row,
                                                   bool work, int width,
                                                   int pad, int lpr_log2,
                                                   F&& f) {
  const int lane = threadIdx.x & 31;
  const int lpr = 1 << lpr_log2;
  const int sub = lane & (lpr - 1);
  const unsigned group = (lpr == 32 ? kFull : ((1u << lpr) - 1u))
                         << (lane & ~(lpr - 1));
  bool done = !work;
  for (int first = 0; first < width; first += lpr) {
    if (__all_sync(kFull, done)) break;
    const int k = first + sub;
    bool saw = false;
    if (!done && k < width) saw = visit(__ldg(row + k), pad, f);
    // every lane votes, the done ones too (not short-circuited)
    const unsigned vote = __ballot_sync(kFull, saw);
    done = done || (vote & group) != 0u;
  }
}

}  // namespace rows

// Runs CALL with BOUND_NAME the __launch_bounds__ of a block of `threads`.
#define ROWS_DISPATCH_BOUND(threads, BOUND_NAME, ...)                \
  if ((threads) <= rows::kThreads) {                                 \
    constexpr int BOUND_NAME = rows::kThreads; __VA_ARGS__;          \
  } else {                                                           \
    constexpr int BOUND_NAME = rows::kMaxThreads; __VA_ARGS__;       \
  }

// Instantiates F<NW> for NW = ceil(window / 32) in 1..8 and runs CALL.
#define ROWS_DISPATCH_NW(window, NW_NAME, CALL)            \
  switch (((window) + 31) / 32) {                          \
    case 1: { constexpr int NW_NAME = 1; CALL; } break;    \
    case 2: { constexpr int NW_NAME = 2; CALL; } break;    \
    case 3: { constexpr int NW_NAME = 3; CALL; } break;    \
    case 4: { constexpr int NW_NAME = 4; CALL; } break;    \
    case 5: { constexpr int NW_NAME = 5; CALL; } break;    \
    case 6: { constexpr int NW_NAME = 6; CALL; } break;    \
    case 7: { constexpr int NW_NAME = 7; CALL; } break;    \
    case 8: { constexpr int NW_NAME = 8; CALL; } break;    \
    default: return (int)cudaErrorInvalidValue;            \
  }

// Shared row machinery of the row kernels (mex_window, conflict,
// fused_compact, fused_step, jpl_prio, frontier): a group of
// LPR = 2^lpr_log2 lanes (1..32) owns one row, the lanes stride over the
// row's entries, and an XOR-shuffle reduction combines their partial
// results. Groups never straddle a warp (LPR divides 32 and the block size
// is a multiple of 32), so every lane of a warp takes part in each shuffle,
// also lanes past the last row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rows {

constexpr int kThreads = 256;
constexpr int kMaxWindow = 256;           // 8 bitmap words of 32 bits
constexpr unsigned kFull = 0xffffffffu;

// Smallest power of two >= k, at most 32; returns its log2.
inline int lanes_log2(int k) {
  int l = 0;
  while ((1 << l) < k && l < 5) ++l;
  return l;
}

inline unsigned blocks_for(int64_t rows, int lpr_log2) {
  int64_t threads = rows << lpr_log2;
  return (unsigned)((threads + kThreads - 1) / kThreads);
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

}  // namespace rows

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

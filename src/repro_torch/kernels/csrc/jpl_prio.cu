// Per-row extrema of the JPL neighbour priorities.
//
// Replaces: src/repro/kernels/jpl_prio.py, _extrema_kernel /
// jpl_extrema_pallas (algos/jpl._extrema: one call per JPL round, at the
// (N, K) tile of a dense round or the (C, K) tile of a sparse one).
//
// Per row r of an (R, K) int32 tile npr whose inactive entries are -1:
//   max[r] = max_k npr[r, k]
//   min[r] = min of the entries >= 0, LARGE (0x7FFFFFFF) when there is none
//
// Bound: memory. One read of the tile and two int32 writes per row; the
// work is two compares per entry.
//
// Design: rows.cuh's lane-group scheme over 16-byte loads. When K is a
// multiple of 4 and the tile is 16-byte aligned, a lane reads four entries
// (an int4) per step and a group of min(next_pow2(K / 4), 32) lanes owns a
// row, so a warp reads whole 128-byte lines; otherwise a lane reads one
// entry per step. The group combines its partial max and min with XOR
// shuffles and lane 0 writes both.
#include <climits>

#include "rows.cuh"

namespace {

constexpr int kLarge = 0x7FFFFFFF;

struct Extrema {
  int mx = INT_MIN;
  int mn = kLarge;

  __device__ __forceinline__ void add(int q) {
    mx = max(mx, q);
    if (q >= 0) mn = min(mn, q);
  }
  __device__ __forceinline__ void add(int4 q) {
    add(q.x);
    add(q.y);
    add(q.z);
    add(q.w);
  }
};

// T is int (one entry per load) or int4 (four); width counts T per row.
template <typename T>
__global__ void __launch_bounds__(rows::kThreads)
jpl_extrema_kernel(const T* __restrict__ npr, int* __restrict__ out_max,
                   int* __restrict__ out_min, int64_t n_rows, int width,
                   int lpr_log2) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = tid >> lpr_log2;
  const int lpr = 1 << lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const bool live = row < n_rows;

  Extrema e;
  if (live) {
    const T* p = npr + row * width;
    for (int k = sub; k < width; k += lpr) e.add(p[k]);
  }
  const int mx = rows::reduce_max(e.mx, lpr_log2);
  const int mn = rows::reduce_min(e.mn, lpr_log2);
  if (live && sub == 0) {
    out_max[row] = mx;
    out_min[row] = mn;
  }
}

template <typename T>
void launch(const int* npr, int* out_max, int* out_min, int64_t n_rows,
            int width, cudaStream_t stream) {
  const int lg = rows::lanes_log2(width);
  jpl_extrema_kernel<T><<<rows::blocks_for(n_rows, lg), rows::kThreads, 0,
                          stream>>>(reinterpret_cast<const T*>(npr), out_max,
                                    out_min, n_rows, width, lg);
}

}  // namespace

// npr is a contiguous (n_rows, k_width) int32 tile, k_width >= 1. Returns
// a cudaError_t code.
extern "C" int jpl_extrema_launch(const int* npr, int* out_max, int* out_min,
                                  int64_t n_rows, int k_width, void* stream) {
  if (n_rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k_width % 4 == 0 && (reinterpret_cast<uintptr_t>(npr) & 15) == 0)
    launch<int4>(npr, out_max, out_min, n_rows, k_width / 4, s);
  else
    launch<int>(npr, out_max, out_min, n_rows, k_width, s);
  return (int)cudaGetLastError();
}

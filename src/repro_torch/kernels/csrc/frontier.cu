// Bottom-up BFS frontier probe.
//
// Replaces: src/repro/kernels/frontier.py, _frontier_kernel /
// frontier_probe_pallas (core/bfs.bottomup_step: one call per bottom-up
// level, at the (N, K) tile of neighbour frontier flags).
//
// Per row r of an (R, K) bool tile nbr (one byte per entry, 0 or 1):
//   out[r] = unvisited[r] && (some k: nbr[r, k])
//
// Bound: memory. One read of the tile (only for unvisited rows), one read
// of unvisited and one byte written per row; the work is an OR per entry.
//
// Design: rows.cuh's lane-group scheme over wide loads. A lane ORs 16
// bytes (a uint4) per step when K is a multiple of 16 and the tile is
// 16-byte aligned, 4 bytes when K is a multiple of 4 and the tile 4-byte
// aligned, else one byte; a group of min(next_pow2(loads per row), 32)
// lanes owns a row, ORs its flags with XOR shuffles, and lane 0 writes the
// bool.
#include "rows.cuh"

namespace {

__device__ __forceinline__ unsigned bits(uint8_t v) { return v; }
__device__ __forceinline__ unsigned bits(unsigned v) { return v; }
__device__ __forceinline__ unsigned bits(uint4 v) {
  return v.x | v.y | v.z | v.w;
}

// T is uint8_t, unsigned or uint4; width counts T per row.
template <typename T>
__global__ void __launch_bounds__(rows::kThreads)
frontier_kernel(const T* __restrict__ nbr,
                const uint8_t* __restrict__ unvisited,
                uint8_t* __restrict__ out, int64_t n_rows, int width,
                int lpr_log2) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = tid >> lpr_log2;
  const int lpr = 1 << lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const bool live = row < n_rows;

  unsigned hit = 0u;
  if (live && unvisited[row]) {
    const T* p = nbr + row * width;
    for (int k = sub; k < width; k += lpr) hit |= bits(p[k]);
  }
  const int any = rows::reduce_or(hit != 0u, lpr_log2);
  if (live && sub == 0) out[row] = (uint8_t)(any != 0);
}

template <typename T>
void launch(const uint8_t* nbr, const uint8_t* unvisited, uint8_t* out,
            int64_t n_rows, int width, cudaStream_t stream) {
  const int lg = rows::lanes_log2(width);
  frontier_kernel<T><<<rows::blocks_for(n_rows, lg), rows::kThreads, 0,
                       stream>>>(reinterpret_cast<const T*>(nbr), unvisited,
                                 out, n_rows, width, lg);
}

}  // namespace

// nbr is a contiguous (n_rows, k_width) bool tile. Returns a cudaError_t
// code.
extern "C" int frontier_launch(const uint8_t* nbr, const uint8_t* unvisited,
                               uint8_t* out, int64_t n_rows, int k_width,
                               void* stream) {
  if (n_rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(nbr);
  if (k_width % 16 == 0 && (addr & 15) == 0)
    launch<uint4>(nbr, unvisited, out, n_rows, k_width / 16, s);
  else if (k_width % 4 == 0 && (addr & 3) == 0)
    launch<unsigned>(nbr, unvisited, out, n_rows, k_width / 4, s);
  else
    launch<uint8_t>(nbr, unvisited, out, n_rows, k_width, s);
  return (int)cudaGetLastError();
}

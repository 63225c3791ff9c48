// Conflict detection with one-endpoint resolution.
//
// Replaces: src/repro/kernels/conflict.py, _conflict_kernel / conflict_pallas
// (the resolve pass of the two-phase IPGC step, ipgc._lose_rows).
//
// Row r loses iff its own color cu[r] >= 0 and some neighbour k has the same
// color with a higher (priority, id) pair:
//   nc[r,k] == cu[r] && (npr[r,k] > pu[r] || (npr[r,k] == pu[r] && nid[r,k] > ids[r]))
// -- the predicate of ipgc._conflict_rows, OR-reduced over the row.
//
// Bound: memory. The work is five integer compares per entry of three
// (R, K) int32 tiles. The kernel reads the color tile only for colored rows
// and the priority and id tiles only at same-color entries, so the bytes a
// call moves depend on the data; PERF.md's bound counts exactly those.
//
// Design: a group of LPR lanes (K rounded up to a power of two, at most 32)
// per row, lanes striding over K so a warp reads consecutive addresses; the
// group ORs its flags with XOR shuffles and lane 0 writes the bool.
#include "rows.cuh"

namespace {

__global__ void __launch_bounds__(rows::kThreads)
conflict_kernel(const int* __restrict__ nc, const int* __restrict__ npr,
                const int* __restrict__ nid, const int* __restrict__ cu,
                const int* __restrict__ pu, const int* __restrict__ ids,
                uint8_t* __restrict__ out, int64_t n_rows, int k_width,
                int lpr_log2) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = tid >> lpr_log2;
  const int lpr = 1 << lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const bool live = row < n_rows;

  int lose = 0;
  if (live) {
    const int c = cu[row];
    if (c >= 0) {
      const int p = pu[row];
      const int u = ids[row];
      const int64_t off = row * k_width;
      for (int k = sub; k < k_width; k += lpr) {
        if (nc[off + k] == c) {
          const int q = npr[off + k];
          lose |= (q > p) || (q == p && nid[off + k] > u);
        }
      }
    }
  }
  lose = rows::reduce_or(lose, lpr_log2);
  if (live && sub == 0) out[row] = (uint8_t)(lose != 0);
}

}  // namespace

// Returns a cudaError_t code.
extern "C" int conflict_launch(const int* nc, const int* npr, const int* nid,
                               const int* cu, const int* pu, const int* ids,
                               uint8_t* out, int64_t n_rows, int k_width,
                               void* stream) {
  if (n_rows == 0) return 0;
  const int lg = rows::lanes_log2(k_width);
  conflict_kernel<<<rows::blocks_for(n_rows, lg), rows::kThreads, 0,
                    (cudaStream_t)stream>>>(nc, npr, nid, cu, pu, ids, out,
                                            n_rows, k_width, lg);
  return (int)cudaGetLastError();
}

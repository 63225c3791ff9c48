// Conflict detection with one-endpoint resolution, gathering the neighbours
// inside the kernel.
//
// Replaces: src/repro/kernels/conflict.py, _conflict_kernel / conflict_pallas
// (the resolve pass of the two-phase IPGC step, ipgc._lose_rows).
//
// Row i (graph row g = rows[i], or i when rows is null; g >= Rg is an empty
// row) loses iff it is newly colored, its own color cu[i] >= 0, and some
// neighbour v = ell[g, k] has the same color with a higher (priority, id):
//   colors[v] == cu[i] && (priority[v] > pu[i] ||
//                          (priority[v] == pu[i] && v > ids[i]))
// -- the predicate of ipgc._conflict_rows, OR-reduced over the row and
// ANDed with newly.
//
// Bound: memory. The work is a few integer compares per real entry. A row
// that is not newly colored reads nothing but its flag; a newly colored row
// reads its real ELL entries (up to the first padding entry, in passes of
// 32) and one color per entry, and a priority only at same-color entries.
// colors and priority (4(N+1) bytes each) are gathered at random ids, so
// they are served from L2 where they fit in it.
//
// Design: rows.cuh's gathered-row reader: a lane group per row, 16-byte
// loads of the ELL row when K % 4 == 0, one warp ballot per pass that ends
// each row at its first padding entry; the group ORs its flags with XOR
// shuffles and lane 0 writes the bool. No (R, K) tile is made: the
// neighbour colors, priorities and ids come straight from colors, priority
// and ell.
#include "rows.cuh"

namespace {

// T is int or int4; width counts T per ELL row.
template <typename T, int B>
__global__ void __launch_bounds__(B)
conflict_kernel(const int* __restrict__ colors,
                const int* __restrict__ priority, const T* __restrict__ ell,
                const int* __restrict__ row_of, const int* __restrict__ cu,
                const int* __restrict__ pu, const int* __restrict__ ids,
                const uint8_t* __restrict__ newly, uint8_t* __restrict__ out,
                int64_t n_rows, int64_t n_graph_rows, int width, int pad,
                int lpr_log2) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = tid >> lpr_log2;
  const int sub = threadIdx.x & ((1 << lpr_log2) - 1);
  const bool live = i < n_rows;

  bool work = false;
  int c = 0, p = 0, u = 0;
  const T* row = ell;
  if (live && newly[i]) {
    const int64_t g = row_of == nullptr ? i : (int64_t)row_of[i];
    c = cu[i];
    if (g < n_graph_rows && c >= 0) {
      work = true;
      p = pu[i];
      u = ids[i];
      row = ell + g * width;
    }
  }
  int lose = 0;
  rows::for_each_neighbour(row, work, width, pad, lpr_log2, [&](int v) {
    if (__ldg(colors + v) == c) {
      const int q = __ldg(priority + v);
      lose |= (q > p) || (q == p && v > u);
    }
  });
  lose = rows::reduce_or(lose, lpr_log2);
  if (live && sub == 0) out[i] = (uint8_t)(lose != 0);
}

template <typename T>
void launch(const int* colors, const int* priority, const int* ell,
            const int* row_of, const int* cu, const int* pu, const int* ids,
            const uint8_t* newly, uint8_t* out, int64_t n_rows,
            int64_t n_graph_rows, int k_width, int pad, int tile_rows,
            cudaStream_t stream) {
  constexpr int per = (int)(sizeof(T) / sizeof(int));
  const int width = k_width / per;
  const int lg = rows::gather_lanes_log2(width, per);
  const int nt = rows::block_threads(tile_rows, lg);
  ROWS_DISPATCH_BOUND(nt, B,
      conflict_kernel<T, B><<<rows::blocks_for(n_rows, lg, nt), nt, 0,
                              stream>>>(colors, priority,
                                        reinterpret_cast<const T*>(ell),
                                        row_of, cu, pu, ids, newly, out,
                                        n_rows, n_graph_rows, width, pad,
                                        lg));
}

}  // namespace

// colors and priority hold pad + 1 entries; ell is a contiguous
// (n_graph_rows, k_width) int32 tile whose entries are ids < pad or the pad
// id; row_of is null (row i is graph row i, n_rows == n_graph_rows) or holds
// n_rows graph rows, values >= n_graph_rows meaning an empty row. Returns a
// cudaError_t code.
extern "C" int conflict_launch(const int* colors, const int* priority,
                               const int* ell, const int* row_of,
                               const int* cu, const int* pu, const int* ids,
                               const uint8_t* newly, uint8_t* out,
                               int64_t n_rows, int64_t n_graph_rows,
                               int k_width, int pad, int tile_rows,
                               void* stream) {
  if (n_rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k_width % 4 == 0 && (reinterpret_cast<uintptr_t>(ell) & 15) == 0)
    launch<int4>(colors, priority, ell, row_of, cu, pu, ids, newly, out,
                 n_rows, n_graph_rows, k_width, pad, tile_rows, s);
  else
    launch<int>(colors, priority, ell, row_of, cu, pu, ids, newly, out,
                n_rows, n_graph_rows, k_width, pad, tile_rows, s);
  return (int)cudaGetLastError();
}

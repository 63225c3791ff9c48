// Per-row extrema of the JPL neighbour priorities, gathering the neighbours
// inside the kernel.
//
// Replaces: src/repro/kernels/jpl_prio.py, _extrema_kernel /
// jpl_extrema_pallas (algos/jpl._extrema: one call per JPL round, at the
// (N, K) tile of a dense round or the (C, K) tile of a sparse one). The
// Pallas kernel takes the neighbour priorities pre-gathered; this one
// takes the graph's ELL tile, the rows and where to read each priority.
//
// Row i is graph row g = rows[i] (i when rows is null); g >= Rg is an empty
// row, which reads nothing. Over its real neighbours v = ell[g, k]:
//   max[i] = max(-1, max_v npr(v))
//   min[i] = min of the npr(v) >= 0, LARGE (0x7FFFFFFF) when there is none
// with npr(v) = table[v] (table source), or, with a round (hash source),
//   npr(v) = table[v] == NO_COLOR ? round_hash(v, round) : -1
// where table holds the colors and round_hash is algos/jpl.py's uint32
// mixer of (id, round), bit for bit. A row without a real neighbour gives
// max -1 and min LARGE: what the padding lanes (-1) of the old tile gave.
//
// Bound: memory. A row reads its real ELL entries (up to the first padding
// entry) and one table entry per entry, and writes two int32; the work is
// two compares per entry, and ~10 integer operations of the hash where a
// neighbour is uncolored. The table (4(N+1) bytes) is gathered at random
// ids, so it is served from L2 where it fits in it.
//
// Design: rows.cuh's gathered-row reader (a lane group per row, 16-byte ELL
// loads when K % 4 == 0, a warp ballot per pass that ends each row at its
// first padding entry); the group combines its partial max and min with
// XOR shuffles and lane 0 writes both. No (R, K) tile is made. The round
// is read once per thread from device memory, so a captured graph replays
// with the round of the moment and nothing syncs. One launch; R = 0
// launches nothing.
#include "rows.cuh"

namespace {

constexpr int kLarge = 0x7FFFFFFF;

// The seed and mixer of algos/jpl.py::round_hash in uint32 arithmetic.
__device__ __forceinline__ unsigned round_seed(int rnd) {
  return ((unsigned)rnd + 1u) * 0x9E3779B9u;
}

__device__ __forceinline__ int round_hash(int v, unsigned seed) {
  unsigned h = (unsigned)v + seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (int)(h >> 1);
}

struct Extrema {
  int mx = -1;
  int mn = kLarge;

  __device__ __forceinline__ void add(int q) {
    mx = max(mx, q);
    if (q >= 0) mn = min(mn, q);
  }
};

// T is int or int4; width counts T per ELL row. HASH: table holds colors
// and *rnd the round.
template <bool HASH, typename T, int B>
__global__ void __launch_bounds__(B)
jpl_extrema_kernel(const T* __restrict__ ell, const int* __restrict__ row_of,
                   const int* __restrict__ table, const int* __restrict__ rnd,
                   int* __restrict__ out_max, int* __restrict__ out_min,
                   int64_t n_rows, int64_t n_graph_rows, int width, int pad,
                   int no_color, int lpr_log2) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = tid >> lpr_log2;
  const int sub = threadIdx.x & ((1 << lpr_log2) - 1);
  const bool live = i < n_rows;

  bool work = false;
  const T* row = ell;
  if (live) {
    const int64_t g = row_of == nullptr ? i : (int64_t)row_of[i];
    if (g < n_graph_rows) {
      work = true;
      row = ell + g * width;
    }
  }
  const unsigned seed = HASH ? round_seed(__ldg(rnd)) : 0u;
  Extrema e;
  rows::for_each_neighbour(row, work, width, pad, lpr_log2, [&](int v) {
    const int t = __ldg(table + v);
    if (HASH)
      e.add(t == no_color ? round_hash(v, seed) : -1);
    else
      e.add(t);
  });
  const int mx = rows::reduce_max(e.mx, lpr_log2);
  const int mn = rows::reduce_min(e.mn, lpr_log2);
  if (live && sub == 0) {
    out_max[i] = mx;
    out_min[i] = mn;
  }
}

template <bool HASH, typename T>
void launch(const int* ell, const int* row_of, const int* table,
            const int* rnd, int* out_max, int* out_min, int64_t n_rows,
            int64_t n_graph_rows, int k_width, int pad, int no_color,
            int tile_rows, cudaStream_t stream) {
  constexpr int per = (int)(sizeof(T) / sizeof(int));
  const int width = k_width / per;
  const int lg = rows::gather_lanes_log2(width, per);
  const int nt = rows::block_threads(tile_rows, lg);
  ROWS_DISPATCH_BOUND(nt, B,
      jpl_extrema_kernel<HASH, T, B><<<rows::blocks_for(n_rows, lg, nt), nt,
                                       0, stream>>>(
          reinterpret_cast<const T*>(ell), row_of, table, rnd, out_max,
          out_min, n_rows, n_graph_rows, width, pad, no_color, lg));
}

template <bool HASH>
void launch_rows(const int* ell, const int* row_of, const int* table,
                 const int* rnd, int* out_max, int* out_min, int64_t n_rows,
                 int64_t n_graph_rows, int k_width, int pad, int no_color,
                 int tile_rows, cudaStream_t stream) {
  if (k_width % 4 == 0 && (reinterpret_cast<uintptr_t>(ell) & 15) == 0)
    launch<HASH, int4>(ell, row_of, table, rnd, out_max, out_min, n_rows,
                       n_graph_rows, k_width, pad, no_color, tile_rows,
                       stream);
  else
    launch<HASH, int>(ell, row_of, table, rnd, out_max, out_min, n_rows,
                      n_graph_rows, k_width, pad, no_color, tile_rows,
                      stream);
}

}  // namespace

// ell is a contiguous (n_graph_rows, k_width) int32 tile of ids < pad or
// the pad id; row_of is null (row i is graph row i) or holds n_rows graph
// rows, values >= n_graph_rows meaning an empty row; table holds pad + 1
// entries: the priorities, or, with rnd set (a device pointer to the
// round), the colors. tile_rows <= 0 is the default block (rows.cuh).
// Returns a cudaError_t code.
extern "C" int jpl_extrema_launch(const int* ell, const int* row_of,
                                  const int* table, const int* rnd,
                                  int* out_max, int* out_min, int64_t n_rows,
                                  int64_t n_graph_rows, int k_width, int pad,
                                  int no_color, int tile_rows, void* stream) {
  if (n_rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (rnd != nullptr)
    launch_rows<true>(ell, row_of, table, rnd, out_max, out_min, n_rows,
                      n_graph_rows, k_width, pad, no_color, tile_rows, s);
  else
    launch_rows<false>(ell, row_of, table, rnd, out_max, out_min, n_rows,
                       n_graph_rows, k_width, pad, no_color, tile_rows, s);
  return (int)cudaGetLastError();
}

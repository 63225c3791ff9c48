// Windowed mex of the two-phase IPGC assign, gathering the neighbours
// inside the kernel.
//
// Replaces: src/repro/kernels/mex_window.py, _mex_kernel / mex_window_pallas
// (the assign pass of the two-phase IPGC step, ipgc._mex_rows). The Pallas
// kernel takes the neighbour colors and the hub bitmap pre-gathered as
// (R, K) and (R, W) tiles; this one takes the colors vector, the graph's
// (or shard's) ELL tile, the rows and, on a graph with hubs, the per-hub
// forbidden table.
//
// Row i is graph row g = rows[i] (i when rows is null); g >= Rg is an empty
// row, which reads nothing. For an active row, with its real neighbours
// v = ell[g, k]:
//   first[i] = the first slot j of [0, W) with colors[v] - base[i] != j for
//              every v [and hub_forb[s, j] false, s = hub_slot[g] < n_hub];
//              -1 when every slot is taken (an empty row gives 0).
// A row that is not active reads nothing and writes -1. Colors below 0
// (uncolored, padding) never forbid anything.
//
// Bound: memory. An active row reads its active flag and base, its real
// ELL entries (4 bytes each, up to the first padding entry), one color per
// entry and, for a hub row, its slot and W bytes of its table row; every
// row writes one int32. colors (4(N+1) bytes) is gathered at random ids,
// so it is served from L2 where it fits in it.
//
// Design: fused_step.cu's row pass without the lose flag: rows.cuh's
// gathered-row reader (a lane group per row, 16-byte ELL loads when
// K % 4 == 0, a warp ballot per pass that ends each row at its first
// padding entry), a ceil(W/32)-word forbidden bitmap in registers per
// lane, ORed over the group with XOR shuffles, and lane 0 finds the first
// free slot with __ffs. No (R, K) or (R, W) tile is made. One launch, no
// synchronisation; R = 0 launches nothing. W <= 256.
#include "rows.cuh"

namespace {

struct MexArgs {
  const int* colors;
  const int* row_of;
  const int* base;
  const uint8_t* active;
  const uint8_t* hub_forb;
  const int* hub_slot;
  int* first;
  int64_t n_rows;
  int64_t n_graph_rows;
  int width;
  int window;
  int pad;
  int n_hub;
  int lpr_log2;
};

// T is int or int4; a.width counts T per ELL row.
template <int NW, typename T, int B>
__global__ void __launch_bounds__(B)
mex_window_kernel(const T* __restrict__ ell, const MexArgs a) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = tid >> a.lpr_log2;
  const int lpr = 1 << a.lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const bool live = i < a.n_rows;
  const int* __restrict__ colors = a.colors;

  const bool act = live && a.active[i] != 0;
  bool work = false;
  int b = 0;
  int slot = a.n_hub;
  const T* row = ell;
  if (act) {
    const int64_t g = a.row_of == nullptr ? i : (int64_t)a.row_of[i];
    b = a.base[i];
    if (g < a.n_graph_rows) {
      work = true;
      row = ell + g * a.width;
      if (a.hub_forb != nullptr) slot = a.hub_slot[g];
    }
  }
  rows::Bitmap<NW> forb;
  forb.clear();
  rows::for_each_neighbour(row, work, a.width, a.pad, a.lpr_log2,
                           [&](int v) {
    forb.add_color(__ldg(colors + v), b, a.window);
  });
  if (slot < a.n_hub) {
    const uint8_t* e = a.hub_forb + (int64_t)slot * a.window;
    for (int j = sub; j < a.window; j += lpr)
      if (e[j]) forb.set(j);
  }
  forb.reduce(a.lpr_log2);
  if (live && sub == 0) a.first[i] = act ? forb.first_free(a.window) : -1;
}

template <int NW, typename T>
int launch_typed(const int* ell, MexArgs a, int k_width, int tile_rows,
                 cudaStream_t stream) {
  constexpr int per = (int)(sizeof(T) / sizeof(int));
  a.width = k_width / per;
  a.lpr_log2 = rows::gather_lanes_log2(a.width, per);
  const int nt = rows::block_threads(tile_rows, a.lpr_log2);
  ROWS_DISPATCH_BOUND(nt, B,
      mex_window_kernel<NW, T, B><<<rows::blocks_for(a.n_rows, a.lpr_log2, nt),
                                nt, 0, stream>>>(
          reinterpret_cast<const T*>(ell), a));
  return (int)cudaGetLastError();
}

template <int NW>
int launch_rows(const int* ell, const MexArgs& a, int k_width, int tile_rows,
                cudaStream_t stream) {
  if (k_width % 4 == 0 && (reinterpret_cast<uintptr_t>(ell) & 15) == 0)
    return launch_typed<NW, int4>(ell, a, k_width, tile_rows, stream);
  return launch_typed<NW, int>(ell, a, k_width, tile_rows, stream);
}

}  // namespace

// colors holds pad + 1 entries; ell is a contiguous (n_graph_rows, k_width)
// int32 tile of ids < pad or the pad id; row_of is null (row i is graph row
// i) or holds n_rows graph rows, values >= n_graph_rows meaning an empty
// row; base and active hold n_rows entries. hub_forb ((n_hub+1) * window
// bytes) and hub_slot (n_graph_rows) are both null (no hubs) or both set.
// tile_rows <= 0 is the default block (rows.cuh). Returns a cudaError_t
// code.
extern "C" int mex_window_launch(const int* colors, const int* ell,
                                 const int* row_of, const int* base,
                                 const uint8_t* active,
                                 const uint8_t* hub_forb, const int* hub_slot,
                                 int* first, int64_t n_rows,
                                 int64_t n_graph_rows, int k_width,
                                 int window, int pad, int n_hub,
                                 int tile_rows, void* stream) {
  if (window < 1 || window > rows::kMaxWindow)
    return (int)cudaErrorInvalidValue;
  // (an empty hub_slot, of a shard with no rows, may come as null)
  if (hub_forb != nullptr && hub_slot == nullptr && n_graph_rows > 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const MexArgs a{colors, row_of, base, active, hub_forb, hub_slot, first,
                  n_rows, n_graph_rows, 0, window, pad,
                  hub_forb == nullptr ? 0 : n_hub, 0};
  ROWS_DISPATCH_NW(window, NW,
                   return launch_rows<NW>(ell, a, k_width, tile_rows,
                                          (cudaStream_t)stream));
  return 0;
}

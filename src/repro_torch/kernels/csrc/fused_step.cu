// Fused resolve + windowed mex of the distributed fused steps, gathering
// the neighbours inside the kernel, without the new-color selection and
// the emission.
//
// Replaces: src/repro/kernels/fused_step.py, _fused_kernel /
// fused_step_pallas (its pallas_call at line 99; ipgc._fused_rows, which
// every fused step of the distributed Pipe calls: its emission follows the
// cross-shard exchange, so it cannot fold into the row pass as
// fused_compact's does). The Pallas kernel takes the neighbour-color,
// priority and id tiles and the hub bitmap pre-gathered; this one takes
// the colors and priority vectors, the shard's ELL tile and the rows.
//
// Row i is shard row g = rows[i] (i when rows is null); g >= Rg is an empty
// row, which reads nothing. With its real neighbours v = ell[g, k]:
//   lose[i]  = pending[i] && (some v: colors[v] == cu[i] >= 0 with a higher
//              (priority[v], v) pair than (pu[i], ids[i]))
//              [|| pending[i] && hub_lose[s], s = hub_slot[g] < n_hub]
//   first[i] = the first slot j of [0, W) with colors[v] - base[i] != j for
//              every v [and hub_forb[s, j] false]; -1 when every slot is
//              taken (an empty row gives 0).
// Two variants: no-hub (the hub tables null) and hub, which reads the
// (n_hub+1, W) forbidden table and the (n_hub+1,) lose table of
// ipgc._hub_forbidden / _hub_lose at the row's hub slot, and only where
// that slot is < n_hub.
//
// Bound: memory. Every graph row reads its real ELL entries (4 bytes each,
// up to the first padding entry: the caller reads `first` wherever a row
// needs a new color, and the kernel cannot tell those rows apart), one
// color per entry, a priority only at same-color entries of a pending
// row, its R-vector entries, and a hub row W bytes of its table row; it
// writes 5 bytes. colors and priority are gathered at random ids, so they
// are served from L2 where they fit in it.
//
// Design: fused_compact.cu's row pass without the select and the emission:
// rows.cuh's gathered-row reader (a lane group per row, 16-byte ELL loads
// when K % 4 == 0, a warp ballot per pass that ends each row at its first
// padding entry), a ceil(W/32)-word forbidden bitmap in registers per lane,
// bitmaps and lose flags ORed over the group with XOR shuffles, and lane 0
// finds the first free slot with __ffs and writes both outputs. No (R, K)
// or (R, W) tile is made. One launch, no synchronisation; R = 0 launches
// nothing. W <= 256.
#include "rows.cuh"

namespace {

struct StepArgs {
  const int* colors;
  const int* priority;
  const int* row_of;
  const int* base;
  const int* cu;
  const int* pu;
  const int* ids;
  const uint8_t* pending;
  const uint8_t* hub_forb;
  const uint8_t* hub_lose;
  const int* hub_slot;
  uint8_t* lose;
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
fused_step_kernel(const T* __restrict__ ell, const StepArgs a) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = tid >> a.lpr_log2;
  const int lpr = 1 << a.lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const bool live = i < a.n_rows;
  const int* __restrict__ colors = a.colors;
  const int* __restrict__ priority = a.priority;

  bool work = false, pend = false;
  int c = 0, b = 0, p = 0, u = 0;
  int slot = a.n_hub;
  const T* row = ell;
  if (live) {
    const int64_t g = a.row_of == nullptr ? i : (int64_t)a.row_of[i];
    if (g < a.n_graph_rows) {
      work = true;
      c = a.cu[i];
      b = a.base[i];
      pend = a.pending[i] != 0;
      row = ell + g * a.width;
      if (a.hub_forb != nullptr) slot = a.hub_slot[g];
    }
  }
  const bool check = pend && c >= 0;
  if (check) {
    p = a.pu[i];
    u = a.ids[i];
  }
  int lose = 0;
  rows::Bitmap<NW> forb;
  forb.clear();
  rows::for_each_neighbour(row, work, a.width, a.pad, a.lpr_log2,
                           [&](int v) {
    const int cv = __ldg(colors + v);
    forb.add_color(cv, b, a.window);
    if (check && cv == c) {
      const int q = __ldg(priority + v);
      lose |= (q > p) || (q == p && v > u);
    }
  });
  if (slot < a.n_hub) {
    const uint8_t* e = a.hub_forb + (int64_t)slot * a.window;
    for (int j = sub; j < a.window; j += lpr)
      if (e[j]) forb.set(j);
  }
  forb.reduce(a.lpr_log2);
  lose = rows::reduce_or(lose, a.lpr_log2);
  if (live && sub == 0) {
    bool l = lose != 0;  // already requires pending
    if (slot < a.n_hub) l = l || (pend && a.hub_lose[slot] != 0);
    a.lose[i] = (uint8_t)l;
    a.first[i] = forb.first_free(a.window);
  }
}

template <int NW, typename T>
int launch_typed(const int* ell, StepArgs a, int k_width, int tile_rows,
                 cudaStream_t stream) {
  constexpr int per = (int)(sizeof(T) / sizeof(int));
  a.width = k_width / per;
  a.lpr_log2 = rows::gather_lanes_log2(a.width, per);
  const int nt = rows::block_threads(tile_rows, a.lpr_log2);
  ROWS_DISPATCH_BOUND(nt, B,
      fused_step_kernel<NW, T, B><<<rows::blocks_for(a.n_rows, a.lpr_log2, nt),
                                nt, 0, stream>>>(
          reinterpret_cast<const T*>(ell), a));
  return (int)cudaGetLastError();
}

template <int NW>
int launch_rows(const int* ell, const StepArgs& a, int k_width, int tile_rows,
                cudaStream_t stream) {
  if (k_width % 4 == 0 && (reinterpret_cast<uintptr_t>(ell) & 15) == 0)
    return launch_typed<NW, int4>(ell, a, k_width, tile_rows, stream);
  return launch_typed<NW, int>(ell, a, k_width, tile_rows, stream);
}

}  // namespace

// colors and priority hold pad + 1 entries; ell is a contiguous
// (n_graph_rows, k_width) int32 tile of ids < pad or the pad id; row_of is
// null (row i is graph row i) or holds n_rows graph rows, values >=
// n_graph_rows meaning an empty row. hub_forb ((n_hub+1) * window bytes),
// hub_lose (n_hub+1) and hub_slot (n_graph_rows) are all null (no-hub
// variant) or all set (hub variant). tile_rows <= 0 is the default block
// (rows.cuh). Returns a cudaError_t code.
extern "C" int fused_step_launch(
    const int* colors, const int* priority, const int* ell,
    const int* row_of, const int* base, const int* cu, const int* pu,
    const int* ids, const uint8_t* pending, const uint8_t* hub_forb,
    const uint8_t* hub_lose, const int* hub_slot, uint8_t* lose, int* first,
    int64_t n_rows, int64_t n_graph_rows, int k_width, int window, int pad,
    int n_hub, int tile_rows, void* stream) {
  if (window < 1 || window > rows::kMaxWindow)
    return (int)cudaErrorInvalidValue;
  // (an empty hub_slot, of a shard with no rows, may come as null)
  if ((hub_forb == nullptr) != (hub_lose == nullptr) ||
      (hub_forb != nullptr && hub_slot == nullptr && n_graph_rows > 0))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const StepArgs a{colors, priority, row_of, base, cu, pu, ids, pending,
                   hub_forb, hub_lose, hub_slot, lose, first, n_rows,
                   n_graph_rows, 0, window, pad,
                   hub_forb == nullptr ? 0 : n_hub, 0};
  ROWS_DISPATCH_NW(window, NW,
                   return launch_rows<NW>(ell, a, k_width, tile_rows,
                                          (cudaStream_t)stream));
  return 0;
}

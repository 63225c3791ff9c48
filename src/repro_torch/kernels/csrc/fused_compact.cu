// One IPGC iteration: resolve, windowed mex, new color and base, and the
// ordered emission of the surviving rows' ids, gathering the neighbours
// inside the kernel.
//
// Replaces: src/repro/kernels/fused_compact.py, _fused_compact_kernel /
// fused_compact_pallas (ipgc._fused_compact_rows, both fused steps).
//
// Row i is graph row g = rows[i] (i when rows is null); g >= Rg is an empty
// row, neither active nor pending. With its real neighbours v = ell[g, k]
// and the predicates in the order of _fused_compact_rows:
//   lose  = pending[i] && (some v: colors[v] == cu[i] >= 0 with a higher
//           (priority[v], v) pair than (pu[i], ids[i]))
//           [|| pending[i] && hub_lose[s], s = hub_slot[g] < n_hub]
//   first = first free slot of [base, base+W) given the colors[v]
//           [| hub_forb[s, :], s = hub_slot[g] < n_hub]
//   need  = lose || (active[i] && cu[i] < 0)
//   new_c = need && first >= 0 ? base + first : (lose ? no_color : cu)
//   new_b = need && first < 0 ? base + W : base
//   still = need; items = ids of the still rows in ascending row order,
//   sentinel-padded to `capacity`; count = number of still rows.
// Two variants: no-hub (the hub tables null) and hub, which reads the
// (n_hub+1, W) forbidden table and the (n_hub+1,) lose table of
// ipgc._hub_forbidden / _hub_lose at the row's hub slot, and only where
// that slot is < n_hub (row n_hub, the non-hub rows' all-false row, is
// never read).
//
// Bound: memory. A row that is neither active nor pending reads only its
// R-vector entries; a working row reads its real ELL entries (up to the
// first padding entry, in passes of 32), one color per entry, a priority
// only at same-color entries of a pending row, and a hub row W bytes of
// its table row. colors and priority are gathered at random ids, so they
// are served from L2 where they fit in it.
//
// Design: the row pass is rows.cuh's gathered-row reader (lane group per
// row, 16-byte ELL loads when K % 4 == 0, a warp ballot per pass that ends
// each row at its first padding entry) with a register forbidden bitmap
// and the lose flag ORed over the group with XOR shuffles; no (R, K) or
// (R, W) tile is made. The emission is compact.cuh's one-launch ordered
// compaction over the `still` flags with the ids as values, so this call
// is two launches (and the memset of the compaction's state).
#include "compact.cuh"
#include "rows.cuh"

namespace {

struct RowArgs {
  const int* colors;
  const int* priority;
  const int* row_of;
  const int* base;
  const int* cu;
  const int* pu;
  const int* ids;
  const uint8_t* active;
  const uint8_t* pending;
  const uint8_t* hub_forb;
  const uint8_t* hub_lose;
  const int* hub_slot;
  int* new_c;
  int* new_b;
  uint8_t* still;
  int64_t n_rows;
  int64_t n_graph_rows;
  int width;
  int window;
  int pad;
  int n_hub;
  int lpr_log2;
  int no_color;
};

// T is int or int4; a.width counts T per ELL row.
template <int NW, typename T, int B>
__global__ void __launch_bounds__(B)
fused_rows_kernel(const T* __restrict__ ell, const RowArgs a) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = tid >> a.lpr_log2;
  const int lpr = 1 << a.lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const bool live = i < a.n_rows;
  const int* __restrict__ colors = a.colors;
  const int* __restrict__ priority = a.priority;

  bool act = false, pend = false;
  int c = 0, b = 0, p = 0, u = 0;
  int slot = a.n_hub;
  const T* row = ell;
  if (live) {
    c = a.cu[i];
    b = a.base[i];
    const int64_t g = a.row_of == nullptr ? i : (int64_t)a.row_of[i];
    if (g < a.n_graph_rows) {
      act = a.active[i] != 0;
      pend = a.pending[i] != 0;
      if (act || pend) {
        row = ell + g * a.width;
        if (a.hub_forb != nullptr) slot = a.hub_slot[g];
      }
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
  rows::for_each_neighbour(row, act || pend, a.width, a.pad, a.lpr_log2,
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
    const int first = forb.first_free(a.window);
    const bool has = first >= 0;
    const bool need = l || (act && c < 0);
    a.new_c[i] = (need && has) ? b + first : (l ? a.no_color : c);
    a.new_b[i] = (need && !has) ? b + a.window : b;
    a.still[i] = (uint8_t)need;
  }
}

template <int NW, typename T>
int launch_typed(const int* ell, RowArgs a, int k_width, int tile_rows,
                 cudaStream_t stream) {
  constexpr int per = (int)(sizeof(T) / sizeof(int));
  a.width = k_width / per;
  a.lpr_log2 = rows::gather_lanes_log2(a.width, per);
  const int nt = rows::block_threads(tile_rows, a.lpr_log2);
  ROWS_DISPATCH_BOUND(nt, B,
      fused_rows_kernel<NW, T, B><<<rows::blocks_for(a.n_rows, a.lpr_log2, nt),
                                nt, 0, stream>>>(
          reinterpret_cast<const T*>(ell), a));
  return (int)cudaGetLastError();
}

template <int NW>
int launch_rows(const int* ell, const RowArgs& a, int k_width, int tile_rows,
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
// variant) or all set (hub variant). scratch holds
// compact::state_words(n_rows) 64-bit words. tile_rows <= 0 is the default
// block of the row pass (rows.cuh; the compaction keeps its own tile).
// Returns a cudaError_t code.
extern "C" int fused_compact_launch(
    const int* colors, const int* priority, const int* ell,
    const int* row_of, const int* base, const int* cu, const int* pu,
    const int* ids, const uint8_t* active, const uint8_t* pending,
    const uint8_t* hub_forb, const uint8_t* hub_lose, const int* hub_slot,
    int* new_c, int* new_b, uint8_t* still, int* items, int* count,
    unsigned long long* scratch, int64_t n_rows, int64_t n_graph_rows,
    int k_width, int window, int pad, int n_hub, int64_t capacity,
    int n_sentinel, int no_color, int tile_rows, void* stream) {
  if (window < 1 || window > rows::kMaxWindow)
    return (int)cudaErrorInvalidValue;
  // (an empty hub_slot, of a graph with no rows, may come as null)
  if ((hub_forb == nullptr) != (hub_lose == nullptr) ||
      (hub_forb != nullptr && hub_slot == nullptr && n_graph_rows > 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_rows > 0) {
    const RowArgs a{colors, priority, row_of, base, cu, pu, ids, active,
                    pending, hub_forb, hub_lose, hub_slot, new_c, new_b,
                    still, n_rows, n_graph_rows, 0, window, pad,
                    hub_forb == nullptr ? 0 : n_hub, 0, no_color};
    int err = 0;
    ROWS_DISPATCH_NW(window, NW,
                     err = launch_rows<NW>(ell, a, k_width, tile_rows, s));
    if (err) return err;
  }
  return compact::launch(still, ids, n_rows, capacity, n_sentinel, items,
                         count, scratch, s);
}

// One IPGC iteration: resolve, windowed mex, new color and base, and the
// ordered emission of the surviving rows' ids.
//
// Replaces: src/repro/kernels/fused_compact.py, _fused_compact_kernel /
// fused_compact_pallas (ipgc._fused_compact_rows, both fused steps).
//
// Per row r, with the predicates in the order of _fused_compact_rows:
//   lose  = pending[r] && (some k: nc == cu[r] >= 0 with a higher
//           (npr, nid) pair than (pu[r], ids[r]))  [|| hub_lose[r] && pending[r]]
//   first = first free slot of [base, base+W) given nc [| extra_forb]
//   need  = lose || (active[r] && cu[r] < 0)
//   new_c = need && first >= 0 ? base + first : (lose ? no_color : cu)
//   new_b = need && first < 0 ? base + W : base
//   still = need; items = ids of the still rows in ascending row order,
//   sentinel-padded to `capacity`; count = number of still rows.
// Two variants: no-hub (extra_forb and hub_lose null) and hub.
//
// Bound: memory. A row that is neither active nor pending cannot change,
// so the kernel reads its neighbour tiles not at all; an active row reads
// its K colors, and the priority and id tiles only at same-color entries.
//
// Design: the row pass is mex_window's and conflict's lane-group scheme
// fused over one read of the color tile (rows.cuh); the emission is
// compact.cuh's three-launch ordered compaction over the `still` flags with
// the ids as values, so this call is four launches.
#include "compact.cuh"
#include "rows.cuh"

namespace {

template <int NW>
__global__ void __launch_bounds__(rows::kThreads)
fused_rows_kernel(const int* __restrict__ nc, const int* __restrict__ npr,
                  const int* __restrict__ nid, const int* __restrict__ base,
                  const int* __restrict__ cu, const int* __restrict__ pu,
                  const int* __restrict__ ids,
                  const uint8_t* __restrict__ active,
                  const uint8_t* __restrict__ pending,
                  const uint8_t* __restrict__ extra,
                  const uint8_t* __restrict__ hub_lose,
                  int* __restrict__ new_c, int* __restrict__ new_b,
                  uint8_t* __restrict__ still, int64_t n_rows, int k_width,
                  int window, int lpr_log2, int no_color) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = tid >> lpr_log2;
  const int lpr = 1 << lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const bool live = row < n_rows;

  bool act = false, pend = false;
  int c = 0, b = 0;
  if (live) {
    act = active[row] != 0;
    pend = pending[row] != 0;
    c = cu[row];
    b = base[row];
  }
  int lose = 0;
  rows::Bitmap<NW> forb;
  forb.clear();
  if (act || pend) {
    const bool check = pend && c >= 0;
    const int p = pu[row];
    const int u = ids[row];
    const int64_t off = row * k_width;
    for (int k = sub; k < k_width; k += lpr) {
      const int v = nc[off + k];
      forb.add_color(v, b, window);
      if (check && v == c) {
        const int q = npr[off + k];
        lose |= (q > p) || (q == p && nid[off + k] > u);
      }
    }
    if (extra != nullptr) {
      const uint8_t* e = extra + row * window;
      for (int j = sub; j < window; j += lpr)
        if (e[j]) forb.set(j);
    }
  }
  forb.reduce(lpr_log2);
  lose = rows::reduce_or(lose, lpr_log2);
  if (live && sub == 0) {
    bool l = lose != 0;  // already requires pending
    if (hub_lose != nullptr) l = l || (hub_lose[row] != 0 && pend);
    const int first = forb.first_free(window);
    const bool has = first >= 0;
    const bool need = l || (act && c < 0);
    new_c[row] = (need && has) ? b + first : (l ? no_color : c);
    new_b[row] = (need && !has) ? b + window : b;
    still[row] = (uint8_t)need;
  }
}

template <int NW>
int launch_rows(const int* nc, const int* npr, const int* nid,
                const int* base, const int* cu, const int* pu,
                const int* ids, const uint8_t* active,
                const uint8_t* pending, const uint8_t* extra,
                const uint8_t* hub_lose, int* new_c, int* new_b,
                uint8_t* still, int64_t n_rows, int k_width, int window,
                int no_color, cudaStream_t stream) {
  const int lg = rows::lanes_log2(k_width);
  fused_rows_kernel<NW><<<rows::blocks_for(n_rows, lg), rows::kThreads, 0,
                          stream>>>(nc, npr, nid, base, cu, pu, ids, active,
                                    pending, extra, hub_lose, new_c, new_b,
                                    still, n_rows, k_width, window, lg,
                                    no_color);
  return (int)cudaGetLastError();
}

}  // namespace

// extra and hub_lose are both null (no-hub variant) or both set (hub
// variant); scratch holds
// ceil(n_rows / compact::kTile) ints, at least one. Returns a
// cudaError_t code.
extern "C" int fused_compact_launch(
    const int* nc, const int* npr, const int* nid, const int* base,
    const int* cu, const int* pu, const int* ids, const uint8_t* active,
    const uint8_t* pending, const uint8_t* extra, const uint8_t* hub_lose,
    int* new_c, int* new_b, uint8_t* still, int* items, int* count,
    int* scratch, int64_t n_rows, int k_width, int window, int64_t capacity,
    int n_sentinel, int no_color, void* stream) {
  if (window < 1 || window > rows::kMaxWindow)
    return (int)cudaErrorInvalidValue;
  if ((extra == nullptr) != (hub_lose == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_rows > 0) {
    int err = 0;
    ROWS_DISPATCH_NW(window, NW,
                     err = launch_rows<NW>(nc, npr, nid, base, cu, pu, ids,
                                           active, pending, extra, hub_lose,
                                           new_c, new_b, still, n_rows,
                                           k_width, window, no_color, s));
    if (err) return err;
  }
  return compact::launch(still, ids, n_rows, capacity, n_sentinel, items,
                         count, scratch, s);
}

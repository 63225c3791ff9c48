// Fused resolve + windowed mex over one neighbour-color tile, without the
// new-color selection and the emission.
//
// Replaces: src/repro/kernels/fused_step.py, _fused_kernel /
// fused_step_pallas (ipgc._fused_rows, which every fused step of the
// distributed Pipe calls: its emission follows the cross-shard exchange,
// so it cannot fold into the row pass as fused_compact's does).
//
// Per row r:
//   lose[r]  = pending[r] && some k: nc[r,k] == cu[r] >= 0 &&
//              (npr[r,k] > pu[r] || (npr[r,k] == pu[r] && nid[r,k] > ids[r]))
//   first[r] = the first slot i of [0, W) with nc[r,k] - base[r] != i for
//              every k and extra[r,i] false; -1 when every slot is taken.
// Two variants: no-hub (extra null) and hub.
//
// Bound: memory. Every row reads its K colors (the caller reads first
// wherever it needs a new color, and the kernel cannot tell those rows
// apart), its four row scalars and pending, and W bytes of extra in the hub
// variant; the priority and id tiles are read only at same-color entries of
// pending rows. The work is a few integer instructions per byte read.
//
// Design: fused_compact.cu's row pass without the select and the emission
// (rows.cuh): a lane group of K rounded up to a power of two (at most 32)
// owns a row, each lane keeps a ceil(W/32)-word forbidden bitmap in
// registers, the group ORs bitmaps and lose flags with XOR shuffles and lane
// 0 finds the first free slot with __ffs and writes both outputs. One
// launch, no synchronisation; R = 0 launches nothing. W <= 256.
#include "rows.cuh"

namespace {

template <int NW>
__global__ void __launch_bounds__(rows::kThreads)
fused_step_kernel(const int* __restrict__ nc, const int* __restrict__ npr,
                  const int* __restrict__ nid, const int* __restrict__ base,
                  const int* __restrict__ cu, const int* __restrict__ pu,
                  const int* __restrict__ ids,
                  const uint8_t* __restrict__ pending,
                  const uint8_t* __restrict__ extra,
                  uint8_t* __restrict__ lose_out, int* __restrict__ first_out,
                  int64_t n_rows, int k_width, int window, int lpr_log2) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = tid >> lpr_log2;
  const int lpr = 1 << lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const bool live = row < n_rows;

  int lose = 0;
  rows::Bitmap<NW> forb;
  forb.clear();
  if (live) {
    const int b = base[row];
    const int c = cu[row];
    const bool check = pending[row] != 0 && c >= 0;
    const int p = check ? pu[row] : 0;
    const int u = check ? ids[row] : 0;
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
    lose_out[row] = (uint8_t)(lose != 0);
    first_out[row] = forb.first_free(window);
  }
}

template <int NW>
int launch(const int* nc, const int* npr, const int* nid, const int* base,
           const int* cu, const int* pu, const int* ids,
           const uint8_t* pending, const uint8_t* extra, uint8_t* lose,
           int* first, int64_t n_rows, int k_width, int window,
           cudaStream_t stream) {
  const int lg = rows::lanes_log2(k_width);
  fused_step_kernel<NW><<<rows::blocks_for(n_rows, lg), rows::kThreads, 0,
                          stream>>>(nc, npr, nid, base, cu, pu, ids, pending,
                                    extra, lose, first, n_rows, k_width,
                                    window, lg);
  return (int)cudaGetLastError();
}

}  // namespace

// extra may be null (the no-hub variant). Returns a cudaError_t code.
extern "C" int fused_step_launch(const int* nc, const int* npr,
                                 const int* nid, const int* base,
                                 const int* cu, const int* pu, const int* ids,
                                 const uint8_t* pending, const uint8_t* extra,
                                 uint8_t* lose, int* first, int64_t n_rows,
                                 int k_width, int window, void* stream) {
  if (window < 1 || window > rows::kMaxWindow)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  ROWS_DISPATCH_NW(window, NW,
                   return launch<NW>(nc, npr, nid, base, cu, pu, ids,
                                     pending, extra, lose, first, n_rows,
                                     k_width, window, (cudaStream_t)stream));
  return 0;
}

// Windowed mex over pre-gathered neighbour colors.
//
// Replaces: src/repro/kernels/mex_window.py, _mex_kernel / mex_window_pallas
// (the assign pass of the two-phase IPGC step, ipgc._mex_rows).
//
// Computes, per row r, the first index i in [0, W) such that no neighbour
// color nc[r, k] equals base[r] + i and extra_forb[r, i] is false; -1 when
// the whole window is forbidden. Colors below 0 (uncolored, padding) never
// forbid anything.
//
// Bound: memory. Each row reads K int32 colors, one base and W bytes of
// extra_forb and writes one int32; the bit work is a few integer
// instructions per byte read, far below the card's integer rate.
//
// Design: a group of LPR lanes (LPR = K rounded up to a power of two, at
// most 32) owns a row, so the lanes of a warp read consecutive addresses of
// the row-major (R, K) tile whatever K is. Each lane builds a private
// forbidden bitmap of ceil(W/32) register words, the group ORs the bitmaps
// with XOR shuffles, and lane 0 of the group finds the first zero bit with
// __ffs. W is limited to 256 (eight words). The TPU kernel's (TILE_R, W)
// compare tensor has no counterpart: the bitmap replaces it.
#include "rows.cuh"

namespace {

template <int NW, int B>
__global__ void __launch_bounds__(B)
mex_window_kernel(const int* __restrict__ nc, const int* __restrict__ base,
                  const uint8_t* __restrict__ extra, int* __restrict__ out,
                  int64_t n_rows, int k_width, int window, int lpr_log2) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = tid >> lpr_log2;
  const int lpr = 1 << lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const bool live = row < n_rows;

  rows::Bitmap<NW> forb;
  forb.clear();
  if (live) {
    const int b = base[row];
    const int* colors = nc + row * k_width;
    for (int k = sub; k < k_width; k += lpr) forb.add_color(colors[k], b, window);
    if (extra != nullptr) {
      const uint8_t* e = extra + row * window;
      for (int j = sub; j < window; j += lpr)
        if (e[j]) forb.set(j);
    }
  }
  forb.reduce(lpr_log2);
  if (live && sub == 0) out[row] = forb.first_free(window);
}

template <int NW>
int launch(const int* nc, const int* base, const uint8_t* extra, int* out,
           int64_t n_rows, int k_width, int window, int tile_rows,
           cudaStream_t stream) {
  const int lg = rows::lanes_log2(k_width);
  const int nt = rows::block_threads(tile_rows, lg);
  ROWS_DISPATCH_BOUND(nt, B,
      mex_window_kernel<NW, B><<<rows::blocks_for(n_rows, lg, nt), nt, 0,
                                 stream>>>(nc, base, extra, out, n_rows,
                                           k_width, window, lg));
  return (int)cudaGetLastError();
}

}  // namespace

// extra may be null (no extra forbidden slots); tile_rows <= 0 is the
// default block (rows.cuh). Returns a cudaError_t code.
extern "C" int mex_window_launch(const int* nc, const int* base,
                                 const uint8_t* extra, int* out,
                                 int64_t n_rows, int k_width, int window,
                                 int tile_rows, void* stream) {
  if (n_rows == 0) return 0;
  if (window < 1 || window > rows::kMaxWindow)
    return (int)cudaErrorInvalidValue;
  ROWS_DISPATCH_NW(window, NW,
                   return launch<NW>(nc, base, extra, out, n_rows, k_width,
                                     window, tile_rows,
                                     (cudaStream_t)stream));
  return 0;
}

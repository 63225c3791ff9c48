// The int8 decode's two products over an int8 KV cache, exact in int32.
//
// Replaces no Pallas kernel: the reference computes these dots with
// jnp.einsum(..., preferred_element_type=jnp.int32) in
// src/repro/models/attention.py, decode_attention_q8 (the scores at :215,
// the values at :228), which XLA lowers to int8 x int8 -> int32 dots.
// PyTorch has no batched int8 product on the card (torch._int_mm is 2-D
// and wants m > 16), and a bf16 product is not exact for the values once
// S * 127^2 passes 2^24, so the port has this kernel.
//
//   scores: qq (B, Hk, G, D) int8 x k (B, S, Hk, D) int8 -> (B, Hk, G, S)
//           out[b,h,g,s] = sum_d qq[b,h,g,d] * k[b,s,h,d]
//   values: pq (B, Hk, G, S) int8 x v (B, S, Hk, D) int8 -> (B, Hk, G, D)
//           out[b,h,g,d] = sum_s pq[b,h,g,s] * v[b,s,h,d]
//
// Sums wrap modulo 2^32, as the reference's int32 dot does: every add is
// a __dp4a or an unsigned add, so the result does not depend on the order
// of the sums.
//
// Bound: memory. Both products read the layer's cache (S * Hk * D bytes a
// batch row) once and do G multiply-adds a cache byte (G <= 12 at the
// published widths); the scores also write B * Hk * G * S int32.
//
// Design, simple first:
// * scores: one thread a (b, h, position). The block's G query rows sit
//   in shared memory; a thread reads its cache row in 16-byte loads (4
//   when D is no multiple of 16) and keeps one __dp4a sum a query row.
//   Neighbouring threads write neighbouring positions.
// * values: one block a (b, h, slice of positions). Its G rows of pq for
//   the slice are staged in shared memory; a thread owns 4 head
//   dimensions and walks the slice 4 positions at a time: 4 words of v
//   (4 positions x 4 dimensions) are transposed with __byte_perm into one
//   word a dimension (4 positions), each a __dp4a with pq's word of the
//   same 4 positions. The lanes' sums meet in shared memory and each
//   block adds its slice's sums into the output with an atomicAdd, after a
//   cudaMemsetAsync of the output on the same stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 16;           // query rows a pass keeps in registers
constexpr int kSliceMax = 1024;     // positions a values block stages
constexpr int kTargetBlocks = 1056; // 8 blocks an SM on 132 SMs

template <int VEC>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const int8_t* __restrict__ qq, const int8_t* __restrict__ k,
              int* __restrict__ out, int64_t S, int Hk, int G, int D) {
  extern __shared__ int q_words[];              // G rows of D / 4 words
  const int b = blockIdx.z, h = blockIdx.y;
  const int dw = D / 4;
  const int8_t* qrow = qq + ((int64_t)b * Hk + h) * G * D;
  int8_t* qs = reinterpret_cast<int8_t*>(q_words);
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) qs[i] = qrow[i];
  __syncthreads();
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int* krow =
      reinterpret_cast<const int*>(k + (((int64_t)b * S + s) * Hk + h) * D);
  int* orow = out + ((int64_t)b * Hk + h) * G * S + s;
  for (int g0 = 0; g0 < G; g0 += kMaxG) {
    int acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0;
    for (int j = 0; j < dw; j += VEC) {
      int w[VEC];
      if constexpr (VEC == 4) {
        const int4 x = *reinterpret_cast<const int4*>(krow + j);
        w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
      } else {
        w[0] = krow[j];
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g0 + g < G) {
          const int* qw = q_words + (g0 + g) * dw + j;
#pragma unroll
          for (int u = 0; u < VEC; ++u) acc[g] = __dp4a(w[u], qw[u], acc[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g0 + g < G) orow[(int64_t)(g0 + g) * S] = acc[g];
  }
}

// Byte j of each of w0..w3, as the bytes 0..3 of one word.
__device__ __forceinline__ int column(int w0, int w1, int w2, int w3, int j) {
  const unsigned sel = (unsigned)j | ((unsigned)(4 + j) << 4);
  const unsigned lo = __byte_perm(w0, w1, sel);
  const unsigned hi = __byte_perm(w2, w3, sel);
  return (int)__byte_perm(lo, hi, 0x5410);
}

// Query rows g0 .. g0 + gn - 1 (gn <= kMaxG) over one slice of `slice`
// positions (a multiple of 4). blockDim.x = (D / 4) * lanes.
__global__ void __launch_bounds__(kThreads)
values_kernel(const int8_t* __restrict__ pq, const int8_t* __restrict__ v,
              int* __restrict__ out, int64_t S, int Hk, int G, int D,
              int g0, int gn, int slice) {
  extern __shared__ int smem[];
  int* p_words = smem;                                  // gn x slice / 4
  unsigned* sums = reinterpret_cast<unsigned*>(smem + gn * (slice / 4));
  const int b = blockIdx.z, h = blockIdx.y;
  const int64_t s0 = (int64_t)blockIdx.x * slice;
  const int len = (int)(S - s0 < slice ? S - s0 : slice);
  const int64_t bh = (int64_t)b * Hk + h;
  int8_t* ps = reinterpret_cast<int8_t*>(p_words);
  for (int i = threadIdx.x; i < gn * slice; i += blockDim.x) {
    const int g = i / slice, t = i - g * slice;
    ps[i] = t < len ? pq[(bh * G + g0 + g) * S + s0 + t] : (int8_t)0;
  }
  for (int i = threadIdx.x; i < gn * D; i += blockDim.x) sums[i] = 0u;
  __syncthreads();

  const int dw = D / 4;
  const int dq = threadIdx.x % dw;
  const int lane = threadIdx.x / dw;
  const int lanes = blockDim.x / dw;
  const int64_t row = (int64_t)Hk * dw;           // words between positions
  const int* vw =
      reinterpret_cast<const int*>(v) + ((int64_t)b * S + s0) * row +
      (int64_t)h * dw + dq;
  int acc[kMaxG][4];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0;
  for (int t = 4 * lane; t < len; t += 4 * lanes) {
    int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = t + i < len ? vw[(t + i) * row] : 0;
    int x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = column(w[0], w[1], w[2], w[3], j);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < gn) {
        const int pw = p_words[g * (slice / 4) + t / 4];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][j] = __dp4a(x[j], pw, acc[g][j]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < gn)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        atomicAdd(&sums[g * D + 4 * dq + j], (unsigned)acc[g][j]);
  __syncthreads();
  unsigned* o = reinterpret_cast<unsigned*>(out) + (bh * G + g0) * D;
  for (int i = threadIdx.x; i < gn * D; i += blockDim.x)
    atomicAdd(&o[i], sums[i]);
}

}  // namespace

// qq (B, Hk, G, D), k (B, S, Hk, D) int8, out (B, Hk, G, S) int32, all
// contiguous; D a multiple of 4. Returns a cudaError_t code.
extern "C" int q8_scores_launch(const int8_t* qq, const int8_t* k, int* out,
                                int64_t B, int64_t S, int Hk, int G, int D,
                                void* stream) {
  if (B == 0 || S == 0 || Hk == 0 || G == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)Hk,
                  (unsigned)B);
  const size_t smem = (size_t)G * D;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(k);
  if (D % 16 == 0 && (addr & 15) == 0)
    scores_kernel<4><<<grid, kThreads, smem, st>>>(qq, k, out, S, Hk, G, D);
  else
    scores_kernel<1><<<grid, kThreads, smem, st>>>(qq, k, out, S, Hk, G, D);
  return (int)cudaGetLastError();
}

// Positions a values block takes: enough blocks to fill the card, at most
// kSliceMax, a multiple of 16.
static int values_slice(int64_t B, int64_t S, int Hk) {
  const int64_t bh = B * Hk;
  int64_t n = (kTargetBlocks + bh - 1) / bh;
  const int64_t most = (S + 255) / 256;
  if (n > most) n = most;
  const int64_t least = (S + kSliceMax - 1) / kSliceMax;
  if (n < least) n = least;
  if (n < 1) n = 1;
  const int64_t per = (S + n - 1) / n;
  return (int)((per + 15) / 16 * 16);
}

// pq (B, Hk, G, S), v (B, S, Hk, D) int8, out (B, Hk, G, D) int32, all
// contiguous; D a multiple of 4, at most 512. Zeroes out, then one launch
// a pass of at most 16 query rows. Returns a cudaError_t code; *launches
// is set to the kernels launched.
extern "C" int q8_values_launch(const int8_t* pq, const int8_t* v, int* out,
                                int64_t B, int64_t S, int Hk, int G, int D,
                                int* launches, void* stream) {
  *launches = 0;
  if (B == 0 || Hk == 0 || G == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)B * Hk * G * D * 4, st);
  if (err != cudaSuccess || S == 0) return (int)err;
  const int slice = values_slice(B, S, Hk);
  const int dw = D / 4;
  const int lanes = dw >= kThreads ? 1 : kThreads / dw;
  const dim3 grid((unsigned)((S + slice - 1) / slice), (unsigned)Hk,
                  (unsigned)B);
  for (int g0 = 0; g0 < G; g0 += kMaxG) {
    const int gn = G - g0 < kMaxG ? G - g0 : kMaxG;
    const size_t smem = (size_t)gn * slice + (size_t)gn * D * 4;
    values_kernel<<<grid, dw * lanes, smem, st>>>(pq, v, out, S, Hk, G, D,
                                                  g0, gn, slice);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return 0;
}

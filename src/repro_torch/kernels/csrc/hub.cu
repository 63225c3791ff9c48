// The hub side-channel of the ELL steps: one pass over the COO tail per
// table, with a per-entry source gate.
//
// Replaces no Pallas kernel: the reference writes the side-channel as jnp
// scatters (src/repro/core/ipgc.py, _hub_forbidden and _hub_lose), which
// the port ran as a dozen PyTorch passes over the whole tail each.
//
// A tail entry e joins source s = tail_src[e] (a hub, degree > K) to
// d = tail_dst[e]; padding entries are invalid. slot = hub_slot[s] (where
// the entry is valid, hub_slot[s] == tail_slot[e]). Both kernels read
// gate[s] first and nothing more of an entry whose gate is off:
//   hub_forbidden: out[slot, rel] = 1 where valid, c = colors[d] >= 0 and
//                  0 <= rel = c - base[s] < W
//   hub_lose:      out[slot] = 1 where valid, cu = colors[s] >= 0,
//                  cu == colors[d] and (priority[d], d) > (priority[s], s)
// The launch zeroes out (cudaMemsetAsync on the stream), then the kernel
// writes only slots < n_hub, so row n_hub stays all zero. Every write
// stores 1: no atomics on the tables.
//
// Bound: memory. Every entry's source id (4 bytes) is streamed; an entry
// whose gate is on also streams its destination and valid flag (5) and
// gathers a color (and, for lose, a priority) at random from the 4(N+1)
// byte vectors, which stay in the 50 MB L2 at the sizes the engine runs.
// The gate, base, hub_slot and the source's own color and priority are
// read per entry, from L1 where a run of entries shares its source.
//
// Design: a thread takes 4 consecutive entries a pass (16-byte streaming
// loads of tail_src and, when one of its gates is on, tail_dst; 4 bytes of
// tail_valid), in a grid-stride loop over enough blocks to fill the SMs.
// The tail is sorted by (source, destination), so a warp's 128 entries
// nearly always share one source: a warp whose gates are all off moves on
// after its source loads. Hits are reduced over the warp before they are
// stored: lanes with one (slot, 32-color word) are matched
// (__match_any_sync), their color bits ORed (__reduce_or_sync), and the
// warp stores each distinct word's set bytes in one coalesced store; lose
// flags are matched on the slot and stored once per distinct slot. Any
// order of the tail is right (padded batch lanes break the sort); the
// sorted one is fast. With a non-null visited pointer each block adds the
// entries its gates let through to it, one atomicAdd a block. One launch,
// no synchronisation, no allocation: capturable (with the memset). W <= 256.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxWindow = 256;
constexpr int kMaxDevices = 64;

struct Tail {
  const int* src;
  const int* dst;
  const uint8_t* valid;
  const int* hub_slot;
  const uint8_t* gate;
  int64_t n;          // entries
  int n_hub;
};

// Four entries from e on: 16-byte streaming loads where the four are in
// range (the wrapper requires 16-byte aligned arrays), else one by one;
// entries past the end get fill.
__device__ __forceinline__ void load4(const int* p, int64_t e, int64_t n,
                                      int fill, int (&v)[4]) {
  if (e + 3 < n) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p + e));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = e + k < n ? __ldcs(p + e + k) : fill;
}

__device__ __forceinline__ void load4(const uint8_t* p, int64_t e, int64_t n,
                                      bool (&v)[4]) {
  if (e + 3 < n) {
    const uchar4 q = __ldcs(reinterpret_cast<const uchar4*>(p + e));
    v[0] = q.x != 0; v[1] = q.y != 0; v[2] = q.z != 0; v[3] = q.w != 0;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = e + k < n && p[e + k] != 0;
}

// The gate of the four entries of a pass: one read per run of equal
// sources. Returns how many are on.
__device__ __forceinline__ int gate4(const Tail& t, int64_t e,
                                     const int (&s)[4], bool (&on)[4]) {
  int count = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (e + k >= t.n) {
      on[k] = false;
    } else if (k > 0 && s[k] == s[k - 1]) {
      on[k] = on[k - 1];
    } else {
      on[k] = __ldg(t.gate + s[k]) != 0;
    }
    count += on[k];
  }
  return count;
}

// Adds each block's gated entries to *visited (one atomicAdd a block).
__device__ __forceinline__ void add_visited(unsigned long long* visited,
                                           int64_t mine) {
  __shared__ unsigned long long block_sum;
  if (threadIdx.x == 0) block_sum = 0;
  __syncthreads();
  const unsigned lo = __reduce_add_sync(kFull, (unsigned)mine);
  if ((threadIdx.x & 31) == 0 && lo) atomicAdd(&block_sum, lo);
  __syncthreads();
  if (threadIdx.x == 0 && block_sum) atomicAdd(visited, block_sum);
}

__global__ void __launch_bounds__(kThreads)
hub_forbidden_kernel(const Tail t, const int* __restrict__ colors,
                     const int* __restrict__ base, int window,
                     uint8_t* __restrict__ out,
                     unsigned long long* visited) {
  const int lane = threadIdx.x & 31;
  const int64_t quads = (t.n + 3) >> 2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t mine = 0;
  // warps walk whole: every lane of a warp runs every pass
  for (int64_t q0 = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       q0 < quads; q0 += stride) {
    const int64_t e = (q0 + lane) << 2;
    int s[4];
    bool on[4];
    load4(t.src, e, t.n, 0, s);
    const int n_on = gate4(t, e, s, on);
    mine += n_on;
    if (__ballot_sync(kFull, n_on > 0) == 0u) continue;

    bool hit[4] = {false, false, false, false};
    int slot[4], rel[4];
    if (n_on > 0) {
      int d[4];
      bool ok[4];
      load4(t.dst, e, t.n, 0, d);
      load4(t.valid, e, t.n, ok);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(on[k] && ok[k])) continue;
        const int c = __ldg(colors + d[k]);
        if (c < 0) continue;
        const int r = c - __ldg(base + s[k]);
        if (r < 0 || r >= window) continue;
        const int sl = __ldg(t.hub_slot + s[k]);
        if ((unsigned)sl >= (unsigned)t.n_hub) continue;
        hit[k] = true;
        slot[k] = sl;
        rel[k] = r;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (__ballot_sync(kFull, hit[k]) == 0u) continue;
      // one group per (slot, 32-color word); lanes without a hit group
      // under a key no hit has
      const unsigned long long key =
          hit[k] ? ((unsigned long long)slot[k] << 3) | (unsigned)(rel[k] >> 5)
                 : ~0ull;
      const unsigned grp = __match_any_sync(kFull, key);
      const unsigned bits =
          __reduce_or_sync(grp, hit[k] ? 1u << (rel[k] & 31) : 0u);
      unsigned leaders =
          __ballot_sync(kFull, hit[k] && lane == __ffs(grp) - 1);
      while (leaders) {
        const int from = __ffs(leaders) - 1;
        leaders &= leaders - 1;
        const unsigned long long kk = __shfl_sync(kFull, key, from);
        const unsigned b = __shfl_sync(kFull, bits, from);
        if ((b >> lane) & 1u)
          out[(int64_t)(kk >> 3) * window + ((int)(kk & 7u) << 5) + lane] = 1;
      }
    }
  }
  if (visited != nullptr) add_visited(visited, mine);
}

__global__ void __launch_bounds__(kThreads)
hub_lose_kernel(const Tail t, const int* __restrict__ colors,
                const int* __restrict__ priority, uint8_t* __restrict__ out,
                unsigned long long* visited) {
  const int lane = threadIdx.x & 31;
  const int64_t quads = (t.n + 3) >> 2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t mine = 0;
  for (int64_t q0 = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       q0 < quads; q0 += stride) {
    const int64_t e = (q0 + lane) << 2;
    int s[4];
    bool on[4];
    load4(t.src, e, t.n, 0, s);
    const int n_on = gate4(t, e, s, on);
    mine += n_on;
    if (__ballot_sync(kFull, n_on > 0) == 0u) continue;

    bool lose[4] = {false, false, false, false};
    int slot[4];
    if (n_on > 0) {
      int d[4];
      bool ok[4];
      load4(t.dst, e, t.n, 0, d);
      load4(t.valid, e, t.n, ok);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(on[k] && ok[k])) continue;
        const int cu = __ldg(colors + s[k]);
        if (cu < 0 || cu != __ldg(colors + d[k])) continue;
        const int pu = __ldg(priority + s[k]);
        const int pv = __ldg(priority + d[k]);
        if (!(pv > pu || (pv == pu && d[k] > s[k]))) continue;
        const int sl = __ldg(t.hub_slot + s[k]);
        if ((unsigned)sl >= (unsigned)t.n_hub) continue;
        lose[k] = true;
        slot[k] = sl;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (__ballot_sync(kFull, lose[k]) == 0u) continue;
      const unsigned grp = __match_any_sync(kFull, lose[k] ? slot[k] : -1);
      if (lose[k] && lane == __ffs(grp) - 1) out[slot[k]] = 1;
    }
  }
  if (visited != nullptr) add_visited(visited, mine);
}

// Blocks for n entries: enough to cover them, at most kBlocksPerSm on each
// SM of the current device (the grid-stride loop takes the rest).
int blocks_for(int64_t n) {
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& count = sms[dev < kMaxDevices ? dev : 0];
  if (count == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    count = v > 0 ? v : 132;
  }
  const int64_t quads = (n + 3) >> 2;
  const int64_t need = (quads + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)count * kBlocksPerSm;
  return (int)(need < cap ? need : cap);
}

}  // namespace

// tail_src, tail_dst (int32, 16-byte aligned) and tail_valid (bytes,
// 4-byte aligned) hold n_entries entries, sources in [0, N); hub_slot and gate hold N entries, colors
// N + 1 (base N); out is the (n_hub + 1, window) byte table, zeroed here.
// visited is null or one int64 counter. Returns a cudaError_t code.
extern "C" int hub_forbidden_launch(const int* tail_src, const int* tail_dst,
                                    const uint8_t* tail_valid,
                                    const int* hub_slot, const int* colors,
                                    const int* base, const uint8_t* gate,
                                    int window, int64_t n_entries, int n_hub,
                                    uint8_t* out, long long* visited,
                                    void* stream) {
  if (window < 1 || window > kMaxWindow) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t z =
      cudaMemsetAsync(out, 0, ((size_t)n_hub + 1) * (size_t)window, s);
  if (z != cudaSuccess || n_entries == 0) return (int)z;
  const Tail t{tail_src, tail_dst, tail_valid, hub_slot, gate, n_entries,
               n_hub};
  auto* v = reinterpret_cast<unsigned long long*>(visited);
  hub_forbidden_kernel<<<blocks_for(n_entries), kThreads, 0, s>>>(
      t, colors, base, window, out, v);
  return (int)cudaGetLastError();
}

// As hub_forbidden_launch; flags (the gate) holds N entries, colors and
// priority N + 1; out is the (n_hub + 1) byte table, zeroed here.
extern "C" int hub_lose_launch(const int* tail_src, const int* tail_dst,
                               const uint8_t* tail_valid, const int* hub_slot,
                               const int* colors, const int* priority,
                               const uint8_t* flags, int64_t n_entries,
                               int n_hub, uint8_t* out, long long* visited,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t z = cudaMemsetAsync(out, 0, (size_t)n_hub + 1, s);
  if (z != cudaSuccess || n_entries == 0) return (int)z;
  const Tail t{tail_src, tail_dst, tail_valid, hub_slot, flags, n_entries,
               n_hub};
  auto* v = reinterpret_cast<unsigned long long*>(visited);
  hub_lose_kernel<<<blocks_for(n_entries), kThreads, 0, s>>>(
      t, colors, priority, out, v);
  return (int)cudaGetLastError();
}

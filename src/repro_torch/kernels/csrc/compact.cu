// Ordered stream compaction of a bool mask (the worklist "push").
//
// Replaces: src/repro/kernels/compact.py, _compact_kernel / compact_pallas.
// In the port it serves core.worklist.compact_mask and compact_items, the
// worklist emission of the two-phase IPGC steps, the distributed steps,
// JPL and BFS, where the JAX package uses jnp.nonzero(size=...): a
// sync-free compaction with a fixed capacity and a device-side count, so
// the Pipe's one read-back per iteration stays the only one.
//
// Bound: memory. It reads the N mask bytes once, plus the values at the
// set flags when given, and writes `capacity` int32 and the count. Most
// calls are at the sparse floor of the capacity ladder (N = 1024), where
// the work is a few microseconds and each launch is the cost.
//
// Design: one kernel launch, a single-pass scan with decoupled look-back
// (compact.cuh): blocks take tiles by ticket, publish their aggregates,
// look back over their predecessors' status words for the exclusive
// prefix and rank their flags by warp ballot; positions never come from
// atomics, so the items are in ascending order on every run. The ticket
// and the status words are zeroed by a cudaMemsetAsync on the same stream
// before the launch: a separate memset operation on the stream, not a
// kernel launch.
#include "compact.cuh"

// values may be null (emit the index itself); state holds
// compact::state_words(n) 64-bit words. Returns a cudaError_t code.
extern "C" int compact_launch(const uint8_t* flags, const int* values,
                              int64_t n, int64_t capacity, int sentinel,
                              int* out, int* count, unsigned long long* state,
                              void* stream) {
  return compact::launch(flags, values, n, capacity, sentinel, out, count,
                         state, (cudaStream_t)stream);
}

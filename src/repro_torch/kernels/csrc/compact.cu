// Ordered stream compaction of a bool mask (the worklist "push").
//
// Replaces: src/repro/kernels/compact.py, _compact_kernel / compact_pallas.
// In the port it serves core.worklist.compact_mask and compact_items, the
// worklist emission of both two-phase IPGC steps, where the JAX package
// uses jnp.nonzero(size=...): a sync-free compaction with a fixed capacity
// and a device-side count, so the Pipe's one read-back per iteration stays
// the only one.
//
// Bound: memory. It reads the N mask bytes twice (count pass and write
// pass; the second read mostly hits L2), plus the values when given, and
// writes `capacity` int32.
//
// Design: three launches (tile counts, one-block scan of the tile counts,
// ordered write) in compact.cuh; positions come from the scan, never from
// atomics, so the items are in ascending order on every run.
#include "compact.cuh"

// values may be null (emit the index itself); scratch holds
// ceil(n / compact::kTile) ints, at least one. Returns a cudaError_t code.
extern "C" int compact_launch(const uint8_t* flags, const int* values,
                              int64_t n, int64_t capacity, int sentinel,
                              int* out, int* count, int* scratch,
                              void* stream) {
  return compact::launch(flags, values, n, capacity, sentinel, out, count,
                         scratch, (cudaStream_t)stream);
}

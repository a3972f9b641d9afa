// The Livox front end's split debounce on the card: the greedy pass over
// the rosette's turning-point candidates that the JAX package runs as a
// `lax.scan` (loam_livox_tpu/frontend/livox.py:186-205; reference
// livox_feature_extractor.hpp:541-566).  No Pallas kernel stood here;
// the scan is ported so that the frame program reads nothing on the host.
//
// A candidate (slot order) is kept when it is valid (index < n) and is
// the first kept of its kind (edge or zero), or lies more than `gap`
// samples past the last kept one.  Output: the split table, the kept
// indices, the terminator n_valid - 1 in the first free slot (when one
// is free), padding n, sorted ascending; and the number kept.
//
// Bound: neither bytes (~9 KB) nor operations (~4 a slot) bound it on
// this card; the scan is serial, so one thread walks the slots (the
// 512-slot table of the shipped capacity) and its time is the latency
// of ~512 dependent steps.  A parallel form (pointer doubling over the
// next-far-enough slot, as the plain version in ops/debounce.py does)
// is later work.

#include <cuda_runtime.h>

namespace {

__global__ void debounce_kernel(const long long* __restrict__ cand_idx,
                                const bool* __restrict__ cand_is_edge, int ns, long long n,
                                const long long* __restrict__ n_valid, long long gap,
                                long long* __restrict__ splits,
                                long long* __restrict__ n_accepted,
                                unsigned long long* __restrict__ runs) {
  if (runs != nullptr) atomicAdd(runs, 1ull);  // the run counter
  long long last = -1000000000LL;
  bool edge_seen = false, zero_seen = false;
  int kept = 0;
  for (int slot = 0; slot < ns; ++slot) {
    const long long ci = cand_idx[slot];
    if (ci >= n) continue;
    const bool is_edge = cand_is_edge[slot];
    const bool first = is_edge ? !edge_seen : !zero_seen;
    if (first || ci - last > gap) {
      splits[kept++] = ci;
      last = ci;
      edge_seen = edge_seen || is_edge;
      zero_seen = zero_seen || !is_edge;
    }
  }
  *n_accepted = kept;
  int filled = kept;
  if (kept < ns) splits[filled++] = *n_valid - 1;
  // insertion sort of the kept prefix and the terminator: one pass when
  // the candidates arrive in index order, as the front end gives them
  for (int i = 1; i < filled; ++i) {
    const long long v = splits[i];
    int j = i - 1;
    while (j >= 0 && splits[j] > v) {
      splits[j + 1] = splits[j];
      --j;
    }
    splits[j + 1] = v;
  }
  for (int i = filled; i < ns; ++i) splits[i] = n;
}

}  // namespace

extern "C" {

// cand_idx (ns,) int64 and cand_is_edge (ns,) bool on the card, n_valid a
// device int64 scalar; writes splits (ns,) int64 and n_accepted (an
// int64 scalar); `runs` (a device counter, or null) gains one each time
// the launch runs, in a CUDA graph at every replay.  Returns a CUDA error
// code, 0 on a launch accepted.
int debounce_launch(const long long* cand_idx, const bool* cand_is_edge, int ns, long long n,
                    const long long* n_valid, long long gap, long long* splits,
                    long long* n_accepted, unsigned long long* runs, void* stream) {
  if (ns <= 0) return cudaErrorInvalidValue;
  debounce_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      cand_idx, cand_is_edge, ns, n, n_valid, gap, splits, n_accepted, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

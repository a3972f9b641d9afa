// The voxel filter's segment sums on the card: each occupied voxel's
// centroid, mean time and mask from the points sorted by voxel key, in
// one launch (wrapper ops/voxel_centroid.py, caller ops/voxel.py).
//
// It replaces no Pallas kernel.  It replaces the three
// `jax.ops.segment_sum` calls of the JAX package's voxel filter
// (loam_livox_tpu/ops/voxel.py:88-90), which the port's plain version
// (`ops.voxel.centroids_plain`) computes with three
// `index_put_(accumulate=True)` calls.  Those calls sort their indices
// again and hand each run of equal indices to one thread or warp, which
// walks the run row by row: the masked rows and the rows past `capacity`
// carry the last segment's id, so every call walked the whole masked
// tail serially.
//
// Contract: keys (n,) int64 ascending, `invalid` (the masked rows' key)
// above every voxel key; seg (n,) int64 the plain version's segment ids
// (`ops.voxel.segment_ids`: a row's voxel among the valid keys, -1
// before any, a masked row the last voxel's); `order` the sort's
// permutation; xyz (n, 3) and time (n,) float32 in input order.  Slot
// s < capacity holds the s-th smallest voxel key's centroid, mean time
// (zeros without time) and true; the slots past the voxels hold zeros
// and false.  The results are bit for bit those of the plain version on
// the card, so the sums are taken in the order PyTorch's kernels take
// them:
// * xyz, a (capacity, 3) target (`indexing_backward_kernel_small_stride`):
//   each segment's column summed from 0.0 in sorted order;
// * count and time, 1-D targets (`indexing_backward_kernel_stride_1`): a
//   segment of fewer than 32 rows in sorted order; one of L >= 32 rows
//   (its zero-weight rows counted) as 32 lane partials (lane j mod 32,
//   over the first 32 floor(L / 32) rows), a shuffle-down tree (16, 8, 4,
//   2, 1), then the rest in order;
// * each sum added to the target's 0.0, then divided by the count.
// Zero-weight rows add +0.0 or -0.0, which leave a sum that started at
// +0.0 as it was, so only a voxel's own rows are read.
//
// Design: one thread a slot.  The slot's rows start at lower_bound(seg, s)
// and its segment ends at lower_bound(seg, s + 1) (at row n for the last
// slot, whose segment the plain version's clamp extends over the voxels
// past `capacity`).  The voxel's own rows are the segment's first rows:
// valid keys sort before the masked key, and a slot's own key before
// those of later voxels.  The segment's length L enters only the lane
// rule, never a loop.  A launch allocates nothing and reads nothing on
// the host, so it runs inside CUDA graphs and conditional bodies.
//
// Bound: bytes, ~32 a contributing row (its key, its order entry, its
// xyz and time, gathered) and 17 an output slot: ~1.6 MB at 49,152 rows,
// half a microsecond at 3.35 TB/s.  The kernel's time is the binary
// searches' dependent loads (~17 steps each at 10^5 rows, their first
// levels shared by every thread in L1) and two dependent loads a row of
// a voxel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;

// the first i in [lo, n) with a[i] >= v (n when none)
__device__ int lower_bound(const long long* __restrict__ a, int lo, int n, long long v) {
  int hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// slot `slot` from the voxel's sorted rows [s, s + c); `len` rows the
// segment the plain version sums over
__device__ void centroid(const long long* __restrict__ order, const float* __restrict__ xyz,
                         const float* __restrict__ time, int s, int c, int len, int slot,
                         float* __restrict__ out_xyz, float* __restrict__ out_time,
                         bool* __restrict__ out_mask) {
  float x = 0.0f, y = 0.0f, z = 0.0f, t = 0.0f;
  int j = 0;
  // the rows that go to the stride-1 kernel's lane partials
  const int lane_rows = time != nullptr ? min(c, len / kLanes * kLanes) : 0;
  if (lane_rows > 0) {
    float part[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) part[l] = 0.0f;
    for (; j < lane_rows; ++j) {
      const long long o = order[s + j];
      x = __fadd_rn(x, xyz[3 * o]);
      y = __fadd_rn(y, xyz[3 * o + 1]);
      z = __fadd_rn(z, xyz[3 * o + 2]);
      part[j % kLanes] = __fadd_rn(part[j % kLanes], time[o]);
    }
    // lane 0's value after __shfl_down by 16, 8, 4, 2, 1
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int l = 0; l < off; ++l) part[l] = __fadd_rn(part[l], part[l + off]);
    }
    t = part[0];
  }
#pragma unroll 4
  for (; j < c; ++j) {
    const long long o = order[s + j];
    x = __fadd_rn(x, xyz[3 * o]);
    y = __fadd_rn(y, xyz[3 * o + 1]);
    z = __fadd_rn(z, xyz[3 * o + 2]);
    if (time != nullptr) t = __fadd_rn(t, time[o]);
  }
  const float count = static_cast<float>(c);
  out_xyz[3ll * slot] = __fdiv_rn(__fadd_rn(0.0f, x), count);
  out_xyz[3ll * slot + 1] = __fdiv_rn(__fadd_rn(0.0f, y), count);
  out_xyz[3ll * slot + 2] = __fdiv_rn(__fadd_rn(0.0f, z), count);
  out_time[slot] = time != nullptr ? __fdiv_rn(__fadd_rn(0.0f, t), count) : 0.0f;
  out_mask[slot] = true;
}

__global__ void __launch_bounds__(kThreads)
    voxel_centroid_kernel(const long long* __restrict__ key, const long long* __restrict__ seg,
                          const long long* __restrict__ order, const float* __restrict__ xyz,
                          const float* __restrict__ time, int n, int capacity,
                          long long invalid, float* __restrict__ out_xyz,
                          float* __restrict__ out_time, bool* __restrict__ out_mask,
                          unsigned long long* __restrict__ runs) {
  const long long thread = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (thread == 0 && runs != nullptr) atomicAdd(runs, 1ull);  // the run counter
  if (thread >= capacity) return;
  const int slot = static_cast<int>(thread);
  const long long voxels = n > 0 ? seg[n - 1] + 1 : 0;
  if (slot >= voxels) {
    out_xyz[3ll * slot] = out_xyz[3ll * slot + 1] = out_xyz[3ll * slot + 2] = 0.0f;
    out_time[slot] = 0.0f;
    out_mask[slot] = false;
    return;
  }
  const int start = lower_bound(seg, 0, n, slot);
  const int next = lower_bound(seg, start, n, slot + 1ll);
  const int valid = lower_bound(key, start, n, invalid);  // the first masked row
  const int end = slot == capacity - 1 ? n : next;
  centroid(order, xyz, time, start, min(next, valid) - start, end - start, slot, out_xyz,
           out_time, out_mask);
}

}  // namespace

extern "C" {

// key, seg and order (n,) int64, xyz (n, 3) and time (n,) float32 (time
// null: zero times), all contiguous on the card, 0 <= n < 2^24,
// capacity >= 1; writes out_xyz (capacity, 3), out_time (capacity,)
// float32 and out_mask (capacity,) bool.  `runs` (a device counter, or
// null) gains one each time the launch runs, in a CUDA graph at every
// replay.  Returns a CUDA error code, 0 on a launch accepted.
int voxel_centroid_launch(const long long* key, const long long* seg, const long long* order,
                          const float* xyz, const float* time, int n, int capacity,
                          long long invalid, float* out_xyz, float* out_time, bool* out_mask,
                          unsigned long long* runs, void* stream) {
  if (n < 0 || n >= (1 << 24) || capacity < 1) return cudaErrorInvalidValue;
  const int blocks =
      static_cast<int>((static_cast<long long>(capacity) + kThreads - 1) / kThreads);
  voxel_centroid_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key, seg, order, xyz, time, n, capacity, invalid, out_xyz, out_time, out_mask, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Product mode's candidate exchange on the card: every rank's (rows, k)
// kNN candidates gathered from its peers and merged by (distance, index),
// in one kernel, the counterpart of the all-gather and merge of
// parallel/sharded.knn_sharded (loam_livox_tpu/parallel/sharded.py's
// sharded search; no Pallas kernel stood here: the JAX package leaves the
// collective to XLA).  It replaces NCCL's all-gather inside the frame
// program's ICP passes: a CUDA graph WHILE node's body admits kernel
// nodes, and across ranks the card refused a frame graph with NCCL's
// captured all-gather there.
//
// Each rank holds one symmetric buffer and one signal pad, allocated and
// exchanged once at mesh set-up by torch's symmetric-memory rendezvous
// (ops/peer_gather.py); the kernel is handed the device arrays of every
// rank's buffer and pad pointers.  Block b of every rank takes the same
// rows [b * chunk, (b + 1) * chunk):
//   1. it writes its own candidates of those rows into its own buffer;
//   2. a barrier on channel b: thread r signals peer r's pad slot
//      (b, rank) (0 -> 1, after a system-scope fence) and waits for its
//      own slot (b, r) to be set by peer r (1 -> 0);
//   3. each thread merges a row's world * k candidates, read from the
//      peers' buffers, into the k smallest by (distance, index): the
//      order of the plain version's two stable sorts;
//   4. a second barrier on channel b, so that no rank overwrites its
//      buffer (the next call) while a peer still reads it.
// Blocks wait only on the same block of other ranks, never on each other,
// so the kernel cannot deadlock on one card however its blocks are
// scheduled; a wait that lasts ~20 s traps (a lost rank faults the
// launch rather than hanging the card).
//
// Bound: the bytes, each rank's rows * k * 8 written once and read by
// every rank (world * rows * k * 8 over NVLink a rank), and the barriers'
// round trips; it is latency-bound at the main path's sizes (2,048
// queries x 5: 80 KB a rank).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;
constexpr int kMaxWorld = 8;

// ~20 s of spinning at the card's clock: a rank lost for that long
constexpr long long kTimeoutCycles = 40000000000ll;

// Swap `addr` from `from` to `to` (system scope), spinning until it holds
// `from`.
__device__ __forceinline__ void swap_when(uint32_t* addr, uint32_t from, uint32_t to) {
  const long long start = clock64();
  while (atomicCAS_system(addr, from, to) != from) {
    if (clock64() - start > kTimeoutCycles) __trap();
  }
}

// A barrier of block `channel` across the ranks (the file comment, 2.).
__device__ void barrier(uint32_t* const* pads, int rank, int world, int channel) {
  __syncthreads();
  if (threadIdx.x < world) {
    __threadfence_system();
    swap_when(pads[threadIdx.x] + channel * world + rank, 0u, 1u);  // signal peer
    swap_when(pads[rank] + channel * world + threadIdx.x, 1u, 0u);  // wait for it
    __threadfence_system();
  }
  __syncthreads();
}

// (d, i) before (e, j): by distance, then by index.
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (!(e < d) && i < j);
}

__global__ void __launch_bounds__(kThreads)
peer_gather_kernel(const float* __restrict__ d_local, const int* __restrict__ i_local,
                   int rows, int k, int chunk, void* const* buffers, uint32_t* const* pads,
                   int rank, int world, float* __restrict__ d_out, int* __restrict__ i_out,
                   unsigned long long* runs) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && runs != nullptr) atomicAdd(runs, 1ull);
  const int lo = blockIdx.x * chunk;
  const int hi = min(rows, lo + chunk);
  const long long n = static_cast<long long>(rows) * k;
  float* own_d = static_cast<float*>(buffers[rank]);
  int* own_i = reinterpret_cast<int*>(own_d + n);
  for (long long e = static_cast<long long>(lo) * k + threadIdx.x;
       e < static_cast<long long>(hi) * k; e += kThreads) {
    own_d[e] = d_local[e];
    own_i[e] = i_local[e];
  }
  barrier(pads, rank, world, blockIdx.x);

  for (int row = lo + threadIdx.x; row < hi; row += kThreads) {
    float best_d[kMaxK];
    int best_i[kMaxK];
    int have = 0;
    for (int r = 0; r < world; ++r) {
      const float* pd = static_cast<const float*>(buffers[r]);
      const int* pi = reinterpret_cast<const int*>(pd + n);
      for (int c = 0; c < k; ++c) {
        const long long e = static_cast<long long>(row) * k + c;
        const float d = __ldcv(pd + e);
        const int i = __ldcv(pi + e);
        if (have == k && !before(d, i, best_d[k - 1], best_i[k - 1])) continue;
        int pos = have < k ? have++ : k - 1;
        while (pos > 0 && before(d, i, best_d[pos - 1], best_i[pos - 1])) {
          best_d[pos] = best_d[pos - 1];
          best_i[pos] = best_i[pos - 1];
          --pos;
        }
        best_d[pos] = d;
        best_i[pos] = i;
      }
    }
    for (int c = 0; c < k; ++c) {
      d_out[static_cast<long long>(row) * k + c] = best_d[c];
      i_out[static_cast<long long>(row) * k + c] = best_i[c];
    }
  }
  barrier(pads, rank, world, blockIdx.x);
}

}  // namespace

extern "C" {

// d_local (rows, k) float32 and i_local (rows, k) int32 on the card, this
// rank's candidates; buffers and pads device arrays of `world` pointers
// (every rank's symmetric buffer, of at least rows * k * 8 bytes, and
// signal pad, of at least max_blocks * world uint32 slots, zero between
// calls); writes the merged (rows, k) d_out / i_out.  Every rank must make
// the same calls in the same order.  Returns a CUDA error code, 0 on a
// launch accepted.
int peer_gather_launch(const float* d_local, const int* i_local, int rows, int k,
                       void* const* buffers, uint32_t* const* pads, int rank, int world,
                       int max_blocks, float* d_out, int* i_out, unsigned long long* runs,
                       void* stream) {
  if (rows <= 0 || k <= 0 || k > kMaxK || world <= 0 || world > kMaxWorld || rank < 0 ||
      rank >= world || max_blocks <= 0)
    return cudaErrorInvalidValue;
  int blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  const int chunk = (rows + blocks - 1) / blocks;
  blocks = (rows + chunk - 1) / chunk;
  peer_gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d_local, i_local, rows, k, chunk, buffers, pads, rank, world, d_out, i_out, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

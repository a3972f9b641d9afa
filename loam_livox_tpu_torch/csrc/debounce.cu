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
// Design: one block of pointer doubling in shared memory, the plain
// version's formulation (ops/debounce.py).  The candidates arrive in
// ascending index order, and the first candidate of each kind is always
// kept, so from a kept slot s the next kept slot is jump[s]: the first
// slot more than `gap` past it (a binary search over the sorted table),
// or the first valid slot of the other kind when that comes sooner and
// after s.  The kept slots are the chain of jump from slot 0: round r
// appends jump^(2^r) of the chain's first 2^r entries and squares the
// jump table, one barrier a round, ceil(log2 ns) rounds.  The kept
// indices are then ascending in slot order, so a block-wide exclusive
// scan places them in the table and the terminator goes in at its rank:
// no sort.  The tables are int32 (the wrapper checks n < 2^31) in shared
// memory: ~9 KB for the shipped 512 slots.  A table past one block's
// opt-in shared memory (~11,900 slots on the H100) takes the second
// launch form of the same kernel: the same block and rounds, its tables
// in a global-memory scratch that the wrapper allocates (a barrier
// orders a block's global accesses as it does its shared ones), so both
// forms compute the same bits.
//
// Bound: neither bytes (~9 KB in and out) nor operations (~40 a slot)
// bound it on this card (nanoseconds at the memory and float32 rates).
// One block on one SM runs ~20 dependent barrier-separated steps (the 9
// doubling rounds, a 9-step search, 5 block reductions or scans), so its
// time is that chain's latency over the floor of a kernel node in a
// CUDA graph (chip_smoke.py's `node_floor`, PERF.md §6).

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// entries of the pointer-doubling chain: the least power of two >= ns
__host__ __device__ inline int chain_length(int ns) {
  int p = 1;
  while (p < ns) p <<= 1;
  return p;
}

// the tables of an ns-slot table: the indices (ns), two jump tables
// (ns + 1, the sink ns included), the chain, then the kinds and the chain
// marks (ns + 1 bytes each)
__host__ __device__ inline size_t table_bytes(int ns) {
  const size_t s = static_cast<size_t>(ns);
  return sizeof(int) * (s + 2 * (s + 1) + chain_length(ns)) + 2 * (s + 1);
}

// the threads of the one block: a warp for every 32 slots, at most 1,024
int block_threads(int ns) { return std::min(((ns + 31) / 32) * 32, kMaxThreads); }

// the block's threads are a whole number of warps
__device__ int block_min(int v, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_down_sync(kFull, v, o));
  __syncthreads();  // the scratch's earlier readers are done
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = scratch[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) m = min(m, scratch[w]);
  return m;
}

__device__ int block_sum(int v, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += scratch[w];
  return t;
}

// the sum of v over the threads before this one; *total the block's sum
__device__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int s = scratch[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + x - v;
}

// kGlobal false: the tables in dynamic shared memory (table_bytes(ns));
// true: in `tables`, a global scratch of table_bytes(ns) bytes
template <bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads)
    debounce_kernel(const long long* __restrict__ cand_idx,
                    const bool* __restrict__ cand_is_edge, int ns, long long n,
                    const long long* __restrict__ n_valid, long long gap,
                    long long* __restrict__ splits, long long* __restrict__ n_accepted,
                    unsigned long long* __restrict__ runs, int* tables) {
  extern __shared__ int smem[];
  __shared__ int scratch[32];
  int* idx = kGlobal ? tables : smem;
  int* cur = idx + ns;        // jump^(2^r), slot ns the sink
  int* nxt = cur + ns + 1;
  int* chain = nxt + ns + 1;  // chain[m] = jump^m(0)
  const int len_chain = chain_length(ns);
  unsigned char* kind = reinterpret_cast<unsigned char*>(chain + len_chain);
  unsigned char* on_chain = kind + ns + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nn = static_cast<int>(n);
  if (tid == 0 && runs != nullptr) atomicAdd(runs, 1ull);  // the run counter

  // 1. the indices (padding and anything past it as n) and kinds
  for (int s = tid; s < ns; s += nt) {
    const long long c = cand_idx[s];
    idx[s] = c < n ? static_cast<int>(c) : nn;
    kind[s] = cand_is_edge[s] ? 1 : 0;
  }
  for (int s = tid; s <= ns; s += nt) on_chain[s] = 0;
  __syncthreads();

  // 2. the first valid slot whose kind differs from slot 0's (ns if none);
  // a thread's slots ascend, so its first hit is its least
  const unsigned char kind0 = kind[0];
  int first = ns;
  for (int s = tid; s < ns; s += nt) {
    if (idx[s] < nn && kind[s] != kind0) {
      first = s;
      break;
    }
  }
  const int f_other = block_min(first, scratch);

  // 3-4. far[s]: the first slot whose index exceeds idx[s] + gap; the jump
  for (int s = tid; s < ns; s += nt) {
    const long long v = static_cast<long long>(idx[s]) + gap;
    int lo = 0, hi = ns;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<long long>(idx[mid]) > v) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    cur[s] = s < f_other ? min(lo, f_other) : lo;
  }
  if (tid == 0) {
    cur[ns] = ns;
    chain[0] = 0;
  }
  __syncthreads();

  // 5. the chain from slot 0 by pointer doubling: after the round of
  // length len the chain holds jump^m(0) for m < 2 len
  for (int len = 1; len < ns; len <<= 1) {
    for (int m = tid; m < len; m += nt) chain[len + m] = cur[chain[m]];
    if (2 * len < ns) {
      for (int s = tid; s <= ns; s += nt) nxt[s] = cur[cur[s]];
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int m = tid; m < len_chain; m += nt) on_chain[chain[m]] = 1;
  __syncthreads();

  // 6. kept = on the chain and valid; each thread owns a contiguous run of
  // slots, so the exclusive scan of its count is its first kept's rank
  const int per = (ns + nt - 1) / nt;
  const int lo = min(tid * per, ns), hi = min(lo + per, ns);
  const long long term = *n_valid - 1;
  int mine = 0, below = 0;
  for (int s = lo; s < hi; ++s) {
    if (on_chain[s] && idx[s] < nn) {
      ++mine;
      below += static_cast<long long>(idx[s]) < term ? 1 : 0;
    }
  }
  int kept;
  int rank = block_exclusive_scan(mine, scratch, &kept);
  // the kept indices below the terminator: its rank among them
  const int c = block_sum(below, scratch);

  // 7. the table in shared memory (the jump tables are free now): padding
  // n, the kept indices at their ranks, shifted past the terminator
  int* table = cur;
  for (int s = tid; s < ns; s += nt) table[s] = nn;
  __syncthreads();
  const bool has_term = kept < ns;
  for (int s = lo; s < hi; ++s) {
    if (on_chain[s] && idx[s] < nn) {
      table[rank + ((has_term && rank >= c) ? 1 : 0)] = idx[s];
      ++rank;
    }
  }
  __syncthreads();
  // the terminator sorts after the padding when it exceeds n
  const int term_at = has_term ? (term > n ? ns - 1 : c) : -1;
  for (int s = tid; s < ns; s += nt) {
    splits[s] = s == term_at ? term : static_cast<long long>(table[s]);
  }
  if (tid == 0) *n_accepted = kept;
}

}  // namespace

extern "C" {

// The bytes of an ns-slot table's tables (0 for ns <= 0): the dynamic
// shared memory of the shared form, the global scratch of the other.
long long debounce_table_bytes(int ns) {
  return ns > 0 ? static_cast<long long>(table_bytes(ns)) : 0;
}

// out[0] = one block's opt-in shared memory on `device`, out[1] = the
// kernel's static shared memory: the shared form fits where
// out[1] + debounce_table_bytes(ns) <= out[0].  Returns a CUDA error code.
int debounce_shared_limits(int device, long long* out) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, debounce_kernel<false>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = optin;
  out[1] = static_cast<long long>(attr.sharedSizeBytes);
  return 0;
}

// cand_idx (ns,) int64 ascending, padded with n (0 <= n < 2^31), and
// cand_is_edge (ns,) bool on the card, n_valid a device int64 scalar;
// writes splits (ns,) int64 and n_accepted (an int64 scalar); `runs` (a
// device counter, or null) gains one each time the launch runs, in a CUDA
// graph at every replay.  `tables` null launches the shared form; else it
// is a device scratch of debounce_table_bytes(ns) bytes, 4-byte aligned,
// that the global form keeps its tables in.  Returns a CUDA error code, 0
// on a launch accepted; a shared form past the card's opt-in shared
// memory for one block returns the error of raising the kernel's limit.
int debounce_launch(const long long* cand_idx, const bool* cand_is_edge, int ns, long long n,
                    const long long* n_valid, long long gap, long long* splits,
                    long long* n_accepted, unsigned long long* runs, int* tables,
                    void* stream) {
  if (ns <= 0 || n < 0 || n > INT_MAX) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables != nullptr) {
    debounce_kernel<true><<<1, block_threads(ns), 0, s>>>(
        cand_idx, cand_is_edge, ns, n, n_valid, gap, splits, n_accepted, runs, tables);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = table_bytes(ns);
  if (bytes > INT_MAX) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        debounce_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check
      return static_cast<int>(e);
    }
  }
  debounce_kernel<false><<<1, block_threads(ns), bytes, s>>>(
      cand_idx, cand_is_edge, ns, n, n_valid, gap, splits, n_accepted, runs, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

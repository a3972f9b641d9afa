// JAX's default PRNG on the card: threefry-2x32 in its partitionable form
// (jax/_src/prng.py, _threefry2x32_lowering and _threefry_split_foldlike;
// jax/_src/random.py, _uniform), so that the port's residual subsampling
// draws the numbers the JAX package draws from the same key.  No Pallas
// kernel stood here: the JAX package's draws are XLA's threefry and
// elementwise ops (loam_livox_tpu/registration/icp.py:235-237,
// loam_livox_tpu/ops/masked.py:73-84), and no PyTorch call computes them
// (torch.rand is another generator).  Two kernels, each one launch, each
// bit-equal to its plain version in ops/threefry.py:
//
// * threefry_split_kernel: jax.random.split(key, num) of n_keys keys, one
//   thread an output key: the block of the key over the counter (0, i).
// * threefry_keep_mask_kernel: random_keep_mask(key, mask, budget) of
//   n_lanes lanes, one block a lane: the block counts the lane's valid
//   entries (a warp-shuffle then shared-memory reduction), every thread
//   computes keep_prob = min(1, budget / max(count, 1)) as one IEEE
//   float32 division (nvcc's default -prec-div=true, as XLA divides), and
//   each entry j draws the block of the lane's key over the counter
//   (0, j), takes the top 23 bits of the two words' XOR as the mantissa
//   of 1.0, subtracts 1, and keeps the entry where it is valid and the
//   uniform lies below keep_prob.
//
// Bound: a keep mask of the main path's N ~ 10,000 entries a lane reads N
// bytes and writes N; its ~130 integer operations an entry (20 rounds of
// add, rotate, xor, and the key injections) are ~1.3 M operations, ~0.02
// us at the card's 67 T 32-bit operations a second, as are the bytes: the
// kernel is latency-bound (one block a lane, a reduction then a pass), as
// a kernel node in a CUDA graph is (chip_smoke.py's `node_floor`).  A split
// is a handful of threads.  Each run adds one to `runs` (a device counter,
// or null), so graph replays count.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kOneBits = 0x3F800000u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The 20-round threefry-2x32 block of key (k0, k1) over counter (x0, x1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__global__ void threefry_split_kernel(const uint32_t* __restrict__ keys, int n_keys, int num,
                                      uint32_t* __restrict__ out,
                                      unsigned long long* runs) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t == 0 && runs != nullptr) atomicAdd(runs, 1ull);
  if (t >= static_cast<long long>(n_keys) * num) return;
  const int key = static_cast<int>(t / num);
  uint32_t x0 = 0, x1 = static_cast<uint32_t>(t % num);
  threefry2x32(keys[2 * key], keys[2 * key + 1], x0, x1);
  out[2 * t] = x0;
  out[2 * t + 1] = x1;
}

__global__ void __launch_bounds__(kThreads)
threefry_keep_mask_kernel(const uint32_t* __restrict__ keys, const bool* __restrict__ mask,
                          int n, int budget, bool* __restrict__ out,
                          unsigned long long* runs) {
  __shared__ int warp_counts[kThreads / 32];
  const int lane = blockIdx.y;
  const bool* m = mask + static_cast<long long>(lane) * n;
  bool* o = out + static_cast<long long>(lane) * n;
  if (lane == 0 && threadIdx.x == 0 && runs != nullptr) atomicAdd(runs, 1ull);

  int count = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) count += m[j] ? 1 : 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) count += __shfl_xor_sync(0xffffffffu, count, s);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
  __syncthreads();
  count = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) count += warp_counts[w];

  const float keep_prob = fminf(1.0f, static_cast<float>(budget) /
                                          fmaxf(static_cast<float>(count), 1.0f));
  const uint32_t k0 = keys[2 * lane], k1 = keys[2 * lane + 1];
  for (int j = threadIdx.x; j < n; j += kThreads) {
    uint32_t x0 = 0, x1 = static_cast<uint32_t>(j);
    threefry2x32(k0, k1, x0, x1);
    const float u = fmaxf(__uint_as_float(((x0 ^ x1) >> 9) | kOneBits) - 1.0f, 0.0f);
    o[j] = m[j] && (u < keep_prob);
  }
}

}  // namespace

extern "C" {

// keys (n_keys, 2) uint32 on the card -> out (n_keys, num, 2) uint32: each
// key's jax.random.split(key, num).  Returns a CUDA error code, 0 on a
// launch accepted.
int threefry_split_launch(const uint32_t* keys, int n_keys, int num, uint32_t* out,
                          unsigned long long* runs, void* stream) {
  const long long total = static_cast<long long>(n_keys) * num;
  if (n_keys <= 0 || num <= 0 || total >= (1ll << 31)) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  threefry_split_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, n_keys, num, out, runs);
  return static_cast<int>(cudaGetLastError());
}

// keys (n_lanes, 2) uint32 and mask (n_lanes, n) bool on the card -> out
// (n_lanes, n) bool: each lane's mask thinned to about `budget` entries
// with its key's uniforms (the file comment).  Returns a CUDA error code.
int threefry_keep_mask_launch(const uint32_t* keys, const bool* mask, int n_lanes, int n,
                              int budget, bool* out, unsigned long long* runs, void* stream) {
  if (n_lanes <= 0 || n_lanes > 65535 || n <= 0 || budget < 0) return cudaErrorInvalidValue;
  threefry_keep_mask_kernel<<<dim3(1, n_lanes), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(keys, mask, n, budget, out,
                                                                   runs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

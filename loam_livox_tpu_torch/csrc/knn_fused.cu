// Exact k-nearest-neighbour search of masked reference points, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `knn_fused` of loam_livox_tpu/ops/pallas/
// knn_fused.py (`_kernel`, launched by `knn_fused` through its
// `pl.pallas_call`).  The TPU kernel folds ||r||^2 - 2<q, r> into a
// running min over 256 index-mod-256 bins, which loses a neighbour when
// two of the k nearest share a bin.  Here every thread keeps an exact
// sorted top-k of its query in registers, so the selection is exact.
//
// Work split.  blockIdx.x runs over 128-query tiles (one thread per
// query), blockIdx.y over 2048-reference chunks, so even the corner
// search (512 queries) launches 4 x 8 blocks and the surface search
// (2048 x 65536) 16 x 32.  Each block writes its per-chunk top-k to
// part_d/part_i at [chunk][slot][query]; the merge over chunks is a
// sort in PyTorch (loam_livox_tpu_torch/ops/knn_fused.py).
//
// Skipping, as on the TPU.  A block whose chunk starts at or past the
// last valid reference (counts[0]) or whose tile starts at or past the
// query count (counts[1]) writes BIG and exits; both counts are read
// from device memory, so the host never waits for them.  Inside a
// block, a 256-reference group whose bounding box lies farther than the
// radius from the tile's query box is skipped.  The box distance uses
// the same rounded operations as the point distance, so it is never
// larger than the distance of any point in the box: every reference
// within the radius is visited, and the selection within the radius is
// exact.
//
// Distances are (dx*dx + dy*dy) + dz*dz with every operation rounded on
// its own (__fmul_rn/__fadd_rn: no FMA contraction), which is what the
// plain PyTorch version computes, so the two agree bit for bit.  Ties go
// to the lower reference index: each thread scans its references in
// index order and inserts with a lexicographic (distance, index) test.
//
// Bound.  Each (query, reference) pair costs 3 subtractions, 3
// multiplications and 2 additions: 8 FP32 operations.  The full surface
// search, 2048 x 65536 pairs, is 1.07 GFLOP: about 16 us at the card's
// 67 TFLOP/s FP32 peak, while its 1 MB of references moves in 0.3 us at
// 3.35 TB/s.  So the kernel is bound by operations, and the prefix and
// group skipping cut the operations in proportion to the buffer's fill.
// Group staging is plain shared-memory loads; TMA staging and a
// persistent grid are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileQ = 128;   // queries per block, one per thread
constexpr int kGroup = 256;   // references per bounding box
constexpr int kChunk = 2048;  // references per block
constexpr float kBig = 1e30f;

template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K],
                                       float d, int i) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool lt = (d < bd[s]) || (d == bd[s] && i < bi[s]);
    if (lt) {
      const float td = bd[s];
      const int ti = bi[s];
      bd[s] = d;
      bi[s] = i;
      d = td;
      i = ti;
    }
  }
}

__device__ __forceinline__ float sq3(float ax, float ay, float az) {
  float d = __fmul_rn(ax, ax);
  d = __fadd_rn(d, __fmul_rn(ay, ay));
  return __fadd_rn(d, __fmul_rn(az, az));
}

template <int K>
__global__ void __launch_bounds__(kTileQ)
knn_fused_kernel(const float* __restrict__ query, int n_rows,
                 const float4* __restrict__ ref4,
                 const float4* __restrict__ boxes,
                 const int* __restrict__ counts, float radius2,
                 float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 tile[kGroup];
  __shared__ float warp_box[6][kTileQ / 32];
  __shared__ float qbox[6];

  const int tid = threadIdx.x;
  const int qi = blockIdx.x * kTileQ + tid;
  const int chunk = blockIdx.y;
  const int n_ref = counts[0];
  const int n_q = min(counts[1], n_rows);
  const int chunk_start = chunk * kChunk;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = 0;
  }

  // Block-uniform: every thread takes the same branch.
  if (blockIdx.x * kTileQ < n_q && chunk_start < n_ref) {
    const bool q_ok = qi < n_q;
    float q[3] = {0.f, 0.f, 0.f};
    if (q_ok) {
      q[0] = query[3 * qi];
      q[1] = query[3 * qi + 1];
      q[2] = query[3 * qi + 2];
    }
    // The tile's query box: warp shuffles, then one thread per value.
    float b[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c] = q_ok ? q[c] : CUDART_INF_F;
      b[3 + c] = q_ok ? q[c] : -CUDART_INF_F;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        b[c] = fminf(b[c], __shfl_xor_sync(0xffffffffu, b[c], off));
        b[3 + c] = fmaxf(b[3 + c], __shfl_xor_sync(0xffffffffu, b[3 + c], off));
      }
    }
    if ((tid & 31) == 0) {
#pragma unroll
      for (int c = 0; c < 6; ++c) warp_box[c][tid >> 5] = b[c];
    }
    __syncthreads();
    if (tid < 6) {
      float v = warp_box[tid][0];
      for (int w = 1; w < kTileQ / 32; ++w)
        v = tid < 3 ? fminf(v, warp_box[tid][w]) : fmaxf(v, warp_box[tid][w]);
      qbox[tid] = v;
    }
    __syncthreads();

    const int g0 = chunk_start / kGroup;
    for (int g = g0; g < g0 + kChunk / kGroup && g * kGroup < n_ref; ++g) {
      const float4 lo = boxes[2 * g];
      const float4 hi = boxes[2 * g + 1];
      if (lo.x > hi.x) continue;  // no valid reference in the group
      const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, qbox[3]), __fsub_rn(qbox[0], hi.x)), 0.f);
      const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, qbox[4]), __fsub_rn(qbox[1], hi.y)), 0.f);
      const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, qbox[5]), __fsub_rn(qbox[2], hi.z)), 0.f);
      if (sq3(gx, gy, gz) > radius2) continue;

      __syncthreads();  // the previous group is consumed
      tile[tid] = ref4[g * kGroup + tid];
      tile[tid + kTileQ] = ref4[g * kGroup + kTileQ + tid];
      __syncthreads();
      if (q_ok) {
        for (int j = 0; j < kGroup; ++j) {
          const float4 r = tile[j];
          if (r.w >= 0.5f * kBig) continue;  // masked out
          const float d = sq3(__fsub_rn(q[0], r.x), __fsub_rn(q[1], r.y),
                              __fsub_rn(q[2], r.z));
          if (d < bd[K - 1]) insert<K>(bd, bi, d, g * kGroup + j);
        }
      }
    }
  }

  if (qi < n_rows) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const size_t o = (static_cast<size_t>(chunk) * K + s) * n_rows + qi;
      part_d[o] = bd[s];
      part_i[o] = bi[s];
    }
  }
}

template <int K>
void launch(const float* query, int n_rows, const float* ref4,
            const float* boxes, int mp, const int* counts, float radius2,
            float* part_d, int* part_i, cudaStream_t stream) {
  const dim3 grid((n_rows + kTileQ - 1) / kTileQ, mp / kChunk);
  knn_fused_kernel<K><<<grid, kTileQ, 0, stream>>>(
      query, n_rows, reinterpret_cast<const float4*>(ref4),
      reinterpret_cast<const float4*>(boxes), counts, radius2, part_d,
      part_i);
}

}  // namespace

extern "C" {

int knn_fused_chunk() { return kChunk; }
int knn_fused_group() { return kGroup; }

// query (n_rows, 3), ref4 (mp, 4) rows (x, y, z, ||r||^2 + mask penalty),
// boxes (mp / 256, 8) rows (lo_xyz, _, hi_xyz, _), counts [n_ref, n_q]
// on the device, part_d/part_i (mp / 2048, k, n_rows).  mp is a
// multiple of 2048 and 1 <= k <= 8.  Returns cudaGetLastError().
int knn_fused_launch(const float* query, int n_rows, const float* ref4,
                     const float* boxes, int mp, const int* counts,
                     float radius2, int k, float* part_d, int* part_i,
                     void* stream) {
  if (n_rows <= 0 || mp <= 0 || mp % kChunk != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(query, n_rows, ref4, boxes, mp, counts, radius2, part_d, part_i, s); break;
    case 2: launch<2>(query, n_rows, ref4, boxes, mp, counts, radius2, part_d, part_i, s); break;
    case 3: launch<3>(query, n_rows, ref4, boxes, mp, counts, radius2, part_d, part_i, s); break;
    case 4: launch<4>(query, n_rows, ref4, boxes, mp, counts, radius2, part_d, part_i, s); break;
    case 5: launch<5>(query, n_rows, ref4, boxes, mp, counts, radius2, part_d, part_i, s); break;
    case 6: launch<6>(query, n_rows, ref4, boxes, mp, counts, radius2, part_d, part_i, s); break;
    case 7: launch<7>(query, n_rows, ref4, boxes, mp, counts, radius2, part_d, part_i, s); break;
    case 8: launch<8>(query, n_rows, ref4, boxes, mp, counts, radius2, part_d, part_i, s); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

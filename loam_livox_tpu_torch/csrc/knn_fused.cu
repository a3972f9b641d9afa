// Exact k-nearest-neighbour search of masked reference points, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `knn_fused` of loam_livox_tpu/ops/pallas/
// knn_fused.py (`_kernel`, launched by `knn_fused` through its
// `pl.pallas_call`).  The TPU kernel folds ||r||^2 - 2<q, r> into a
// running min over 256 index-mod-256 bins, which loses a neighbour when
// two of the k nearest share a bin.  Here every list is an exact top-k,
// and the kernel writes the final (Q, k) lists itself: one launch, no
// merge outside it.
//
// Work split, read from the device.  The host sizes the grid from the
// capacities alone: one cluster of kCluster = 8 blocks per 32-query
// tile.  Every block reads n_ref and n_q from device memory, so the host
// never waits for them.  A cluster whose tile starts at or past n_q
// writes BIG rows and exits.  Otherwise each of its blocks runs the same
// box test, one thread per 256-reference group up to n_ref, and compacts
// the groups within the radius of the tile's query box into a list in
// shared memory (ballot and prefix sums).  Block b takes list entries
// b + 8 m, visiting m = (i * stride) mod count with the stride coprime to
// the count: spread over the voxel-sorted buffer rather than swept along
// it, since a sweep towards a query would improve its lists at every
// step.  The main path's 193 x 1,056 search keeps 5 blocks of each of 7
// clusters busy.
//
// Query sets.  The grid's y axis holds `lanes` query sets (the racing
// path registers several frames at once against one matching buffer,
// the counterpart of jax.vmap over the TPU kernel): grid row y reads its
// queries `lane_stride` rows after row y - 1's, its count from n_q[y],
// and writes its own (n_rows, k) block of the outputs.  Clusters stay
// within one set's tile, so nothing else changes; a set whose count is 0
// writes BIG rows like any tile past its count.
//
// Inside a block.  128 threads: 4 lanes (warps) of 32 threads, each
// thread one query in registers, lane l scanning references
// [64 l, 64 l + 64) of every staged group.  One thread keeps a ring of kRing groups in flight with 1-D
// bulk copies (cp.async.bulk, TMA) completing on mbarriers, so the next
// groups arrive while the current one is scanned.  A query whose
// distance to a group's box exceeds its bound t skips the group; a warp
// in which no query needs the group skips it.
//
// The bound t, shared.  Any list holding k references bounds the k
// nearest by its k-th distance, so the lanes of a block share the least
// such bound per query every 32-reference pass (shared-memory atomics),
// and the blocks of a cluster every group through the leader's copy
// (distributed shared memory).  A reference farther than t is never
// among the k nearest; one at exactly t may be (a tie) and is kept.
//
// Prefilter, exact.  Per pair the kernel first evaluates the TPU
// kernel's expanded form p = w - 2<q, r> (three FFMA on w = ref4.w =
// ||r||^2 + mask penalty), setting one bit of a 32-bit mask per
// reference without branches, and computes the exact distance d only
// where p <= thr(T), T the float after t, with
// thr(T) = (T - qq) + 2^-19 ((T + qq) + R2) (+ 2^-100), qq the query's
// rounded ||q||^2 and R2 the group's rounded bound on ||r||^2 from its
// box.  With u = 2^-24: |d - ||q-r||^2| <= 5.0001 u ||q-r||^2 for the
// rounded distance; |p - (||r||^2 - 2<q,r>)| <= 6.001 u (||q||^2 +
// 2||r||^2) for the FMA chain (w itself within 3 roundings of ||r||^2);
// |qq - ||q||^2| <= 3.0001 u ||q||^2.  So d < T implies
// p < T - qq + 13 u (T + qq + R2), while the rounded thr is at least
// T - qq + 29.8 u (T + qq + R2): no pair that could enter a list is
// filtered out, and the selection stays exact.  The margin grows with
// the coordinates' magnitude (about 1.5e-3 m^2 at 20 m from the
// origin); it costs only extra exact evaluations.  A pass's candidates
// are evaluated kBatch at a time, their distances side by side.  Tensor
// cores are not used: the contraction is 3 deep, and TF32 (or the TPU's
// bf16, whose selection recall the TPU kernel's note records collapsing
// to 0.46) loses the digits the selection rides on.
//
// Exactness.  Distances are (dx*dx + dy*dy) + dz*dz with every
// operation rounded on its own (__fmul_rn/__fadd_rn: no FMA
// contraction), which is what the plain PyTorch version computes, so the
// two agree bit for bit.  Every list and every merge orders (distance,
// index) lexicographically, so ties go to the lower reference index
// whatever the visiting order.
//
// Merge inside the kernel.  Each block merges its lanes' lists per query
// in shared memory and writes the result into the leader's shared memory
// (distributed shared memory).  After one cluster barrier the leader
// merges the busy blocks' lists, applies the radius / BIG convention and
// writes the (Q, k) outputs; the other blocks have left by then.  The
// first half of a cluster barrier is passed at the start, so the
// leader's shared memory is known to be live before any block touches
// it.  Every decision to skip a barrier depends only on the tile and the
// counts, so it is the same in every block of a cluster.
//
// Capacity ceiling.  The list of near groups lives in shared memory, 36
// bytes (box and index) per 256-reference group of the capacity, beside
// the ring and the merge buffers.  Within sm_90's 227 KB opt-in limit,
// less the kernel's static shared memory, an operand holds at most
// knn_fused_max_rows(k) rows: 1,461,504 at k = 5.  The wrapper refuses a
// larger one, and the registration's searcher splits a larger buffer
// into row blocks (registration/icp.py).  The shipped
// buffers (at most 65,536 rows) need 35,872 bytes at k = 5.
//
// Bound.  ops/knn_fused.py: search_work counts, whatever the tiling, 8
// FP32 operations per valid (query, reference) pair whose group's box
// lies within the radius of that query, and the bytes read and written
// once.  The kernel does more work than that: a tile's box spans its 32
// queries, so at random query order nearly every pair of the tile gets
// the prefilter, and each of a query's 32 lists (8 blocks x 4 lanes)
// fills with k entries before the shared bound tightens.  PERF.md holds
// the measured times beside the bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 256;                    // references per box and per staged group
constexpr int kTileQ = 32;                     // queries per cluster, one per thread of a lane
constexpr int kLanes = 4;                      // threads splitting one query's references
constexpr int kThreads = kLanes * kTileQ;      // 128
constexpr int kLaneRefs = kGroup / kLanes;     // references of a group per lane
constexpr int kCluster = 8;                    // blocks per cluster (portable maximum)
constexpr int kRing = 4;                       // staged groups in flight per block
constexpr int kStep = 32;                      // references per prefilter pass
constexpr int kBatch = 4;                      // candidates evaluated side by side
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;
constexpr int kEmpty = 0x7fffffff;             // index of an empty list entry (after all others)
constexpr int kSmemDefault = 48 * 1024;        // dynamic shared memory without opting in
constexpr int kSmemOptIn = 227 * 1024;         // sm_90's opt-in maximum per block

static_assert(kTileQ % 32 == 0, "a warp must hold one lane's threads");
static_assert(kLaneRefs % kStep == 0 && kStep <= 32, "a pass's candidates fill one mask");

template <int K>
struct Smem {
  // byte offsets of the regions; the ring and the lane lists share one
  static constexpr int kRingBytes = kRing * kGroup * 16;
  static constexpr int kLaneBytes = kLanes * K * kTileQ * 8;
  static constexpr int kUnion = kRingBytes > kLaneBytes ? kRingBytes : kLaneBytes;
  static constexpr int kGather = kUnion;                 // the blocks' lists, in the leader
  static constexpr int kBar = kGather + kCluster * K * kTileQ * 8;  // kRing mbarriers
  static constexpr int kList = kBar + kRing * 8;         // near groups' boxes, then indices
  static constexpr int kPerGroup = 36;                    // a box (32 B) and an index (4 B)
  static int bytes(int n_groups) { return kList + kPerGroup * n_groups; }
};

__device__ __forceinline__ float sq3(float ax, float ay, float az) {
  float d = __fmul_rn(ax, ax);
  d = __fadd_rn(d, __fmul_rn(ay, ay));
  return __fadd_rn(d, __fmul_rn(az, az));
}

// (d, i) < (bd, bi) lexicographically
__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Insert (d, i) into a list ascending in (distance, index).  Every
// comparison is with the old list, so they run side by side.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int i) {
  bool before[K];  // (d, i) goes before entry s: false ... false true ... true
#pragma unroll
  for (int s = 0; s < K; ++s) before[s] = lex_less(d, i, bd[s], bi[s]);
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (before[s]) {
      bd[s] = before[s - 1] ? bd[s - 1] : d;
      bi[s] = before[s - 1] ? bi[s - 1] : i;
    }
  }
  if (before[0]) {
    bd[0] = d;
    bi[0] = i;
  }
}

// The next float above a finite x >= 0.
__device__ __forceinline__ float next_up(float x) { return __int_as_float(__float_as_int(x) + 1); }

__device__ __forceinline__ int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// The prefilter's threshold on p = w - 2<q, r> for a query whose k-th
// distance is t (header note: no pair with d < t fails p <= thr).
__device__ __forceinline__ float prefilter_threshold(float t, float qq, float r2) {
  const float s = __fadd_rn(__fadd_rn(t, qq), r2);
  return __fadd_rn(__fsub_rn(t, qq), __fmaf_rn(s, 0x1p-19f, 0x1p-100f));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The cluster barrier in two halves, so that work runs between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One thread: copy group g of ref4 into a ring slot, completing on bar.
__device__ __forceinline__ void stage_group(float4* slot, uint64_t* bar, const float4* ref4,
                                            int g) {
  constexpr uint32_t bytes = kGroup * sizeof(float4);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(slot)),
      "l"(reinterpret_cast<uint64_t>(ref4 + static_cast<size_t>(g) * kGroup)), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
knn_fused_kernel(const float* __restrict__ query, int n_rows, long long lane_stride,
                 const float4* __restrict__ ref4, const float4* __restrict__ boxes,
                 int n_groups_cap, const int* __restrict__ n_ref_ptr,
                 const int* __restrict__ n_q_ptr, float radius2, float* __restrict__ out_d,
                 int* __restrict__ out_i, unsigned long long* __restrict__ runs) {
  extern __shared__ __align__(128) unsigned char smem[];
  float4* ring = reinterpret_cast<float4*>(smem);
  float* lane_d = reinterpret_cast<float*>(smem);  // [lane][s][t], after the scan
  int* lane_i = reinterpret_cast<int*>(lane_d + kLanes * K * kTileQ);
  float* gather_d = reinterpret_cast<float*>(smem + Smem<K>::kGather);  // [rank][s][t]
  int* gather_i = reinterpret_cast<int*>(gather_d + kCluster * K * kTileQ);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Smem<K>::kBar);
  float4* near_box = reinterpret_cast<float4*>(smem + Smem<K>::kList);  // (lo, ||r||^2 bound), hi
  int* near_g = reinterpret_cast<int*>(near_box + 2 * n_groups_cap);
  __shared__ float box_part[kTileQ / 32][6];
  __shared__ int warp_count[kWarps];
  // Per query, the least k-th distance a list has reached: the lanes of
  // a block share theirs every pass, the blocks theirs through the
  // leader's copy every group.  No reference farther than it is among
  // the k nearest, so every lane may reject one.
  __shared__ float shared_t[kTileQ];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int q0 = (blockIdx.x / kCluster) * kTileQ;
  // the run counter: one thread of the launch adds one
  if (runs != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) atomicAdd(runs, 1ull);
  // this grid row's query set
  query += static_cast<size_t>(blockIdx.y) * static_cast<size_t>(lane_stride) * 3;
  out_d += static_cast<size_t>(blockIdx.y) * n_rows * K;
  out_i += static_cast<size_t>(blockIdx.y) * n_rows * K;
  // Loads that depend on nothing, issued together: the counts, the first
  // groups' boxes and the tile's queries.
  const int n_ref_raw = *n_ref_ptr;
  const int n_q_raw = n_q_ptr[blockIdx.y];
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (tid < n_groups_cap) {
    lo = boxes[2 * tid];
    hi = boxes[2 * tid + 1];
  }
  float qv[3] = {0.f, 0.f, 0.f};
  if (tid < kTileQ && q0 + tid < n_rows) {
#pragma unroll
    for (int c = 0; c < 3; ++c) qv[c] = query[3 * (q0 + tid) + c];
  }
  const int n_ref = min(max(n_ref_raw, 0), n_groups_cap * kGroup);
  const int n_q = min(max(n_q_raw, 0), n_rows);
  const int live_q = min(max(n_q - q0, 0), kTileQ);
  const int tile_rows = min(n_rows - q0, kTileQ);
  if (tid < kTileQ) shared_t[tid] = fminf(radius2, kBig);  // the radius gate
  cluster_arrive();  // waited for before the first access to the leader

  // The tile's query box (the first kTileQ threads hold one query each).
  int n_near = 0;
  if (live_q > 0) {
    if (tid < kTileQ) {
      float b[6];
      const bool ok = tid < live_q;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        b[c] = ok ? qv[c] : CUDART_INF_F;
        b[3 + c] = ok ? qv[c] : -CUDART_INF_F;
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
        for (int c = 0; c < 6; ++c) box_part[tid >> 5][c] = b[c];
      }
    }
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kRing; ++s) mbar_init(&bar[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    float qb[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float v = box_part[0][c];
#pragma unroll
      for (int w = 1; w < kTileQ / 32; ++w)
        v = c < 3 ? fminf(v, box_part[w][c]) : fmaxf(v, box_part[w][c]);
      qb[c] = v;
    }

    // Compact the groups within the radius of the query box, in order.
    const int n_groups = (n_ref + kGroup - 1) / kGroup;
    for (int g0 = 0; g0 < n_groups; g0 += kThreads) {
      const int g = g0 + tid;
      if (g0 > 0 && g < n_groups) {  // the first groups' boxes are loaded
        lo = boxes[2 * g];
        hi = boxes[2 * g + 1];
      }
      bool near = false;
      float r2 = 0.f;
      if (g < n_groups && lo.x <= hi.x) {  // else no valid reference in the group
        const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, qb[3]), __fsub_rn(qb[0], hi.x)), 0.f);
        const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, qb[4]), __fsub_rn(qb[1], hi.y)), 0.f);
        const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, qb[5]), __fsub_rn(qb[2], hi.z)), 0.f);
        near = sq3(gx, gy, gz) <= radius2;
        r2 = sq3(fmaxf(fabsf(lo.x), fabsf(hi.x)), fmaxf(fabsf(lo.y), fabsf(hi.y)),
                 fmaxf(fabsf(lo.z), fabsf(hi.z)));
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, near);
      if ((tid & 31) == 0) warp_count[tid >> 5] = __popc(ballot);
      __syncthreads();
      int pos = n_near, total = n_near;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        pos += w < (tid >> 5) ? warp_count[w] : 0;
        total += warp_count[w];
      }
      if (near) {
        pos += __popc(ballot & ((1u << (tid & 31)) - 1u));
        near_g[pos] = g;
        near_box[2 * pos] = make_float4(lo.x, lo.y, lo.z, r2);
        near_box[2 * pos + 1] = hi;
      }
      __syncthreads();
      n_near = total;
    }
  }

  // Cluster-uniform: nothing to search, so the leader writes BIG rows.
  if (n_near == 0) {
    if (rank == 0) {
      for (int e = tid; e < tile_rows * K; e += kThreads) {
        out_d[static_cast<size_t>(q0) * K + e] = kBig;
        out_i[static_cast<size_t>(q0) * K + e] = 0;
      }
    }
    cluster_wait();
    return;
  }

  const int my_groups = rank < n_near ? (n_near - 1 - rank) / kCluster + 1 : 0;
  // The block visits its list entries rank + kCluster * ((it * stride) %
  // my_groups): spread over the buffer rather than swept in order, so
  // that a sweep towards a query does not improve its lists at every step.
  int stride = max(1, (my_groups * 5 + 7) / 13);
  while (gcd(stride, my_groups) != 1) ++stride;
  const int lane = tid / kTileQ;
  const int t = tid % kTileQ;  // the thread's query in the tile
  if (my_groups > 0 && tid == 0) {
    for (int s = 0; s < min(kRing, my_groups); ++s)
      stage_group(ring + s * kGroup, &bar[s], ref4,
                  near_g[rank + kCluster * ((s * stride) % my_groups)]);
  }
  cluster_wait();
  float* lead_t = cluster.map_shared_rank(shared_t, 0);

  if (my_groups > 0) {
    const bool ok = t < live_q;
    const float qx = ok ? query[3 * (q0 + t)] : 0.f;
    const float qy = ok ? query[3 * (q0 + t) + 1] : 0.f;
    const float qz = ok ? query[3 * (q0 + t) + 2] : 0.f;
    const float ax = -2.f * qx, ay = -2.f * qy, az = -2.f * qz;
    const float qq = sq3(qx, qy, qz);
    float bd[K];
    int bi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[s] = kBig;
      bi[s] = kEmpty;
    }

    for (int it = 0; it < my_groups; ++it) {
      const int e = rank + kCluster * ((it * stride) % my_groups);
      const int base = near_g[e] * kGroup + lane * kLaneRefs;
      const float4 glo = near_box[2 * e];
      const float4 ghi = near_box[2 * e + 1];
      const float4* grp = ring + (it % kRing) * kGroup + lane * kLaneRefs;
      if (rank != 0 && tid < live_q) {  // trade bounds with the leader
        const float mine = shared_t[tid];
        const float lead = lead_t[tid];
        if (lead < mine) atomicMin(reinterpret_cast<int*>(shared_t + tid), __float_as_int(lead));
        if (mine < lead) atomicMin(reinterpret_cast<int*>(lead_t + tid), __float_as_int(mine));
      }
      // The bound no accepted distance exceeds (the list's k-th and the
      // shared one), and the box test against it.
      float bound = fminf(bd[K - 1], shared_t[t]);
      const float gx = fmaxf(fmaxf(__fsub_rn(glo.x, qx), __fsub_rn(qx, ghi.x)), 0.f);
      const float gy = fmaxf(fmaxf(__fsub_rn(glo.y, qy), __fsub_rn(qy, ghi.y)), 0.f);
      const float gz = fmaxf(fmaxf(__fsub_rn(glo.z, qz), __fsub_rn(qz, ghi.z)), 0.f);
      const bool near = ok && sq3(gx, gy, gz) <= bound;
      mbar_wait(&bar[it % kRing], (it / kRing) & 1);
      if (__any_sync(0xffffffffu, near)) {
#pragma unroll 1
        for (int c = 0; c < kLaneRefs; c += kStep) {
          // the prefilter over kStep references, without branches
          const float ts = shared_t[t];
          bound = fminf(bound, ts);
          const float thr =
              near ? prefilter_threshold(next_up(bound), qq, glo.w) : -CUDART_INF_F;
          unsigned pass = 0u;
#pragma unroll
          for (int j = 0; j < kStep; ++j) {
            const float4 r = grp[c + j];
            const float p = __fmaf_rn(ax, r.x, __fmaf_rn(ay, r.y, __fmaf_rn(az, r.z, r.w)));
            if (p <= thr) pass |= 1u << j;
          }
          // the exact distance of each reference that passed, kBatch at a
          // time side by side
          while (pass) {
            int jb[kBatch];
            bool has[kBatch];
            float db[kBatch], wb[kBatch];
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
              has[b] = pass != 0u;
              jb[b] = has[b] ? c + __ffs(pass) - 1 : c;
              pass &= pass - 1u;
              const float4 r = grp[jb[b]];
              db[b] = sq3(__fsub_rn(qx, r.x), __fsub_rn(qy, r.y), __fsub_rn(qz, r.z));
              wb[b] = r.w;
            }
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
              if (has[b] && db[b] <= bound &&
                  lex_less(db[b], base + jb[b], bd[K - 1], bi[K - 1]) && wb[b] < 0.5f * kBig) {
                insert<K>(bd, bi, db[b], base + jb[b]);
                bound = fminf(bound, bd[K - 1]);
              }
            }
          }
          if (bd[K - 1] < ts)
            atomicMin(reinterpret_cast<int*>(shared_t + t), __float_as_int(bd[K - 1]));
        }
      }
      __syncthreads();  // the slot is consumed
      if (tid == 0 && it + kRing < my_groups)
        stage_group(ring + (it % kRing) * kGroup, &bar[it % kRing], ref4,
                    near_g[rank + kCluster * (((it + kRing) * stride) % my_groups)]);
    }

    // The lanes' lists into shared memory (over the drained ring); one
    // thread per query merges them and sends the block's list to the
    // leader.
#pragma unroll
    for (int s = 0; s < K; ++s) {
      lane_d[(lane * K + s) * kTileQ + t] = bd[s];
      lane_i[(lane * K + s) * kTileQ + t] = bi[s];
    }
    __syncthreads();
    if (tid < live_q) {
      float md[K];
      int mi[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        md[s] = lane_d[s * kTileQ + tid];
        mi[s] = lane_i[s * kTileQ + tid];
      }
      for (int l = 1; l < kLanes; ++l) {
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const float d = lane_d[(l * K + s) * kTileQ + tid];
          const int i = lane_i[(l * K + s) * kTileQ + tid];
          if (!lex_less(d, i, md[K - 1], mi[K - 1])) break;
          insert<K>(md, mi, d, i);
        }
      }
      float* to_d = cluster.map_shared_rank(gather_d, 0);
      int* to_i = cluster.map_shared_rank(gather_i, 0);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        to_d[(rank * K + s) * kTileQ + tid] = md[s];
        to_i[(rank * K + s) * kTileQ + tid] = mi[s];
      }
    }
  }

  cluster.sync();  // every busy block's list is in the leader
  if (rank == 0 && tid < tile_rows) {
    float md[K];
    int mi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      md[s] = kBig;
      mi[s] = 0;
    }
    if (tid < live_q) {
      const int n_busy = min(n_near, kCluster);
      for (int b = 0; b < n_busy; ++b) {
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const float d = gather_d[(b * K + s) * kTileQ + tid];
          const int i = gather_i[(b * K + s) * kTileQ + tid];
          if (!lex_less(d, i, md[K - 1], mi[K - 1])) break;
          insert<K>(md, mi, d, i);
        }
      }
    }
    const size_t row = static_cast<size_t>(q0 + tid) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool far = md[s] >= 0.5f * kBig || md[s] > radius2;
      out_d[row + s] = far ? kBig : md[s];
      out_i[row + s] = far ? 0 : mi[s];
    }
  }
}

// Allow the kernel smem bytes of dynamic shared memory.  Above the
// default 48 KB the opt-in limit is set on every call, so no call can
// find it lowered by another (each sets the limit it needs itself).
template <int K>
cudaError_t allow_smem(int smem) {
  if (smem > kSmemOptIn) return cudaErrorInvalidValue;
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(knn_fused_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int K>
int launch(const float* query, int n_rows, int lanes, long long lane_stride, const float* ref4,
           const float* boxes, int mp, const int* n_ref, const int* n_q, float radius2,
           float* out_d, int* out_i, unsigned long long* runs, cudaStream_t stream) {
  auto kernel = knn_fused_kernel<K>;
  const int n_groups = mp / kGroup;
  const int smem = Smem<K>::bytes(n_groups);
  cudaError_t e = allow_smem<K>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n_rows + kTileQ - 1) / kTileQ) * kCluster, lanes);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, query, n_rows, lane_stride,
                         reinterpret_cast<const float4*>(ref4),
                         reinterpret_cast<const float4*>(boxes), n_groups, n_ref, n_q, radius2,
                         out_d, out_i, runs);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int K>
int info(int mp, int* out) {
  auto kernel = knn_fused_kernel<K>;
  const int smem = Smem<K>::bytes(mp / kGroup);
  cudaError_t e = allow_smem<K>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0, clusters = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = kThreads;
  out[1] = kCluster;
  out[2] = smem;
  out[3] = blocks;
  out[4] = clusters;
  return 0;
}

// The kernel's static shared memory (256 bytes at k = 5) counts against
// the same opt-in limit as the dynamic: read once, at the first call (0
// rows where the card cannot say).
template <int K>
int max_rows() {
  static const int rows = [] {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, knn_fused_kernel<K>) != cudaSuccess) return 0;
    const int room = kSmemOptIn - static_cast<int>(attr.sharedSizeBytes) - Smem<K>::kList;
    return room / Smem<K>::kPerGroup * kGroup;
  }();
  return rows;
}

}  // namespace

extern "C" {

int knn_fused_group() { return kGroup; }

// The largest operand (rows, a multiple of 256) the k-kernel can take:
// its shared memory holds 36 bytes per 256-row group of the capacity.
int knn_fused_max_rows(int k) {
  switch (k) {
    case 1: return max_rows<1>();
    case 2: return max_rows<2>();
    case 3: return max_rows<3>();
    case 4: return max_rows<4>();
    case 5: return max_rows<5>();
    case 6: return max_rows<6>();
    case 7: return max_rows<7>();
    case 8: return max_rows<8>();
    default: return 0;
  }
}

// query: `lanes` sets of n_rows rows (x, y, z), set y starting
// y * lane_stride rows after set 0; ref4 (mp, 4) rows (x, y, z, ||r||^2 +
// mask penalty), 16-byte aligned, boxes (mp / 256, 8) rows (lo_xyz, _,
// hi_xyz, _), n_ref (one past the last valid reference) and n_q[lanes]
// (valid query rows of each set) on the device, out_d/out_i (lanes,
// n_rows, k).  mp is a multiple of 256 no larger than
// knn_fused_max_rows(k), 1 <= lanes <= 65535 (gridDim.y) and 1 <= k <= 8.
// `runs` (a device counter, or null) gains one each time the launch runs,
// in a CUDA graph at every replay.  Returns a CUDA error code, 0 on a
// launch that was accepted.
int knn_fused_launch(const float* query, int n_rows, int lanes, long long lane_stride,
                     const float* ref4, const float* boxes, int mp, const int* n_ref,
                     const int* n_q, float radius2, int k, float* out_d, int* out_i,
                     unsigned long long* runs, void* stream) {
  if (n_rows <= 0 || lanes <= 0 || lanes > 65535 || lane_stride < 0 || mp <= 0 ||
      mp % kGroup != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KNN_LAUNCH(K)                                                                          \
  case K:                                                                                      \
    return launch<K>(query, n_rows, lanes, lane_stride, ref4, boxes, mp, n_ref, n_q, radius2, \
                     out_d, out_i, runs, s)
  switch (k) {
    KNN_LAUNCH(1);
    KNN_LAUNCH(2);
    KNN_LAUNCH(3);
    KNN_LAUNCH(4);
    KNN_LAUNCH(5);
    KNN_LAUNCH(6);
    KNN_LAUNCH(7);
    KNN_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef KNN_LAUNCH
}

// The launch shape of the k-kernel for an mp-reference operand: out =
// [threads per block, cluster size, dynamic shared bytes, blocks per SM,
// clusters resident at once].  Returns a CUDA error code.
int knn_fused_info(int k, int mp, int* out) {
  switch (k) {
    case 1: return info<1>(mp, out);
    case 2: return info<2>(mp, out);
    case 3: return info<3>(mp, out);
    case 4: return info<4>(mp, out);
    case 5: return info<5>(mp, out);
    case 6: return info<6>(mp, out);
    case 7: return info<7>(mp, out);
    case 8: return info<8>(mp, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"

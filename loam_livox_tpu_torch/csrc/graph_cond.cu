// The frame program's loops and branches on the card: the condition
// kernels and the assembly of a raw frame's graph around CUDA graph WHILE
// and SWITCH nodes.  A WHILE node is the counterpart of the JAX package's
// `lax.while_loop` (loam_livox_tpu/registration/icp.py:324-331), whose
// predicate is `active && iterations < icp_maximum_iteration`; a SWITCH
// node of the `lax.cond` that picks the step's matching-buffer update
// (loam_livox_tpu/runtime/odometry.py:421-458: rebuild, append or keep).
// No Pallas kernel stood here: XLA compiled both into the one device
// program a frame.
//
// The graph of a frame (runtime/frame_program.py) is a chain of items:
// a segment (a child graph), a loop or a switch:
//
//   segment 0 -> cond -> WHILE { body 0 -> cond } -> segment 1
//     -> index -> SWITCH { rebuild | append } -> segment 2 -> ...
//
// Each segment and body is a graph PyTorch captured (a child graph node
// here); each `cond` is `loop_cond_kernel` and each `index`
// `switch_cond_kernel`, which set their node's conditional handle on the
// device.  A loop's condition is any(active) && loops < max over the
// loop's carry in device memory, set once before the loop (a WHILE node
// tests its condition before the first pass) and at the end of every
// pass; the lanes vote a warp at a time (__any_sync).  A switch's index
// is the first set flag of its row of B flags (the bodies' exclusive
// conditions, all written before the node), or B, which runs no body:
// one condition launch a step for the matching update.  SWITCH nodes
// need CUDA 12.8 (toolkit and driver); an older one fails the build or
// the graph's assembly, never falls back.
//
// Bound: each condition kernel reads a few bytes; its time is the floor
// of a kernel node inside the graph (its launch), which `empty_kernel`
// measures (chip_smoke.py's `node_floor`).
//
// Spans (utils/logging.py): `stamp_kernel` is one thread that reads the
// card's %globaltimer (ns), takes the next slot of a device ring with an
// atomicAdd on its cursor and writes (time, tag) there, the tag a span's
// id shifted left by one with the low bit set on its close.  Captured
// into a graph it stamps at every replay and never at capture; all frame
// work runs on one stream, so the ring holds the stamps in execution
// order.  The cursor counts every stamp: past the ring's capacity a
// stamp writes nothing, and the cursor tells how many were lost.  A frame
// graph may open and close a `unit` span as its first and last nodes.

#include <cuda_runtime.h>

#include <vector>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12080
#error "the frame graph's SWITCH node needs the CUDA 12.8 toolkit or later"
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int kMaxBodies = 32;  // a switch's flags are one warp's ballot

// one warp for every 32 lanes, at most a block of 1,024 threads
int loop_cond_threads(int n_lanes) {
  const int warps = (n_lanes + 31) / 32;
  return 32 * (warps < kMaxWarps ? warps : kMaxWarps);
}

__global__ void loop_cond_kernel(cudaGraphConditionalHandle handle, int set_handle,
                                 const bool* __restrict__ active, int n_lanes,
                                 const int* __restrict__ loops, int max_loops,
                                 int* __restrict__ out, unsigned long long* __restrict__ runs) {
  __shared__ unsigned int warp_any[kMaxWarps];
  bool mine = false;
  for (int i = threadIdx.x; i < n_lanes; i += blockDim.x) mine = mine || active[i];
  const unsigned int vote = __any_sync(kFull, mine);
  const int n_warps = blockDim.x >> 5;
  unsigned int any = vote;
  if (n_warps > 1) {
    if ((threadIdx.x & 31) == 0) warp_any[threadIdx.x >> 5] = vote;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < n_warps; ++w) any |= warp_any[w];
    }
  }
  if (threadIdx.x != 0) return;
  if (runs != nullptr) atomicAdd(runs, 1ull);  // the run counter
  const unsigned int v = (any && (loops == nullptr || *loops < max_loops)) ? 1u : 0u;
  if (out != nullptr) *out = static_cast<int>(v);
  if (set_handle) cudaGraphSetConditional(handle, v);
}

// one warp: the ballot of the n_flags flags, its lowest set bit the index
__global__ void switch_cond_kernel(cudaGraphConditionalHandle handle, int set_handle,
                                   const bool* __restrict__ flags, int n_flags,
                                   int* __restrict__ out, unsigned long long* __restrict__ runs) {
  const int lane = threadIdx.x;
  const unsigned int set = __ballot_sync(kFull, lane < n_flags && flags[lane]);
  if (lane != 0) return;
  if (runs != nullptr) atomicAdd(runs, 1ull);  // the run counter
  const unsigned int index = set != 0 ? static_cast<unsigned int>(__ffs(set) - 1)
                                      : static_cast<unsigned int>(n_flags);
  if (out != nullptr) *out = static_cast<int>(index);
  if (set_handle) cudaGraphSetConditional(handle, index);
}

__global__ void empty_kernel() {}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void stamp_kernel(long long* __restrict__ ring, unsigned long long* __restrict__ cursor,
                             long long capacity, long long tag) {
  const long long t = globaltimer();
  const unsigned long long slot = atomicAdd(cursor, 1ull);
  if (slot < static_cast<unsigned long long>(capacity)) {
    ring[2 * slot] = t;
    ring[2 * slot + 1] = tag;
  }
}

// n back-to-back readings of %globaltimer by one thread: their least
// nonzero step is the timer's resolution
__global__ void globaltimer_probe_kernel(long long* __restrict__ out, int n) {
  for (int i = 0; i < n; ++i) out[i] = globaltimer();
}

cudaError_t add_kernel_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                            void* func, int threads, void** args) {
  cudaKernelNodeParams p = {};
  p.func = func;
  p.gridDim = dim3(1);
  p.blockDim = dim3(threads);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, dep, dep ? 1 : 0, &p);
}

cudaError_t add_loop_cond_node(cudaGraphNode_t* node, cudaGraph_t graph,
                               const cudaGraphNode_t* dep, cudaGraphConditionalHandle handle,
                               const bool* active, int n_lanes, const int* loops,
                               int max_loops, unsigned long long* runs) {
  int set_handle = 1;
  int* out = nullptr;
  void* args[] = {&handle, &set_handle, &active, &n_lanes, &loops, &max_loops, &out, &runs};
  return add_kernel_node(node, graph, dep, reinterpret_cast<void*>(loop_cond_kernel),
                         loop_cond_threads(n_lanes), args);
}

cudaError_t add_switch_cond_node(cudaGraphNode_t* node, cudaGraph_t graph,
                                 const cudaGraphNode_t* dep, cudaGraphConditionalHandle handle,
                                 const bool* flags, int n_flags, unsigned long long* runs) {
  int set_handle = 1;
  int* out = nullptr;
  void* args[] = {&handle, &set_handle, &flags, &n_flags, &out, &runs};
  return add_kernel_node(node, graph, dep, reinterpret_cast<void*>(switch_cond_kernel), 32,
                         args);
}

cudaError_t add_stamp_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                           long long* ring, unsigned long long* cursor, long long capacity,
                           long long tag) {
  void* args[] = {&ring, &cursor, &capacity, &tag};
  return add_kernel_node(node, graph, dep, reinterpret_cast<void*>(stamp_kernel), 1, args);
}

// a conditional node of `type` with `size` bodies, returned in bodies[]
cudaError_t add_conditional_node(cudaGraphNode_t* node, cudaGraph_t graph,
                                 const cudaGraphNode_t* dep, cudaGraphConditionalHandle handle,
                                 cudaGraphConditionalNodeType type, int size,
                                 cudaGraph_t* bodies) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = type;
  p.conditional.size = static_cast<unsigned int>(size);
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(node, graph, dep, nullptr, dep ? 1 : 0, &p);
#else
  cudaError_t e = cudaGraphAddNode(node, graph, dep, dep ? 1 : 0, &p);
#endif
  if (e == cudaSuccess) {
    for (int b = 0; b < size; ++b) bodies[b] = p.conditional.phGraph_out[b];
  }
  return e;
}

}  // namespace

extern "C" {

// The loop condition alone, for the comparison with its plain version:
// writes any(active[0:n_lanes]) && *loops < max_loops to out[0] (without
// the pass count when loops is null); `runs` (a device counter, or null)
// gains one.  Returns a CUDA error code, 0 on a launch accepted.
int loop_cond_launch(const bool* active, int n_lanes, const int* loops, int max_loops, int* out,
                     unsigned long long* runs, void* stream) {
  if (n_lanes <= 0 || out == nullptr) return cudaErrorInvalidValue;
  loop_cond_kernel<<<1, loop_cond_threads(n_lanes), 0, static_cast<cudaStream_t>(stream)>>>(
      0, 0, active, n_lanes, loops, max_loops, out, runs);
  return static_cast<int>(cudaGetLastError());
}

// The switch index alone: writes the first set flag of flags[0:n_flags]
// (n_flags <= 32), or n_flags, to out[0]; `runs` gains one.
int switch_cond_launch(const bool* flags, int n_flags, int* out, unsigned long long* runs,
                       void* stream) {
  if (n_flags <= 0 || n_flags > kMaxBodies || out == nullptr) return cudaErrorInvalidValue;
  switch_cond_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(0, 0, flags, n_flags, out,
                                                                      runs);
  return static_cast<int>(cudaGetLastError());
}

// An empty one-thread kernel on `stream`: captured into a graph, the floor
// of a kernel node (chip_smoke.py's `node_floor`).
int empty_kernel_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// One span stamp on `stream` (the file comment): (globaltimer, tag) into
// ring[*cursor] when the slot is below `capacity`; the cursor gains one.
int stamp_launch(long long* ring, unsigned long long* cursor, long long capacity, long long tag,
                 void* stream) {
  if (ring == nullptr || cursor == nullptr || capacity <= 0) return cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ring, cursor, capacity, tag);
  return static_cast<int>(cudaGetLastError());
}

// n back-to-back globaltimer readings into out[0:n] on `stream`.
int globaltimer_probe_launch(long long* out, int n, void* stream) {
  if (out == nullptr || n <= 0) return cudaErrorInvalidValue;
  globaltimer_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out, n);
  return static_cast<int>(cudaGetLastError());
}

// The kernel nodes of `graph` (a captured piece; child graphs are not
// entered) into *out.
int graph_kernel_nodes(void* graph, int* out) {
  size_t n = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) e = cudaGraphGetNodes(g, nodes.data(), &n);
  int kernels = 0;
  for (size_t i = 0; i < n && e == cudaSuccess; ++i) {
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    if (e == cudaSuccess && type == cudaGraphNodeTypeKernel) ++kernels;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *out = kernels;
  return 0;
}

// Item kinds of frame_graph_build.
enum { kSegment = 0, kWhile = 1, kSwitch = 2 };

// Assemble and instantiate the graph of the file comment on `device`
// from n_items items in order.  Item i is kinds[i]: a segment, whose
// graphs[i] (a cudaGraph_t) is placed as a child graph; a loop, whose
// graphs[i] is the pass, flags[i] the carry's n_flags[i] `active` bools,
// loops[i] its int32 pass count and max_loops[i] the most passes; or a
// switch, whose graphs[i] points to n_flags[i] <= 32 body graphs, body b
// run when flags[i][b] is the first set of the n_flags[i] bools.  Body
// graphs are cloned (the caller keeps and frees its own).  Every loop
// condition placed adds one to `loop_runs`, every switch condition to
// `switch_runs` (device counters, or null), when it runs.  With a span
// `ring` (not null) the graph's first node stamps `open_tag` and its last
// `close_tag` into it (`stamp_launch`).  On success *graph_out and
// *exec_out hold the graph and its executable (free both with
// frame_graph_destroy) and *cond_nodes the condition kernels placed.  Returns a CUDA error code (a driver older
// than 12.8 cudaErrorInsufficientDriver); on an error nothing is left
// allocated.
int frame_graph_build(int device, int n_items, const int* kinds, void* const* graphs,
                      void* const* flags, const int* n_flags, void* const* loops,
                      const int* max_loops, unsigned long long* loop_runs,
                      unsigned long long* switch_runs, long long* ring,
                      unsigned long long* cursor, long long capacity, long long open_tag,
                      long long close_tag, void** graph_out, void** exec_out,
                      int* cond_nodes) {
  if (n_items <= 0) return cudaErrorInvalidValue;
  int driver = 0;
  cudaError_t e = cudaDriverGetVersion(&driver);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (driver < 12080) return cudaErrorInsufficientDriver;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t graph = nullptr;
  e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNode_t prev = nullptr, node;
  int placed = 0;
  if (ring != nullptr) {
    e = add_stamp_node(&node, graph, nullptr, ring, cursor, capacity, open_tag);
    prev = node;
  }
  for (int i = 0; i < n_items && e == cudaSuccess; ++i) {
    const cudaGraphNode_t* dep = prev ? &prev : nullptr;
    if (kinds[i] == kSegment) {
      e = cudaGraphAddChildGraphNode(&node, graph, dep, dep ? 1 : 0,
                                     static_cast<cudaGraph_t>(graphs[i]));
      prev = node;
      continue;
    }
    const bool loop = kinds[i] == kWhile;
    const int lanes = n_flags[i];
    if ((!loop && kinds[i] != kSwitch) || lanes <= 0 || (!loop && lanes > kMaxBodies)) {
      e = cudaErrorInvalidValue;
      break;
    }
    const bool* flag = static_cast<const bool*>(flags[i]);
    cudaGraphConditionalHandle handle;
    e = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
    if (e != cudaSuccess) break;
    e = loop ? add_loop_cond_node(&node, graph, dep, handle, flag, lanes,
                                  static_cast<const int*>(loops[i]), max_loops[i], loop_runs)
             : add_switch_cond_node(&node, graph, dep, handle, flag, lanes, switch_runs);
    if (e != cudaSuccess) break;
    ++placed;
    prev = node;
    const int size = loop ? 1 : lanes;
    cudaGraph_t bodies[kMaxBodies];
    e = add_conditional_node(&node, graph, &prev,
                             handle, loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeSwitch,
                             size, bodies);
    if (e != cudaSuccess) break;
    prev = node;
    cudaGraphNode_t pass, cond;
    if (!loop) {
      cudaGraph_t const* children = static_cast<cudaGraph_t const*>(graphs[i]);
      for (int b = 0; b < size && e == cudaSuccess; ++b) {
        e = cudaGraphAddChildGraphNode(&pass, bodies[b], nullptr, 0, children[b]);
      }
      continue;
    }
    e = cudaGraphAddChildGraphNode(&pass, bodies[0], nullptr, 0,
                                   static_cast<cudaGraph_t>(graphs[i]));
    if (e != cudaSuccess) break;
    e = add_loop_cond_node(&cond, bodies[0], &pass, handle, flag, lanes,
                           static_cast<const int*>(loops[i]), max_loops[i], loop_runs);
    if (e == cudaSuccess) ++placed;
  }
  if (e == cudaSuccess && ring != nullptr) {
    e = add_stamp_node(&node, graph, &prev, ring, cursor, capacity, close_tag);
  }
  cudaGraphExec_t exec = nullptr;
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, graph, 0);
  if (e != cudaSuccess) {
    cudaGraphDestroy(graph);
    return static_cast<int>(e);
  }
  *graph_out = graph;
  *exec_out = exec;
  *cond_nodes = placed;
  return 0;
}

// Launch an executable built by frame_graph_build on `stream`.
int frame_graph_launch(void* exec, void* stream) {
  cudaError_t e =
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

int frame_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec != nullptr) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    cudaError_t f = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = f;
  }
  return static_cast<int>(e);
}

// out[0] = cudaDriverGetVersion(), out[1] = cudaRuntimeGetVersion() of this library.
int graph_cond_versions(int* out) {
  cudaError_t e = cudaDriverGetVersion(&out[0]);
  if (e == cudaSuccess) e = cudaRuntimeGetVersion(&out[1]);
  return static_cast<int>(e);
}

}  // extern "C"

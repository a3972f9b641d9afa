// The frame program's loops and branches on the card: the ICP outer
// loop's condition kernel and the assembly of a raw frame's graph around
// CUDA graph WHILE and IF nodes, the WHILE nodes the counterpart of the JAX package's `lax.while_loop`
// (loam_livox_tpu/registration/icp.py:324-331), whose predicate is
// `active && iterations < icp_maximum_iteration`.  No Pallas kernel stood
// here: XLA compiled the loop into the one device program a frame.
//
// The graph of a frame (runtime/frame_program.py) is a chain of items:
// a segment (a child graph), a loop or a branch:
//
//   segment 0 -> cond -> WHILE { body 0 -> cond } -> segment 1
//     -> cond -> IF { rebuild } -> cond -> IF { append } -> segment 2 -> ...
//
// Each segment and body is a graph PyTorch captured (a child graph node
// here); each `cond` is `loop_cond_kernel`, which sets its node's
// conditional handle on the device.  A loop's condition is
// any(active) && loops < max over the loop's carry in device memory, set
// once before the loop (a WHILE node tests its condition before the
// first pass) and at the end of every pass.  A branch's condition is its
// one flag (no pass count), set once before it: the counterpart of the
// `lax.cond` that picks the JAX step's matching-buffer update
// (loam_livox_tpu/runtime/odometry.py:422-453).
//
// Bound: one thread reads a few bytes; the kernel's time is its launch
// latency inside the graph.

#include <cuda_runtime.h>

namespace {

__global__ void loop_cond_kernel(cudaGraphConditionalHandle handle, int set_handle,
                                 const bool* __restrict__ active, int n_lanes,
                                 const int* __restrict__ loops, int max_loops,
                                 int* __restrict__ out, unsigned long long* __restrict__ runs) {
  if (runs != nullptr) atomicAdd(runs, 1ull);  // the run counter
  bool any = false;
  for (int i = 0; i < n_lanes; ++i) any = any || active[i];
  const unsigned int v = (any && (loops == nullptr || *loops < max_loops)) ? 1u : 0u;
  if (out != nullptr) *out = static_cast<int>(v);
  if (set_handle) cudaGraphSetConditional(handle, v);
}

cudaError_t add_cond_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                          cudaGraphConditionalHandle handle, const bool* active, int n_lanes,
                          const int* loops, int max_loops, unsigned long long* runs) {
  int set_handle = 1;
  int* out = nullptr;
  void* args[] = {&handle, &set_handle, &active, &n_lanes, &loops, &max_loops, &out, &runs};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_cond_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, dep, dep ? 1 : 0, &p);
}

cudaError_t add_conditional_node(cudaGraphNode_t* node, cudaGraph_t graph,
                                 const cudaGraphNode_t* dep, cudaGraphConditionalHandle handle,
                                 cudaGraphConditionalNodeType type, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = type;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(node, graph, dep, nullptr, dep ? 1 : 0, &p);
#else
  cudaError_t e = cudaGraphAddNode(node, graph, dep, dep ? 1 : 0, &p);
#endif
  if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return e;
}

}  // namespace

extern "C" {

// The condition alone, for the comparison with its plain version: writes
// any(active[0:n_lanes]) && *loops < max_loops to out[0] (without the pass
// count when loops is null); `runs` (a device counter, or null) gains one.
// Returns a CUDA error code, 0 on a launch accepted.
int loop_cond_launch(const bool* active, int n_lanes, const int* loops, int max_loops, int* out,
                     unsigned long long* runs, void* stream) {
  if (n_lanes <= 0 || out == nullptr) return cudaErrorInvalidValue;
  loop_cond_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(0, 0, active, n_lanes, loops,
                                                                   max_loops, out, runs);
  return static_cast<int>(cudaGetLastError());
}

// Item kinds of frame_graph_build.
enum { kSegment = 0, kWhile = 1, kIf = 2 };

// Assemble and instantiate the graph of the file comment on `device`
// from n_items items in order.  Item i is kinds[i]: a segment, whose
// graphs[i] is placed as a child graph; a loop, whose graphs[i] is the
// pass, flags[i] the carry's n_flags[i] `active` bools, loops[i] its
// int32 pass count and max_loops[i] the most passes; or a branch, whose
// graphs[i] runs when its one bool flags[i] is set.  graphs[] are
// cudaGraph_t's, cloned (the caller keeps and frees its own).  Every
// condition kernel placed adds one to `runs` (a device counter, or null)
// when it runs.  On success *graph_out and *exec_out hold the graph and
// its executable (free both with frame_graph_destroy) and *cond_nodes the
// condition kernels placed.  Returns a CUDA error code; on an error
// nothing is left allocated.
int frame_graph_build(int device, int n_items, const int* kinds, void* const* graphs,
                      void* const* flags, const int* n_flags, void* const* loops,
                      const int* max_loops, unsigned long long* runs, void** graph_out,
                      void** exec_out, int* cond_nodes) {
  if (n_items <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t graph = nullptr;
  e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNode_t prev = nullptr, node;
  int placed = 0;
  for (int i = 0; i < n_items && e == cudaSuccess; ++i) {
    const cudaGraphNode_t* dep = prev ? &prev : nullptr;
    cudaGraph_t child = static_cast<cudaGraph_t>(graphs[i]);
    if (kinds[i] == kSegment) {
      e = cudaGraphAddChildGraphNode(&node, graph, dep, dep ? 1 : 0, child);
      prev = node;
      continue;
    }
    if (kinds[i] != kWhile && kinds[i] != kIf) {
      e = cudaErrorInvalidValue;
      break;
    }
    const bool loop = kinds[i] == kWhile;
    const bool* active = static_cast<const bool*>(flags[i]);
    const int lanes = loop ? n_flags[i] : 1;
    const int* count = loop ? static_cast<const int*>(loops[i]) : nullptr;
    const int most = loop ? max_loops[i] : 0;
    cudaGraphConditionalHandle handle;
    e = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
    if (e != cudaSuccess) break;
    e = add_cond_node(&node, graph, dep, handle, active, lanes, count, most, runs);
    if (e != cudaSuccess) break;
    ++placed;
    prev = node;
    cudaGraph_t body;
    e = add_conditional_node(&node, graph, &prev, handle,
                             loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf, &body);
    if (e != cudaSuccess) break;
    prev = node;
    cudaGraphNode_t pass, cond;
    e = cudaGraphAddChildGraphNode(&pass, body, nullptr, 0, child);
    if (e != cudaSuccess || !loop) continue;
    e = add_cond_node(&cond, body, &pass, handle, active, lanes, count, most, runs);
    if (e == cudaSuccess) ++placed;
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

// One tracker IRLS level as one CUDA graph: the reference's
// `jax.lax.while_loop(lambda c: ~c.done, step, init)`
// (dvo_slam_tpu/models/dense_tracker.py:445-449) with no host read.
//
// The caller (models/irls_graph.py) captures two PyTorch CUDA graphs over
// one set of static buffers: the head (the level's initial carry, then K
// steps) and the tail (K more steps from the carry buffers).  Each ends by
// copying its carry into the state buffers, whose `done` flags ([B] bools,
// one byte each) this file reads.  dvo_while_graph_build nests them as
//
//     child graph (head) -> set_while -> WHILE { child graph (tail) -> set_while }
//
// so one launch runs the head and then the tail for as long as a stream is
// not done.  The loop always ends: every step sets `done` once its stream
// has run max_iterations_per_level steps, and a NaN increment stops it too
// (its log-likelihood does not decrease, so the step is rejected).
//
// set_while is this file's kernel: one thread reads the B flags in stream
// order (a fixed-order reduction), sets the WHILE node's condition to 1
// while any stream is not done (cudaGraphSetConditional, CUDA >= 12.4) and
// adds one to its run counter: runs[0] counts the heads, runs[1] the tail
// chunks, so the host can count the kernels the level launched without a
// read per level (irls_graph.fold_counts reads them when a count is asked
// for).  What bounds it: one launch on one SM, B bytes read; its cost is the
// launch latency between two chunks inside the graph, which replaces a host
// round trip per chunk.
//
// A conditional body takes kernel, empty, child-graph, device memcpy and
// memset, and conditional nodes; it refuses host and event nodes.  A build
// that CUDA refuses returns CUDA's error with the step that failed, and the
// caller raises: there is no fallback to the host-polled chunks.
// dvo_graph_node_census counts a graph's nodes by type (recursing into child
// graphs), which the caller prints with such an error and the smoke run
// records.

#include <cuda_runtime.h>

#include <cstdio>
#include <vector>

namespace {

constexpr int kNodeTypes = 16;  // census slots: cudaGraphNodeType values 0..15

__global__ void set_while(cudaGraphConditionalHandle handle, const unsigned char* done,
                          int batch, unsigned long long* runs) {
  unsigned int more = 0;
  for (int b = 0; b < batch; ++b) more |= done[b] ? 0u : 1u;
  cudaGraphSetConditional(handle, more);
  *runs += 1ull;
}

int report(cudaError_t e, const char* what, char* err, int errlen) {
  if (err != nullptr && errlen > 0)
    snprintf(err, errlen, "%s: %s (%s)", what, cudaGetErrorName(e), cudaGetErrorString(e));
  return static_cast<int>(e);
}

cudaError_t add_set_while(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                          cudaGraphConditionalHandle handle, const unsigned char* done,
                          int batch, unsigned long long* runs) {
  void* args[] = {&handle, &done, &batch, &runs};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(set_while);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep, 1, &p);
}

cudaError_t census(cudaGraph_t graph, int* counts) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(graph, nullptr, &n);
  if (e != cudaSuccess) return e;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0 && (e = cudaGraphGetNodes(graph, nodes.data(), &n)) != cudaSuccess) return e;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    if ((e = cudaGraphNodeGetType(node, &type)) != cudaSuccess) return e;
    const int slot = static_cast<int>(type);
    counts[slot >= 0 && slot < kNodeTypes ? slot : kNodeTypes - 1] += 1;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      if ((e = cudaGraphChildGraphNodeGetGraph(node, &child)) != cudaSuccess) return e;
      if ((e = census(child, counts)) != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// head, tail: cudaGraph_t of the two captured chunks (PyTorch's
// CUDAGraph(keep_graph=True).raw_cuda_graph()); they are cloned, so the
// caller may keep or drop its own.  done: the state buffers' [batch] flags.
// runs: two uint64 counters on the device (heads, tail chunks).  On
// success *exec is the instantiated graph; on failure it is null and err
// holds the step that failed and CUDA's text.  Returns a cudaError_t.
int dvo_while_graph_build(void* head, void* tail, const void* done, int batch, void* runs,
                          void** exec, char* err, int errlen) {
  *exec = nullptr;
  if (batch < 1) return report(cudaErrorInvalidValue, "dvo_while_graph_build: batch < 1", err, errlen);
  const unsigned char* flags = static_cast<const unsigned char*>(done);
  unsigned long long* counters = static_cast<unsigned long long*>(runs);
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return report(e, "cudaGraphCreate", err, errlen);
  const char* what = "";
  char detail[160];
  cudaGraphExec_t out = nullptr;
  do {
    cudaGraphConditionalHandle handle;
    what = "cudaGraphConditionalHandleCreate";
    if ((e = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault)))
      break;
    cudaGraphNode_t head_node, set_head, loop, tail_node, set_tail;
    what = "cudaGraphAddChildGraphNode (the head)";
    if ((e = cudaGraphAddChildGraphNode(&head_node, graph, nullptr, 0,
                                        static_cast<cudaGraph_t>(head))))
      break;
    what = "cudaGraphAddKernelNode (set_while after the head)";
    if ((e = add_set_while(&set_head, graph, &head_node, handle, flags, batch, counters))) break;
    cudaGraphNodeParams cond = {};
    cond.type = cudaGraphNodeTypeConditional;
    cond.conditional.handle = handle;
    cond.conditional.type = cudaGraphCondTypeWhile;
    cond.conditional.size = 1;
    what = "cudaGraphAddNode (the WHILE node)";
#if CUDART_VERSION >= 13000
    if ((e = cudaGraphAddNode(&loop, graph, &set_head, nullptr, 1, &cond))) break;
#else
    if ((e = cudaGraphAddNode(&loop, graph, &set_head, 1, &cond))) break;
#endif
    cudaGraph_t body = cond.conditional.phGraph_out[0];
    what = "cudaGraphAddChildGraphNode (the tail, in the WHILE body)";
    if ((e = cudaGraphAddChildGraphNode(&tail_node, body, nullptr, 0,
                                        static_cast<cudaGraph_t>(tail))))
      break;
    what = "cudaGraphAddKernelNode (set_while in the WHILE body)";
    if ((e = add_set_while(&set_tail, body, &tail_node, handle, flags, batch, counters + 1)))
      break;
    cudaGraphInstantiateParams params = {};
    what = "cudaGraphInstantiateWithParams";
    e = cudaGraphInstantiateWithParams(&out, graph, &params);
    if (e == cudaSuccess && params.result_out != cudaGraphInstantiateSuccess)
      e = cudaErrorInvalidValue;
    if (e != cudaSuccess) {
      int type = -1;
      cudaGraphNodeType t;
      if (params.errNode_out != nullptr && cudaGraphNodeGetType(params.errNode_out, &t) == cudaSuccess)
        type = static_cast<int>(t);
      snprintf(detail, sizeof(detail),
               "cudaGraphInstantiateWithParams (instantiate result %d, failing node type %d)",
               static_cast<int>(params.result_out), type);
      what = detail;
    }
  } while (false);
  cudaGraphDestroy(graph);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return report(e, what, err, errlen);
  }
  *exec = out;
  return 0;
}

// One launch of a built level on `stream` (PyTorch's current stream).
int dvo_while_graph_launch(void* exec, void* stream) {
  return static_cast<int>(
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

int dvo_while_graph_destroy(void* exec) {
  return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

// counts[16]: the nodes of `graph` by cudaGraphNodeType, child graphs'
// nodes included (each child graph node is counted too).  Returns a
// cudaError_t.
int dvo_graph_node_census(void* graph, int* counts) {
  for (int i = 0; i < kNodeTypes; ++i) counts[i] = 0;
  return static_cast<int>(census(static_cast<cudaGraph_t>(graph), counts));
}

// CUDA's name and text of an error code, for the Python side.
void dvo_cuda_error_text(int code, char* out, int len) {
  const cudaError_t e = static_cast<cudaError_t>(code);
  snprintf(out, len, "%s (%s)", cudaGetErrorName(e), cudaGetErrorString(e));
}

}  // extern "C"

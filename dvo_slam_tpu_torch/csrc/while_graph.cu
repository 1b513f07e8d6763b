// A device loop as one CUDA graph: the reference's `jax.lax.while_loop`
// with no host read.  Three loops take this form: a tracker IRLS level
// (`lax.while_loop(lambda c: ~c.done, step, init)`,
// dvo_slam_tpu/models/dense_tracker.py:445-449), the pixel-sharded level
// (dvo_slam_tpu/parallel/sharded_alignment.py:200, the same loop with its
// all-reduces) and block-CG (dvo_slam_tpu/models/pose_graph.py:294-311,
// looping while its carry's `active` is true).
//
// The caller (models/irls_graph.py) captures two PyTorch CUDA graphs over
// one set of static buffers: the head (the loop's initial carry, then K
// steps) and the tail (K more steps from the carry buffers).  Each ends by
// copying its carry into the state buffers, whose [B] byte flags this file
// reads.  dvo_while_graph_build nests them as
//
//     child graph (head) -> set_while -> WHILE { child graph (tail) -> set_while }
//
// so one launch runs the head and then the tail for as long as the loop's
// condition holds.  The condition's sense is the build's `loop_on`: the
// loop goes on while one of the B flags equals it (0 for the IRLS levels'
// `done` flags, 1 for CG's `active`).  The loops always end: an IRLS step
// sets `done` once its stream has run max_iterations_per_level steps, and
// a NaN increment stops it too (its log-likelihood does not decrease, so
// the step is rejected); CG's `active` is false from its iteration cap on.
//
// set_while is this file's kernel: one thread reads the B flags in stream
// order (a fixed-order reduction), sets the WHILE node's condition to 1
// while one of them equals `loop_on` (cudaGraphSetConditional, CUDA >=
// 12.4) and adds one to its run counter: runs[0] counts the heads, runs[1]
// the tail chunks, so the host can count the kernels the loop launched
// without a read per loop (irls_graph.fold_counts reads them when a count
// is asked for).  What bounds it: one launch on one SM, B bytes read; its
// cost is the launch latency between two chunks inside the graph, which
// replaces a host round trip per chunk.
//
// A whole tracker match (dvo_slam_tpu/models/dense_tracker.py:match_prepared:
// the warm start, the levels coarse to fine with the next level's start
// values between them, the result) takes the same form once more:
// dvo_match_graph_build chains
//
//     setup -> [head_l -> set_while_l -> WHILE_l { tail_l -> set_while_l } -> link_l]...
//           -> result -> memcpy of the result row to pinned host memory
//
// with one conditional handle per level and the level's own flags and run
// counters, from captures of the setup, of the links between levels and of
// the result (the last level has no link), so one launch runs the match and
// one host wait reads it.
//
// A conditional body takes kernel, empty, child-graph, device memcpy and
// memset, and conditional nodes; it refuses host and event nodes.  A build
// that CUDA refuses returns CUDA's error with the step that failed, and the
// caller raises (or, for a process group's probe, records the refusal and
// keeps that group's loops host-polled).  dvo_graph_node_census counts a
// graph's nodes by type (recursing into child graphs), which the caller
// prints with such an error and the smoke run records.

#include <cuda_runtime.h>

#include <cstdio>
#include <vector>

namespace {

constexpr int kNodeTypes = 16;  // census slots: cudaGraphNodeType values 0..15

__global__ void set_while(cudaGraphConditionalHandle handle, const unsigned char* flags,
                          int batch, int loop_on, unsigned long long* runs) {
  unsigned int more = 0;
  for (int b = 0; b < batch; ++b) more |= (flags[b] != 0) == (loop_on != 0) ? 1u : 0u;
  cudaGraphSetConditional(handle, more);
  *runs += 1ull;
}

int report(cudaError_t e, const char* what, char* err, int errlen) {
  if (err != nullptr && errlen > 0)
    snprintf(err, errlen, "%s: %s (%s)", what, cudaGetErrorName(e), cudaGetErrorString(e));
  return static_cast<int>(e);
}

cudaError_t add_set_while(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                          cudaGraphConditionalHandle handle, const unsigned char* flags,
                          int batch, int loop_on, unsigned long long* runs) {
  void* args[] = {&handle, &flags, &batch, &loop_on, &runs};
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

// One loop into `graph` after `dep` (null: at the start): child graph
// (head) -> set_while -> WHILE { child graph (tail) -> set_while }.  *last is
// the WHILE node; *what names the step that failed.
cudaError_t add_loop(cudaGraph_t graph, cudaGraphNode_t dep, void* head, void* tail,
                     const unsigned char* flags, int batch, int loop_on,
                     unsigned long long* counters, cudaGraphNode_t* last, const char** what) {
  cudaError_t e;
  cudaGraphConditionalHandle handle;
  *what = "cudaGraphConditionalHandleCreate";
  if ((e = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault)))
    return e;
  cudaGraphNode_t head_node, set_head, loop, tail_node, set_tail;
  *what = "cudaGraphAddChildGraphNode (the head)";
  if ((e = cudaGraphAddChildGraphNode(&head_node, graph, dep ? &dep : nullptr, dep ? 1 : 0,
                                      static_cast<cudaGraph_t>(head))))
    return e;
  *what = "cudaGraphAddKernelNode (set_while after the head)";
  if ((e = add_set_while(&set_head, graph, &head_node, handle, flags, batch, loop_on, counters)))
    return e;
  cudaGraphNodeParams cond = {};
  cond.type = cudaGraphNodeTypeConditional;
  cond.conditional.handle = handle;
  cond.conditional.type = cudaGraphCondTypeWhile;
  cond.conditional.size = 1;
  *what = "cudaGraphAddNode (the WHILE node)";
#if CUDART_VERSION >= 13000
  if ((e = cudaGraphAddNode(&loop, graph, &set_head, nullptr, 1, &cond))) return e;
#else
  if ((e = cudaGraphAddNode(&loop, graph, &set_head, 1, &cond))) return e;
#endif
  cudaGraph_t body = cond.conditional.phGraph_out[0];
  *what = "cudaGraphAddChildGraphNode (the tail, in the WHILE body)";
  if ((e = cudaGraphAddChildGraphNode(&tail_node, body, nullptr, 0,
                                      static_cast<cudaGraph_t>(tail))))
    return e;
  *what = "cudaGraphAddKernelNode (set_while in the WHILE body)";
  if ((e = add_set_while(&set_tail, body, &tail_node, handle, flags, batch, loop_on,
                          counters + 1)))
    return e;
  *last = loop;
  return cudaSuccess;
}

// Instantiate `graph` into *out; on failure *what says how (the instantiate
// result and the failing node's type, in `detail`).
cudaError_t instantiate(cudaGraph_t graph, cudaGraphExec_t* out, const char** what,
                        char* detail, size_t len) {
  cudaGraphInstantiateParams params = {};
  *what = "cudaGraphInstantiateWithParams";
  cudaError_t e = cudaGraphInstantiateWithParams(out, graph, &params);
  if (e == cudaSuccess && params.result_out != cudaGraphInstantiateSuccess)
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) {
    int type = -1;
    cudaGraphNodeType t;
    if (params.errNode_out != nullptr && cudaGraphNodeGetType(params.errNode_out, &t) == cudaSuccess)
      type = static_cast<int>(t);
    snprintf(detail, len,
             "cudaGraphInstantiateWithParams (instantiate result %d, failing node type %d)",
             static_cast<int>(params.result_out), type);
    *what = detail;
  }
  return e;
}

}  // namespace

extern "C" {

// head, tail: cudaGraph_t of the two captured chunks (PyTorch's
// CUDAGraph(keep_graph=True).raw_cuda_graph()); they are cloned, so the
// caller may keep or drop its own.  flags: the state buffers' [batch] byte
// flags; the loop goes on while one of them equals loop_on (0 or 1).
// runs: two uint64 counters on the device (heads, tail chunks).  On
// success *exec is the instantiated graph; on failure it is null and err
// holds the step that failed and CUDA's text.  Returns a cudaError_t.
int dvo_while_graph_build(void* head, void* tail, const void* done, int batch, int loop_on,
                          void* runs, void** exec, char* err, int errlen) {
  *exec = nullptr;
  if (batch < 1) return report(cudaErrorInvalidValue, "dvo_while_graph_build: batch < 1", err, errlen);
  if (loop_on != 0 && loop_on != 1)
    return report(cudaErrorInvalidValue, "dvo_while_graph_build: loop_on is not 0 or 1", err, errlen);
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return report(e, "cudaGraphCreate", err, errlen);
  const char* what = "";
  char detail[160];
  cudaGraphExec_t out = nullptr;
  cudaGraphNode_t loop;
  e = add_loop(graph, nullptr, head, tail, static_cast<const unsigned char*>(done), batch, loop_on,
               static_cast<unsigned long long*>(runs), &loop, &what);
  if (e == cudaSuccess) e = instantiate(graph, &out, &what, detail, sizeof(detail));
  cudaGraphDestroy(graph);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return report(e, what, err, errlen);
  }
  *exec = out;
  return 0;
}

// A whole match as one graph.  setup: the captured start of the first
// level; heads, tails, dones, runs: each level's chunks, its [batch] byte
// `done` flags (the loop goes on while one of them is 0) and its two run
// counters, coarse to fine; links: the captures between level l and l + 1
// (levels - 1 of them); result: the capture that writes the result row at
// `row` (`bytes` bytes on the device), which a memcpy node then copies to
// `host` (pinned).  The same returns as dvo_while_graph_build.
int dvo_match_graph_build(int levels, void* setup, void* const* heads, void* const* tails,
                          const void* const* dones, int batch, void* const* runs,
                          void* const* links, void* result, const void* row, void* host,
                          long long bytes, void** exec, char* err, int errlen) {
  *exec = nullptr;
  if (levels < 1 || batch < 1 || bytes < 1)
    return report(cudaErrorInvalidValue, "dvo_match_graph_build: no level, stream or byte", err,
                  errlen);
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return report(e, "cudaGraphCreate", err, errlen);
  const char* what = "";
  char detail[160];
  cudaGraphExec_t out = nullptr;
  do {
    cudaGraphNode_t last, node;
    what = "cudaGraphAddChildGraphNode (the setup)";
    if ((e = cudaGraphAddChildGraphNode(&last, graph, nullptr, 0, static_cast<cudaGraph_t>(setup))))
      break;
    for (int l = 0; l < levels && e == cudaSuccess; ++l) {
      if ((e = add_loop(graph, last, heads[l], tails[l], static_cast<const unsigned char*>(dones[l]),
                        batch, 0, static_cast<unsigned long long*>(runs[l]), &last, &what)))
        break;
      void* next = l + 1 < levels ? links[l] : result;
      what = l + 1 < levels ? "cudaGraphAddChildGraphNode (a link between levels)"
                            : "cudaGraphAddChildGraphNode (the result)";
      if ((e = cudaGraphAddChildGraphNode(&node, graph, &last, 1, static_cast<cudaGraph_t>(next))))
        break;
      last = node;
    }
    if (e != cudaSuccess) break;
    what = "cudaGraphAddMemcpyNode1D (the result row to the host)";
    if ((e = cudaGraphAddMemcpyNode1D(&node, graph, &last, 1, host, row, static_cast<size_t>(bytes),
                                      cudaMemcpyDeviceToHost)))
      break;
    e = instantiate(graph, &out, &what, detail, sizeof(detail));
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

// Timing events for the span recorder (utils/timers.py): made once and
// pooled, recorded on PyTorch's current stream, read without waiting.
// Each returns a cudaError_t.
int dvo_event_create(void** event) {
  cudaEvent_t e = nullptr;
  const cudaError_t r = cudaEventCreate(&e);
  *event = e;
  return static_cast<int>(r);
}

int dvo_event_record(void* event, void* stream) {
  return static_cast<int>(
      cudaEventRecord(static_cast<cudaEvent_t>(event), static_cast<cudaStream_t>(stream)));
}

// *ms between two recorded events once both have completed; until then
// cudaErrorNotReady, cleared from the thread's last error as PyTorch's own
// event query clears it, so that no later launch check reads it.
int dvo_event_elapsed(void* start, void* end, float* ms) {
  const cudaError_t r =
      cudaEventElapsedTime(ms, static_cast<cudaEvent_t>(start), static_cast<cudaEvent_t>(end));
  if (r == cudaErrorNotReady) cudaGetLastError();
  return static_cast<int>(r);
}

int dvo_event_destroy(void* event) {
  return static_cast<int>(cudaEventDestroy(static_cast<cudaEvent_t>(event)));
}

// CUDA's name and text of an error code, for the Python side.
void dvo_cuda_error_text(int code, char* out, int len) {
  const cudaError_t e = static_cast<cudaError_t>(code);
  snprintf(out, len, "%s (%s)", cudaGetErrorName(e), cudaGetErrorString(e));
}

}  // extern "C"

// Conditional ("if") nodes for a CUDA graph that PyTorch is capturing.
//
// The port's counterpart of the JAX package's `lax.cond` inside its compiled
// frame step: a branch of the frame becomes a node of the frame's graph that
// runs its body graph only when a predicate in device memory is true at
// replay.  The Python API of PyTorch 2.11 (the card's) offers no such node,
// so this library makes it from the CUDA runtime (12.4 or newer):
//
//   graph_cond_setup()
//     loads the kernel below (call it before a capture);
//   graph_cond_begin(capture_stream, pred, body_stream)
//     on a stream that is capturing: a conditional handle of the graph being
//     captured, a one-thread kernel node that sets the handle from `*pred`
//     (a bool), the `if` node after it, and the capture of `body_stream`
//     into the node's body graph begun; the capturing stream continues after
//     the node;
//   graph_cond_end(body_stream)
//     ends the body's capture.
//   graph_body_mark(body_stream, marks, elapsed, index, last)
//     a one-thread kernel node on the body's stream that reads the device's
//     nanosecond clock (%globaltimer): the first mark of body `index` keeps
//     the time in marks[index], the last (`last` != 0) adds the time since
//     to elapsed[index], so `elapsed` sums the device ns of every replay
//     that took the body.  A replay runs its bodies one after another, so
//     one thread each, with no atomics, suffices.
//
//   graph_capture_node_types(stream, types, capacity, &count)
//     the nodes of the graph `stream` is capturing into so far (a nested
//     `if` node counts as one node of its parent), and the first `capacity`
//     nodes' cudaGraphNodeType in `types` (-1 where the runtime gives none):
//     what a body holds, so that a refused capture names the node at fault.
//
// A body may hold another `if` node: begin it on the body's stream with a
// third stream for the inner body.  Each call returns a cudaError_t (0 = ok).

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__global__ void body_mark_kernel(long long* marks, long long* elapsed,
                                 int index, int last) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (last)
    elapsed[index] += static_cast<long long>(now) - marks[index];
  else
    marks[index] = static_cast<long long>(now);
}

}  // namespace

// Loads the kernels ahead of any capture (a module loaded lazily would load
// inside the capture).
extern "C" int graph_cond_setup() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, set_condition_kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncGetAttributes(&attr, body_mark_kernel);
}

extern "C" int graph_body_mark(cudaStream_t body_stream, long long* marks,
                               long long* elapsed, int index, int last) {
  body_mark_kernel<<<1, 1, 0, body_stream>>>(marks, elapsed, index, last);
  return cudaGetLastError();
}

extern "C" int graph_cond_begin(cudaStream_t capture_stream, const bool* pred,
                                cudaStream_t body_stream) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(capture_stream, &status, nullptr,
                                             &graph, &deps, &num_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition_kernel<<<1, 1, 0, capture_stream>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the node depends on what the stream's capture depends on now: the kernel
  err = cudaStreamGetCaptureInfo(capture_stream, &status, nullptr, &graph,
                                 &deps, &num_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(capture_stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(body_stream,
                                       params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

extern "C" int graph_cond_end(cudaStream_t body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(body_stream, &body);
}

extern "C" int graph_capture_node_types(cudaStream_t stream, int* types,
                                        size_t capacity, size_t* count) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph,
                                             nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  err = cudaGraphGetNodes(graph, nullptr, count);
  if (err != cudaSuccess || capacity == 0 || *count == 0) return err;
  // the types are a diagnostic: a node whose type the runtime does not give
  // (or a graph whose nodes it does not list) reads -1, and the error is
  // cleared so that it reaches no later launch check
  size_t n = *count;
  for (size_t i = 0; i < n && i < capacity; ++i) types[i] = -1;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  if (cudaGraphGetNodes(graph, nodes, &n) == cudaSuccess) {
    for (size_t i = 0; i < n && i < capacity; ++i) {
      cudaGraphNodeType type;
      if (cudaGraphNodeGetType(nodes[i], &type) == cudaSuccess)
        types[i] = static_cast<int>(type);
    }
  }
  delete[] nodes;
  cudaGetLastError();
  return cudaSuccess;
}

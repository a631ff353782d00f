// CUDA-graph conditional nodes for the tenant plane's structural control
// flow: a `while_loop` (and each branch of a `cond`) inside a tenant
// kernel's captured graph becomes a conditional node whose body graph is
// captured from the loop body, and whose condition is set on the device
// from a predicate tensor.  Nothing here reads the predicate on the host,
// so a data-dependent trip count replays inside one graph with no sync.
//
// A graph helper, not a port of a TPU kernel: it addresses no arena.
//
// Use, on a stream S that is capturing a graph G:
//   1. graph_nodes_begin(S, pred, type, negate, &body, &handle): creates a
//      conditional handle in G, launches the one-thread set kernel on S
//      (the node's first evaluation), and adds the conditional node
//      (cudaGraphCondTypeIf or cudaGraphCondTypeWhile) after it; S's
//      capture then continues after the node.  Returns the node's body
//      graph.
//   2. graph_nodes_capture_to(C, body): a stream C that is not capturing
//      starts capturing into the body graph (relaxed mode).  C is one of
//      the caller's own streams (graph_nodes_stream_new), one per nesting
//      depth: never S, nor a stream of an enclosing body, nor a stream
//      some other code may be capturing on.
//   3. The body's operations are issued on C; a while body ends with
//      graph_nodes_set(C, handle, pred', 0), which sets the condition for
//      the next iteration.
//   4. graph_nodes_end_capture(C, body) ends C's capture.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void graph_nodes_set_kernel(cudaGraphConditionalHandle handle,
                                       const unsigned char* pred,
                                       int negate) {
  cudaGraphSetConditional(handle, (pred[0] != 0) != (negate != 0) ? 1 : 0);
}

extern "C" int graph_nodes_set(void* stream, unsigned long long handle,
                               const void* pred, int negate) {
  graph_nodes_set_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (cudaGraphConditionalHandle)handle, (const unsigned char*)pred, negate);
  return (int)cudaGetLastError();
}

extern "C" int graph_nodes_begin(void* stream, const void* pred, int type,
                                 int negate, void** body_out,
                                 unsigned long long* handle_out) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                           &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureUnsupported;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  int rc = graph_nodes_set(stream, handle, pred, negate);
  if (rc != 0) return rc;
  // the dependencies now end at the set kernel
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      type == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  *body_out = (void*)params.conditional.phGraph_out[0];
  *handle_out = (unsigned long long)handle;
  return 0;
}

extern "C" int graph_nodes_capture_to(void* stream, void* body) {
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)stream, (cudaGraph_t)body, nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed);
}

extern "C" int graph_nodes_end_capture(void* stream, void* body) {
  cudaGraph_t got = nullptr;
  cudaError_t e = cudaStreamEndCapture((cudaStream_t)stream, &got);
  if (e != cudaSuccess) return (int)e;
  return got == (cudaGraph_t)body ? 0 : (int)cudaErrorStreamCaptureInvalidated;
}

extern "C" int graph_nodes_stream_new(void** stream_out) {
  cudaStream_t s = nullptr;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream_out = (void*)s;
  return (int)e;
}

extern "C" const char* graph_nodes_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// CUDA graph conditional IF nodes for the phase runner
// (repro_torch/slam/graphs.py): the counterpart of the reference's
// jax.lax.cond(is_kf, map_branch, skip_branch) at repro/slam/session.py:547,
// which XLA compiles into one program with the branch inside it.
//
// Replaces no TPU kernel.  PyTorch 2.11 has no binding for conditional
// nodes, so the runner opens one in the graph its stream is capturing:
//
//   cond_begin  reads the parent capture's graph and frontier, makes a
//               conditional handle in that graph, captures one launch of
//               k_set_cond (one thread: handle := *pred, read on the device
//               at every replay), adds an IF node after it whose body
//               graph is empty, moves the parent stream's frontier past the
//               node, and starts capturing a second stream into a graph of
//               its own;
//   cond_end    ends that capture and, if it succeeded, adds what it
//               captured to the IF node's body as a child graph.  A body
//               whose capture failed (a read from the host invalidates it)
//               leaves the body empty, so the parent graph stays valid and
//               the caller raises the body's error;
//   cond_stream_create  makes the body stream: a stream of its own, never
//               one of PyTorch's pooled streams, which other code (the graph
//               capture's own stream among them) may be using.
//
// Between the two the caller issues the body's work on the body stream; the
// body runs at a replay only when *pred is true, and whatever the parent
// captures afterwards waits for the node.  Nothing here allocates device
// memory, and nothing synchronises.  Each call returns its first CUDA error
// (0 if none), which the caller raises.

#include <cuda_runtime.h>

namespace {

__global__ void k_set_cond(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int cond_begin(void* parent_stream, const void* pred, void* body_stream,
                          void** body_graph) {
  cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph,
                                             nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureInvalidated;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  k_set_cond<<<1, 1, 0, parent>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  *body_graph = params.conditional.phGraph_out[0];
  return cudaStreamBeginCapture(static_cast<cudaStream_t>(body_stream),
                                cudaStreamCaptureModeThreadLocal);
}

extern "C" int cond_end(void* body_stream, void* body_graph) {
  cudaGraph_t captured = nullptr;
  cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream),
                                         &captured);
  if (err == cudaSuccess && captured == nullptr) err = cudaErrorStreamCaptureInvalidated;
  if (err == cudaSuccess) {
    cudaGraphNode_t child;
    err = cudaGraphAddChildGraphNode(&child, static_cast<cudaGraph_t>(body_graph),
                                     nullptr, 0, captured);
  }
  if (captured != nullptr) cudaGraphDestroy(captured);
  return err;
}

extern "C" int cond_stream_create(void** stream) {
  return cudaStreamCreateWithFlags(reinterpret_cast<cudaStream_t*>(stream),
                                   cudaStreamNonBlocking);
}

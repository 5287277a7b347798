// Phase marks: an empty one-thread kernel that the train step launches
// between its phases (forward, backward, clip and optimizer), so that the
// profiler's trace of a CUDA graph replay says where each phase starts, on
// the clock of the graph's other kernels (utils/tracing.py).
//
// Replaces no TPU kernel. The JAX package's step is one XLA program that its
// own profiler splits by op name; a replayed CUDA graph has no host ranges
// (a range opened while a step is captured is an event of the capture, and
// never replays), so the marks are device operations inside the graph.
//
// Bound: the launch. It reads and writes nothing; each id is its own
// template instance, so its demangled name, trace_mark_kernel<id>, tells
// the marks apart in a trace.
//
// Off means disabled, not absent: a compiled step captures its marks always,
// finds their nodes once after the capture (ptgnn_trace_mark_nodes below),
// and switches them in the executable graph with cudaGraphNodeSetEnabled
// (ptgnn_trace_mark_set_enabled); a disabled node runs as an empty node.
#include <cuda_runtime.h>

#include <vector>

template <int Id>
__global__ void trace_mark_kernel() {}

namespace {

constexpr int kMarks = 4;

const void* mark_function(int id) {
  switch (id) {
    case 0: return reinterpret_cast<const void*>(&trace_mark_kernel<0>);
    case 1: return reinterpret_cast<const void*>(&trace_mark_kernel<1>);
    case 2: return reinterpret_cast<const void*>(&trace_mark_kernel<2>);
    case 3: return reinterpret_cast<const void*>(&trace_mark_kernel<3>);
    default: return nullptr;
  }
}

bool is_mark(const void* func) {
  for (int id = 0; id < kMarks; ++id) {
    if (func == mark_function(id)) return true;
  }
  return false;
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch mark `id` (0-3) on `stream`. Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int ptgnn_trace_mark(int id, void* stream) {
  const void* func = mark_function(id);
  if (func == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaLaunchKernel(func, dim3(1), dim3(1), nullptr, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Walk `graph`'s nodes and write the kernel nodes that launch a mark to
// nodes[0 .. capacity) in graph order; *count is how many there are (call
// with capacity 0 to size `nodes`). A kernel node whose parameters this
// runtime cannot read (a kernel of another library) is not a mark; the error
// that query leaves is cleared.
extern "C" int ptgnn_trace_mark_nodes(void* graph, void** nodes, int capacity, int* count) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  *count = 0;
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> all(n);
  if (n > 0) {
    err = cudaGraphGetNodes(g, all.data(), &n);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int found = 0;
  for (cudaGraphNode_t node : all) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(node, &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (type != cudaGraphNodeTypeKernel) continue;
    cudaKernelNodeParams params = {};
    if (cudaGraphKernelNodeGetParams(node, &params) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    if (!is_mark(params.func)) continue;
    if (found < capacity) nodes[found] = node;
    ++found;
  }
  *count = found;
  return static_cast<int>(cudaSuccess);
}

// Enable (enabled != 0) or disable `n` mark nodes of a graph in `exec`, an
// executable graph instantiated from it, from its next launch on.
extern "C" int ptgnn_trace_mark_set_enabled(void* exec, void* const* nodes, int n, int enabled) {
  const cudaGraphExec_t e = static_cast<cudaGraphExec_t>(exec);
  for (int i = 0; i < n; ++i) {
    const cudaError_t err = cudaGraphNodeSetEnabled(e, static_cast<cudaGraphNode_t>(nodes[i]), enabled ? 1u : 0u);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

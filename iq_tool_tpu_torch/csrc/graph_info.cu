// The CUDA graph a stream is capturing into, counted by node type:
// GraphedStep's stage map reads it as each of the chain's spans opens and
// closes during the capture (pipeline/graphed.py).

#include <cuda_runtime.h>

#include <vector>

// counts[0..3]: the kernel, memcpy, memset and other nodes of the graph
// that `stream` is capturing into.  cudaErrorIllegalState when the stream
// is not capturing.
extern "C" int iq_capture_nodes(void* stream, long long* counts) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  cudaError_t rc = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream),
                                            &status, nullptr, &graph);
  if (rc != cudaSuccess) return rc;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) {
    return cudaErrorIllegalState;
  }
  size_t n = 0;
  rc = cudaGraphGetNodes(graph, nullptr, &n);
  if (rc != cudaSuccess) return rc;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n) {
    rc = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (rc != cudaSuccess) return rc;
  }
  for (int k = 0; k < 4; ++k) counts[k] = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    rc = cudaGraphNodeGetType(nodes[i], &type);
    if (rc != cudaSuccess) return rc;
    switch (type) {
      case cudaGraphNodeTypeKernel: ++counts[0]; break;
      case cudaGraphNodeTypeMemcpy: ++counts[1]; break;
      case cudaGraphNodeTypeMemset: ++counts[2]; break;
      default: ++counts[3]; break;
    }
  }
  return cudaSuccess;
}

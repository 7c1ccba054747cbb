// The graph reader: the nodes and edges of a captured CUDA graph, in one
// call, for the structural validator (src/repro_torch/core/validator.py).
//
// No TPU kernel corresponds to it.  It is host code: the JAX package's
// validator reads XLA's compiled module as text, and the port's programs are
// CUDA graphs, so this reads the graph that a program's capture produced
// (PyTorch's CUDAGraph(keep_graph=True).raw_cuda_graph()).
//
// What it returns, into arrays that the caller allocates:
// * every node, in a topological order of the graph's edges (Kahn's
//   algorithm, ties taken in the order cudaGraphGetNodes gives): its node
//   type and, for a kernel node, which of this library's kernel instances it
//   launches (instances.cuh), or 0 for any other kernel (PyTorch's).  For
//   K1/K2/K3 it also returns the accumulator, n_diag, the shape arguments
//   (K1: n, k, m; K2: n_out; K3: n, k, d), the modulus (K2, K3: the first
//   field of FoldConsts), the grid's blocks and the operand pointers, read
//   from the node's own copy of the launch arguments;
// * every edge, as (source, destination) positions in that order, with its
//   type (cudaGraphDependencyTypeDefault, a full dependency, or
//   cudaGraphDependencyTypeProgrammatic, the edge that K2's programmatic
//   dependent launch leaves in a captured graph) and its source port.
//
// A node's kernel is recognised by the function its parameters name, held
// against each instance's host stub.  This library's runtime (cudart is
// linked statically) reads the parameters of the nodes its own launches made
// and names their host stubs; it refuses the nodes of kernels registered
// with another runtime (PyTorch's), whose parameters libcuda's
// cuGraphKernelNodeGetParams then reads (their functions are no stub of
// this library).  A kernel node whose parameters neither can read is
// reported with T_MATCH = -1.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <functional>
#include <queue>
#include <unordered_map>
#include <vector>

#include "instances.cuh"
#include "launch.cuh"

#if CUDART_VERSION >= 13000
#define GRAPH_GET_EDGES cudaGraphGetEdges
#elif CUDART_VERSION >= 12030
#define GRAPH_GET_EDGES cudaGraphGetEdges_v2
#else
#error "the graph reader needs CUDA 12.3 or later: edge types came with it"
#endif

namespace {

// The int32 fields of one node.
enum {
  T_TYPE,     // cudaGraphNodeType (0 = kernel)
  T_KERNEL,   // 1 K1, 2 K2, 3 K3, 0 another kernel or no kernel
  T_FP32,     // K1, K3: fp32_mantissa accumulator
  T_NDIAG,    // K2, K3
  T_N,        // K1, K3: rows; K2: outputs
  T_K,        // K1, K3
  T_M,        // K1: columns; K3: d
  T_MODULUS,  // K2, K3
  T_BLOCKS,   // blocks in the grid (kernel nodes)
  T_MATCH,    // 1 a host stub of this library, -1 unreadable
  NODE_INTS
};
constexpr int EDGE_INTS = 4;  // source, destination, type, source port

// Host stub -> instance, for every kernel instance of the library.
std::unordered_map<const void*, KernelInstance> instances() {
  KernelInstance all[3 * MAX_INSTANCES];
  int n = limb_matmul_instances(all);
  n += mont_fold_instances(all + n);
  n += fused_ntt_tile_instances(all + n);
  std::unordered_map<const void*, KernelInstance> ids;
  for (int i = 0; i < n; ++i) ids[all[i].stub] = all[i];
  return ids;
}

// libcuda's cuGraphKernelNodeGetParams, found through the runtime's
// entry-point query so that the library needs no link to libcuda.
using NodeParams = CUresult (*)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*);

NodeParams node_params() {
  static const NodeParams fn = []() -> NodeParams {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuGraphKernelNodeGetParams", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<NodeParams>(p);
  }();
  return fn;
}

// A kernel node's function (or, when the node names none, its
// context-independent kernel handle), grid and arguments; false when
// neither the runtime nor libcuda reads them.
bool kernel_params(cudaGraphNode_t node, const void** func, dim3* grid,
                   void*** args) {
  cudaKernelNodeParams p = {};
  if (cudaGraphKernelNodeGetParams(node, &p) == cudaSuccess) {
    *func = p.func;
    *grid = p.gridDim;
    *args = p.kernelParams;
    return true;
  }
  cudaGetLastError();
  const NodeParams get = node_params();
  CUDA_KERNEL_NODE_PARAMS d = {};
  if (get == nullptr || get((CUgraphNode)node, &d) != CUDA_SUCCESS) {
    return false;
  }
  *func = d.func != nullptr ? (const void*)d.func : (const void*)d.kern;
  *grid = dim3(d.gridDimX, d.gridDimY, d.gridDimZ);
  *args = d.kernelParams;
  return true;
}

template <typename T>
T arg(void** params, int i) {
  return *static_cast<const T*>(params[i]);
}

// Fill one kernel node's fields and pointers.
void read_kernel(cudaGraphNode_t node,
                 const std::unordered_map<const void*, KernelInstance>& ids,
                 int32_t* info, uint64_t* ptrs) {
  const void* func = nullptr;
  dim3 grid;
  void** a = nullptr;
  if (!kernel_params(node, &func, &grid, &a)) {
    info[T_MATCH] = -1;
    return;
  }
  info[T_BLOCKS] = (int32_t)(grid.x * grid.y * grid.z);
  const auto it = ids.find(func);
  if (it == ids.end()) return;
  const KernelInstance& inst = it->second;
  info[T_MATCH] = 1;
  info[T_KERNEL] = inst.kernel;
  info[T_FP32] = inst.fp32;
  info[T_NDIAG] = inst.n_diag;
  if (a == nullptr) return;  // arguments packed in `extra`: not read
  if (inst.kernel == 1) {    // (a, b, c, n, k, m)
    for (int i = 0; i < 3; ++i) ptrs[i] = (uint64_t)arg<const void*>(a, i);
    info[T_N] = arg<int>(a, 3);
    info[T_K] = arg<int>(a, 4);
    info[T_M] = arg<int>(a, 5);
  } else if (inst.kernel == 2) {  // (diags, out, n_out, FoldConsts)
    for (int i = 0; i < 2; ++i) ptrs[i] = (uint64_t)arg<const void*>(a, i);
    info[T_N] = arg<int>(a, 2);
    info[T_MODULUS] = (int32_t)arg<uint32_t>(a, 3);
  } else {  // (a, b3, out, b_map, pitch, box_rows, n, k, d, slice, FoldConsts)
    for (int i = 0; i < 3; ++i) ptrs[i] = (uint64_t)arg<const void*>(a, i);
    info[T_N] = arg<int>(a, 6);
    info[T_K] = arg<int>(a, 7);
    info[T_M] = arg<int>(a, 8);
    info[T_MODULUS] = (int32_t)arg<uint32_t>(a, 10);
  }
}

int read(cudaGraph_t graph, int max_nodes, int max_edges, int32_t* info,
         uint64_t* ptrs, int32_t* edges, long long* counts) {
  size_t n = 0, m = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err == cudaSuccess) {
    err = GRAPH_GET_EDGES(graph, nullptr, nullptr, nullptr, &m);
  }
  if (err != cudaSuccess) return (int)err;
  counts[0] = (long long)n;
  counts[1] = (long long)m;
  if ((long long)n > max_nodes || (long long)m > max_edges) {
    return (int)cudaErrorInvalidValue;
  }
  std::vector<cudaGraphNode_t> nodes(n), from(m), to(m);
  std::vector<cudaGraphEdgeData> data(m);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  if (err == cudaSuccess && m > 0) {
    err = GRAPH_GET_EDGES(graph, from.data(), to.data(), data.data(), &m);
  }
  if (err != cudaSuccess) return (int)err;

  // Kahn's algorithm; among the nodes that are ready, the one first in
  // cudaGraphGetNodes' order goes first.
  std::unordered_map<cudaGraphNode_t, int> index;
  for (size_t i = 0; i < n; ++i) index[nodes[i]] = (int)i;
  std::vector<std::vector<int>> out_edges(n);
  std::vector<int> indegree(n, 0);
  for (size_t e = 0; e < m; ++e) {
    out_edges[index[from[e]]].push_back((int)e);
    ++indegree[index[to[e]]];
  }
  std::priority_queue<int, std::vector<int>, std::greater<int>> ready;
  for (size_t i = 0; i < n; ++i) {
    if (indegree[i] == 0) ready.push((int)i);
  }
  std::vector<int> position(n, -1);
  int placed = 0;
  while (!ready.empty()) {
    const int i = ready.top();
    ready.pop();
    position[i] = placed++;
    for (int e : out_edges[i]) {
      const int j = index[to[e]];
      if (--indegree[j] == 0) ready.push(j);
    }
  }
  if (placed != (int)n) return (int)cudaErrorInvalidValue;  // not a DAG

  const auto ids = instances();
  for (size_t i = 0; i < n; ++i) {
    int32_t* row = info + (size_t)position[i] * NODE_INTS;
    uint64_t* prow = ptrs + (size_t)position[i] * 3;
    for (int f = 0; f < NODE_INTS; ++f) row[f] = 0;
    for (int f = 0; f < 3; ++f) prow[f] = 0;
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return (int)err;
    row[T_TYPE] = (int32_t)type;
    if (type == cudaGraphNodeTypeKernel) read_kernel(nodes[i], ids, row, prow);
  }
  for (size_t e = 0; e < m; ++e) {
    int32_t* row = edges + e * EDGE_INTS;
    row[0] = position[index[from[e]]];
    row[1] = position[index[to[e]]];
    row[2] = (int32_t)data[e].type;
    row[3] = (int32_t)data[e].from_port;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The graph's node and edge counts, into counts[0] and counts[1] (long long).
extern "C" int graph_census_size(void* graph, void* counts) {
  size_t n = 0, m = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err == cudaSuccess) err = GRAPH_GET_EDGES(g, nullptr, nullptr, nullptr, &m);
  long long* c = static_cast<long long*>(counts);
  c[0] = (long long)n;
  c[1] = (long long)m;
  return (int)err;
}

// Nodes (NODE_INTS int32 and 3 uint64 pointers each) and edges (EDGE_INTS
// int32 each) of the graph, with `device` current (the library's kernel
// handles are looked up in its context).  Room for fewer than the graph holds
// is refused with cudaErrorInvalidValue, the counts written.
extern "C" int graph_census_read(void* graph, int max_nodes, int max_edges,
                                 void* node_info, void* node_ptrs,
                                 void* edge_info, void* counts, int device) {
  return launch_on(device, [&]() {
    return (cudaError_t)read(static_cast<cudaGraph_t>(graph), max_nodes,
                             max_edges, static_cast<int32_t*>(node_info),
                             static_cast<uint64_t*>(node_ptrs),
                             static_cast<int32_t*>(edge_info),
                             static_cast<long long*>(counts));
  });
}

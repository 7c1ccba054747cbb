"""ctypes binding of the graph reader ``csrc/graph_census.cu``.

:func:`read` returns a captured CUDA graph's nodes in topological order and
its edges, from two C calls (the sizes, then everything), whatever the
graph's size: a BN254 program holds thousands of nodes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels import build

# Kernel ids of the reader -> the wrappers' kernel names.
KERNELS = {1: "limb_matmul", 2: "mont_fold", 3: "fused_ntt_tile"}
# Fields of a node row (csrc/graph_census.cu, T_*).
(T_TYPE, T_KERNEL, T_FP32, T_NDIAG, T_N, T_K, T_M, T_MODULUS, T_BLOCKS,
 T_MATCH, NODE_INTS) = range(11)
EDGE_INTS = 4
# cudaGraphNodeType names, for the census of nodes that are not kernels.
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}
# How a kernel node's function was recognised (T_MATCH).
MATCHES = {1: "host_stub", -1: "unreadable"}


@dataclasses.dataclass(frozen=True)
class Node:
    """One node of a program, as the validator sees it.  ``kernel`` is the
    wrapper name of a K1/K2/K3 node and None for any other node; ``args``
    its static arguments (the launch log's names); ``ptrs`` its operand
    addresses in the kernel's argument order."""

    kernel: str | None
    args: dict = dataclasses.field(default_factory=dict)
    ptrs: tuple = ()


@dataclasses.dataclass
class GraphCensus:
    """A graph as the reader returned it: ``nodes`` in topological order,
    ``edges`` as ``(source, destination, programmatic)`` positions in that
    order, and a summary (``stats``) for the report."""

    nodes: list
    edges: list
    stats: dict


def _node(row, ptrs) -> Node:
    kid = int(row[T_KERNEL])
    if kid == 1:
        args = {"n": int(row[T_N]), "k": int(row[T_K]), "m": int(row[T_M]),
                "fp32": bool(row[T_FP32])}
        return Node("limb_matmul", args, tuple(int(p) for p in ptrs[:3]))
    if kid == 2:
        args = {"n_out": int(row[T_N]), "n_diag": int(row[T_NDIAG]),
                "modulus": int(row[T_MODULUS]) & 0xFFFFFFFF}
        return Node("mont_fold", args, tuple(int(p) for p in ptrs[:2]))
    if kid == 3:
        args = {"n": int(row[T_N]), "k": int(row[T_K]), "d": int(row[T_M]),
                "n_diag": int(row[T_NDIAG]),
                "modulus": int(row[T_MODULUS]) & 0xFFFFFFFF,
                "fp32": bool(row[T_FP32])}
        return Node("fused_ntt_tile", args, tuple(int(p) for p in ptrs[:3]))
    return Node(None, {"type": NODE_TYPES.get(int(row[T_TYPE]),
                                              int(row[T_TYPE]))})


def summary(info: np.ndarray, edges: np.ndarray) -> dict:
    """Node counts by kernel and by node type, edge counts by type and
    source port, and how the kernel nodes were recognised."""
    kernel_nodes = info[:, T_TYPE] == 0
    stats = {"nodes": int(len(info)),
             "kernel_nodes": {name: int((info[:, T_KERNEL] == kid).sum())
                              for kid, name in KERNELS.items()}}
    stats["kernel_nodes"]["other"] = int(
        (kernel_nodes & (info[:, T_KERNEL] == 0)).sum())
    types, counts = np.unique(info[~kernel_nodes, T_TYPE], return_counts=True)
    stats["other_nodes"] = {NODE_TYPES.get(int(t), int(t)): int(c)
                            for t, c in zip(types, counts)}
    matches, counts = np.unique(info[info[:, T_MATCH] != 0, T_MATCH],
                                return_counts=True)
    stats["matched_by"] = {MATCHES.get(int(h), int(h)): int(c)
                           for h, c in zip(matches, counts)}
    full = (edges[:, 2] == 0) & (edges[:, 3] == 0)
    stats["edges"] = {"full": int(full.sum()),
                      "programmatic": int((~full).sum())}
    return stats


def read(graph: int, device: int) -> GraphCensus:
    """The nodes and edges of the CUDA graph ``graph`` (a ``cudaGraph_t`` as
    an integer, e.g. ``CUDAGraph(keep_graph=True).raw_cuda_graph()``),
    captured on CUDA device ``device``.  An edge is full when its type is
    the default and it leaves its source's default port; any other edge
    (programmatic) orders only a destination that waits for its
    predecessor's completion itself."""
    fns = build.entries()
    counts = np.zeros(2, np.int64)
    build.check(fns["graph_census_size"](graph, counts.ctypes.data),
                "graph_census_size")
    n, m = (int(c) for c in counts)
    info = np.zeros((n, NODE_INTS), np.int32)
    ptrs = np.zeros((n, 3), np.uint64)
    edges = np.zeros((m, EDGE_INTS), np.int32)
    build.check(fns["graph_census_read"](
        graph, n, m, info.ctypes.data, ptrs.ctypes.data, edges.ctypes.data,
        counts.ctypes.data, device), "graph_census_read")
    nodes = [_node(row, p) for row, p in zip(info, ptrs)]
    edge_list = [(int(s), int(d), not (t == 0 and port == 0))
                 for s, d, t, port in edges]
    return GraphCensus(nodes, edge_list, summary(info, edges))

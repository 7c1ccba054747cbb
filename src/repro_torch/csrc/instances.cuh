// The kernel instances of the library, by host stub, for the graph reader
// (graph_census.cu).  Each kernel's source lists its own instances; an entry
// names the kernel and the template arguments of the instance, so that a
// kernel node of a captured CUDA graph can be told apart from PyTorch's
// kernels and read back as the call that the launch log recorded.
#pragma once

struct KernelInstance {
  const void* stub;  // the host stub a launch passes (&kernel<...>)
  int kernel;        // 1 K1 limb_matmul, 2 K2 mont_fold, 3 K3 fused_ntt_tile
  int fp32;          // K1, K3: the fp32_mantissa accumulator
  int n_diag;        // K2, K3
  int variant;       // K1: 8-byte B words; K3: the bulk-copy variant
};

// Room for every instance of one kernel.
constexpr int MAX_INSTANCES = 32;

// Each writes its kernel's instances to `out` and returns their number.
int limb_matmul_instances(KernelInstance* out);
int mont_fold_instances(KernelInstance* out);
int fused_ntt_tile_instances(KernelInstance* out);

// K2 — mont_fold: int32 (..., n_diag) limb-weight diagonals -> residues mod m
// (..., ), Σ_k diag_k · 2**(8k) mod m, for a modulus 1 < m < 2**31.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mont_fold/kernel.py::mont_fold_pallas
// (_fold_kernel, ops.py::mont_fold and the window adapter
// ops.py::mont_fold_window_fn).  It runs once per staging pass in eager mode
// and once per κ-window in lazy mode, where the diagonals are κ-pass sums up
// to ±(2**31 − 1).
//
// What bounds it on an H100.  Neither bytes nor operations: at (8, 256, 5)
// it reads 41 KB and writes 8 KB (15 ns at 3.35 TB/s) and does about 2,000
// outputs × 5 diagonals × 10 integer operations.  What is left is the launch,
// the latency of one load from L2 and one thread's dependency chain.
//
// Design.  One thread per output.  The first port folded by Horner, a chain
// of ~27 dependent instructions per diagonal, and its time grew with n_diag
// (1.5–1.7 µs, 1.75–1.97× an empty kernel's, NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py).  fold.cuh now sums independent terms with per-modulus
// constants that the C entry computes on the host, so the chain is a few
// tens of instructions at any n_diag.  A thread issues all n_diag loads of
// its diagonals (contiguous: a warp reads 32 · n_diag words) before its
// first multiply.  Blocks of THREADS = 128 threads spread the replay's
// 512–4,096 outputs over 4–32 SMs (the first port's 256-thread blocks used
// 2–16); 64 and 256 threads read no faster in a sweep on the card.
//
// Programmatic dependent launch (PDL).  On the replay K2 follows K1 on the
// same stream.  K2 is launched with programmatic stream serialization, and
// K1 (limb_matmul.cu) triggers its dependents once each of its blocks has
// issued its loads, so K2's blocks are scheduled and do their index
// arithmetic while K1 runs.  Each K2 thread then executes
// griddepcontrol.wait before its first read of the diagonals.  That waits
// until the preceding grid has completed and its stores are visible,
// wherever K1 triggers, so the ordering, and the correctness, do not depend
// on the trigger.  PDL stays because the pass spans of chip_smoke.py show
// it hiding part of K2 (PERF.md).  A predecessor that never
// triggers (PyTorch's add kernels before the lazy window fold, another K2)
// triggers implicitly when it completes, and K2 then runs as an ordinary
// launch.  Resources: K1 has 56–320 blocks of 128 threads (128 registers a
// thread, 1 KB of shared memory: four blocks an SM) at the replay's shapes,
// and K2 4–32 blocks of THREADS (at most 18 registers), which the 132 SMs
// hold together.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"
#include "instances.cuh"
#include "launch.cuh"

namespace {

constexpr int THREADS = 128;

template <int NDIAG>
__global__ void __launch_bounds__(THREADS)
mont_fold_kernel(const int32_t* __restrict__ diags, uint32_t* __restrict__ out,
                 int n_out, const FoldConsts<NDIAG> c) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  const int32_t* p = diags + (size_t)i * NDIAG;
  // The diagonals are the preceding kernel's output: wait for it (a no-op
  // when the launch had no programmatic predecessor).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  int32_t d[NDIAG];
#pragma unroll
  for (int k = 0; k < NDIAG; ++k) d[k] = p[k];
  out[i] = fold_diagonals<NDIAG>(d, c);
}

int blocks_of(int n_out) { return (n_out + THREADS - 1) / THREADS; }

template <int NDIAG>
cudaError_t launch(const int32_t* d, uint32_t* o, int n_out, uint32_t m,
                   cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_of(n_out));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, mont_fold_kernel<NDIAG>, d, o, n_out,
                            make_fold_consts<NDIAG>(m));
}

template <int NDIAG>
void list_instances(KernelInstance* out) {
  out[NDIAG - 1] = {(const void*)mont_fold_kernel<NDIAG>, 2, 0, NDIAG, 0};
  if constexpr (NDIAG < 8) list_instances<NDIAG + 1>(out);
}

}  // namespace

int mont_fold_instances(KernelInstance* out) {
  list_instances<1>(out);
  return 8;
}

// Blocks in the grid of one launch for n_out outputs.
extern "C" int mont_fold_blocks(int n_out) { return blocks_of(n_out); }

// n_diag in 1..8 (5 for Dilithium, 7 for BN254); anything else is refused
// with cudaErrorInvalidValue before any launch.
extern "C" int mont_fold_launch(const void* diags, void* out, int n_out,
                                int n_diag, int modulus, int device,
                                void* stream) {
  const int32_t* d = static_cast<const int32_t*>(diags);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t m = (uint32_t)modulus;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_on(device, [&]() {
    switch (n_diag) {
      case 1: return launch<1>(d, o, n_out, m, s);
      case 2: return launch<2>(d, o, n_out, m, s);
      case 3: return launch<3>(d, o, n_out, m, s);
      case 4: return launch<4>(d, o, n_out, m, s);
      case 5: return launch<5>(d, o, n_out, m, s);
      case 6: return launch<6>(d, o, n_out, m, s);
      case 7: return launch<7>(d, o, n_out, m, s);
      case 8: return launch<8>(d, o, n_out, m, s);
      default: return cudaErrorInvalidValue;
    }
  });
}

// K2 — mont_fold: int32 (..., n_diag) limb-weight diagonals -> residues mod m
// (..., ), Σ_k diag_k · 2**(8k) mod m, for a modulus m < 2**31.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mont_fold/kernel.py::mont_fold_pallas
// (_fold_kernel, ops.py::mont_fold and the window adapter
// ops.py::mont_fold_window_fn).  It runs once per staging pass in eager mode
// and once per κ-window in lazy mode, where the diagonals are κ-pass sums up
// to ±(2**31 − 1).
//
// What bounds it on an H100.  It is pure integer ALU work on a few tens of
// KB: at (8, 256, 5) it reads 41 KB and writes 8 KB (15 ns at 3.35 TB/s) and
// does about 2,000 outputs × 5 diagonals × ~45 operations.  So the launch is
// the cost, not the bytes or the arithmetic.
//
// Design.  One thread per output.  n_diag is a template parameter, so the
// Horner loop of fold.cuh (shared with K3's epilogue) unrolls completely.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"
#include "launch.cuh"

namespace {

constexpr int THREADS = 256;

template <int NDIAG>
__global__ void __launch_bounds__(THREADS)
mont_fold_kernel(const int32_t* __restrict__ diags, uint32_t* __restrict__ out,
                 int n_out, uint32_t m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  out[i] = fold_diagonals<NDIAG>(diags + (size_t)i * NDIAG, m);
}

template <int NDIAG>
void launch(const int32_t* d, uint32_t* o, int n_out, uint32_t m,
            cudaStream_t s) {
  const int grid = (n_out + THREADS - 1) / THREADS;
  mont_fold_kernel<NDIAG><<<grid, THREADS, 0, s>>>(d, o, n_out, m);
}

}  // namespace

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
      case 1: launch<1>(d, o, n_out, m, s); break;
      case 2: launch<2>(d, o, n_out, m, s); break;
      case 3: launch<3>(d, o, n_out, m, s); break;
      case 4: launch<4>(d, o, n_out, m, s); break;
      case 5: launch<5>(d, o, n_out, m, s); break;
      case 6: launch<6>(d, o, n_out, m, s); break;
      case 7: launch<7>(d, o, n_out, m, s); break;
      case 8: launch<8>(d, o, n_out, m, s); break;
      default: return cudaErrorInvalidValue;
    }
    return cudaSuccess;
  });
}

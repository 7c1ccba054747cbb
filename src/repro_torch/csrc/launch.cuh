// The launch step shared by every C entry of the kernel library (K1, K2, K3).
//
// The Python wrappers pass the device index of the operands and PyTorch's
// current stream on that device.  A kernel launch goes to the calling
// thread's current device, so the entry makes `device` current only when it
// is not already, and restores the caller's device afterwards: the
// co-scheduler may put Dilithium and BN254 on different cards of one process.
#pragma once

#include <cuda_runtime.h>

// Runs `launch` with `device` current.  `launch` enqueues the kernel and
// returns cudaSuccess, or an error code without launching anything.  The
// result is the first error of: the device switch, `launch` itself, its
// cudaGetLastError() (a refused launch is reported only there), the switch
// back.
template <typename Launch>
inline int launch_on(int device, Launch&& launch) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch();
  const cudaError_t last = cudaGetLastError();
  if (err == cudaSuccess) err = last;
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// An empty kernel: the launch floor of the card.  It does nothing, so its
// device time, read with the profiler method that times K1–K3, is what any
// launch costs there.  No TPU kernel corresponds to it and no path of the
// port launches it; only the measurement in chip_smoke.py does.
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One block of one thread on `stream`.
extern "C" int empty_launch(int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_on(device, [&]() {
    empty_kernel<<<1, 1, 0, s>>>();
    return cudaSuccess;
  });
}

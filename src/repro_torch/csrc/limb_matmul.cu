// K1 — limb_matmul: (N, K) u8 × (K, M) s8 -> (N, M) int32, one staging pass
// of the matrix-form NTT.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/limb_matmul/kernel.py::limb_matmul_pallas
// (_matmul_kernel, the padding wrapper ops.py::limb_matmul and the adapter
// kernels/__init__.py::pallas_tile_fn).
//
// What bounds it on an H100.  On the replay path N is the launch height
// (n_c = 8 rows) against a K×M int8 twiddle operand, e.g. (8, 513, 1280) for
// a Dilithium d=256 pass: 4 KB of A, 657 KB of B, 41 KB of C, about 0.70 MB,
// or 0.21 µs at 3.35 TB/s, against 10.5 M int8 operations (nanoseconds on the
// tensor cores).  The kernel is bound by reading B once, and in practice by
// the launch itself.
//
// Design.  A block owns 8 rows × 32 columns of C.  It stages the 8 A rows of
// a K chunk in shared memory, transposed so that the 8 row bytes of one k
// are one 8-byte word.  Each warp takes one B row at a time (32 consecutive
// bytes, one sector) and every lane multiplies its column's B byte by the 8
// A bytes, keeping 8 partial sums in registers.  The 8 warps of the block
// split K (k = warp, warp + 8, ...), so each B byte is read exactly once,
// and a shared-memory reduction over the warps writes C.  M = 1280 gives 40
// blocks, M = 2560 80.  Ragged N, K and M are masked in the kernel (K = 513
// is odd); nothing is padded.
//
// The two accumulator models (int32 wrap, fp32 FFMA) are in accum.cuh,
// shared with K3.
#include <cuda_runtime.h>
#include <stdint.h>

#include "accum.cuh"

namespace {

constexpr int ROWS = 8;     // C rows per block (the replay's n_c)
constexpr int COLS = 32;    // C columns per block: one per lane
constexpr int WARPS = 8;    // warps per block, splitting K
constexpr int KC = 2048;    // K chunk staged in shared memory

template <typename Acc>
__global__ void __launch_bounds__(ROWS * COLS)
limb_matmul_kernel(const uint8_t* __restrict__ a, const int8_t* __restrict__ b,
                   int32_t* __restrict__ c, int n, int k, int m) {
  static_assert(ROWS * COLS == WARPS * 32, "one thread per C element");
  __shared__ __align__(8) uint8_t sa[KC][ROWS];
  __shared__ Acc red[WARPS][ROWS][COLS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * COLS + lane;
  const int row0 = blockIdx.y * ROWS;

  Acc acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = Acc(0);

  for (int k0 = 0; k0 < k; k0 += KC) {
    const int kc = min(KC, k - k0);
    // Stage A[row0:row0+8, k0:k0+kc], reading each row contiguously.
    for (int i = threadIdx.x; i < ROWS * kc; i += blockDim.x) {
      const int r = i / kc;
      const int kk = i - r * kc;
      const int row = row0 + r;
      sa[kk][r] = row < n ? a[(size_t)row * k + k0 + kk] : 0;
    }
    __syncthreads();
    if (col < m) {
      const int8_t* bp = b + (size_t)k0 * m + col;
      for (int kk = warp; kk < kc; kk += WARPS) {
        const int32_t w = bp[(size_t)kk * m];
        const uint2 av = *reinterpret_cast<const uint2*>(sa[kk]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          mac(acc[r], (av.x >> (8 * r)) & 0xFFu, w);
          mac(acc[r + 4], (av.y >> (8 * r)) & 0xFFu, w);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  // Thread (warp, lane) now owns C[row0 + warp, col].
  Acc s = Acc(0);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w][warp][lane];
  const int row = row0 + warp;
  if (row < n && col < m) c[(size_t)row * m + col] = to_int32(s);
}

}  // namespace

extern "C" int limb_matmul_launch(const void* a, const void* b, void* c,
                                  int n, int k, int m, int fp32,
                                  void* stream) {
  const dim3 grid((m + COLS - 1) / COLS, (n + ROWS - 1) / ROWS);
  const dim3 block(ROWS * COLS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  int32_t* pc = static_cast<int32_t*>(c);
  if (fp32) {
    limb_matmul_kernel<float><<<grid, block, 0, s>>>(pa, pb, pc, n, k, m);
  } else {
    limb_matmul_kernel<uint32_t><<<grid, block, 0, s>>>(pa, pb, pc, n, k, m);
  }
  return (int)cudaGetLastError();
}

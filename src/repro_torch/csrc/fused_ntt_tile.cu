// K3 — fused_ntt_tile: (N, K) u8 × (K, D, n_diag) s8 -> (N, D) residues mod
// m, one staging pass of the matrix-form NTT with the fold of its limb-weight
// diagonals as the epilogue.  The int32 diagonals never reach device memory.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_ntt_tile/kernel.py::fused_ntt_tile_pallas
// (_fused_kernel, the padding wrapper ops.py::fused_ntt_tile and the adapters
// kernels/__init__.py::fused_operand_3d and pallas_fused_transform).  It is
// K1's GEMM and K2's fold in one launch: the single-tenant fused-transform
// path, not the multi-tenant replay.
//
// What bounds it on an H100.  The twiddle operand: at (128, 768, 256, 5), an
// ML-DSA d = 256 transform in one int32 pass, it reads 98 KB of A and 983 KB
// of B and writes 131 KB, about 1.2 MB or 0.36 µs at 3.35 TB/s, against
// 0.25 G int8 operations (0.13 µs on the tensor cores) and 33 K folds.  At
// the largest fused plan, Dilithium d = 2048 at 8 rows, B is 63 MB (19 µs).
// The unfused pair K1 + K2 also writes and reads back the N·D·n_diag int32
// diagonals (655 KB at the first shape).
//
// Design.  As K1, a block owns 8 rows × 32 coefficients and its 8 warps split
// K (k = warp, warp + 8, ...), so each B byte is read once per row block.
// Each lane owns one coefficient j and keeps 8 × NDIAG partial sums in
// registers; for each k it reads the NDIAG adjacent bytes b3[k, j, :], so a
// warp reads 32·NDIAG contiguous bytes, and a block boundary always falls
// between coefficients.  A is staged in shared memory, transposed, exactly
// as in K1.  The sum over the warps goes through an 8 KB shared buffer one
// diagonal per round (a buffer for all of them would be 57 KB at NDIAG = 7,
// over the 48 KB static limit).  The thread that owns C[row, j] then holds
// its NDIAG sums, casts them to int32 (accum.cuh) and folds them with K2's
// Horner loop (fold.cuh).  Ragged N, K and D are masked; nothing is padded.
// The Pallas wrapper pads with zeros, which adds nothing to any sum, so the
// bits are the same.
#include <cuda_runtime.h>
#include <stdint.h>

#include "accum.cuh"
#include "fold.cuh"
#include "launch.cuh"

namespace {

constexpr int ROWS = 8;     // output rows per block
constexpr int COLS = 32;    // coefficients per block: one per lane
constexpr int WARPS = 8;    // warps per block, splitting K
constexpr int KC = 2048;    // K chunk staged in shared memory

template <typename Acc, int NDIAG>
__global__ void __launch_bounds__(ROWS * COLS)
fused_ntt_tile_kernel(const uint8_t* __restrict__ a,
                      const int8_t* __restrict__ b3, int32_t* __restrict__ out,
                      int n, int k, int d, uint32_t m) {
  static_assert(ROWS * COLS == WARPS * 32, "one thread per output");
  __shared__ __align__(8) uint8_t sa[KC][ROWS];
  __shared__ Acc red[WARPS][ROWS][COLS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * COLS + lane;
  const int row0 = blockIdx.y * ROWS;
  const size_t b_row = (size_t)d * NDIAG;   // bytes of one k row of b3

  Acc acc[ROWS][NDIAG];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int q = 0; q < NDIAG; ++q) acc[r][q] = Acc(0);
  }

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
    if (col < d) {
      const int8_t* bp = b3 + (size_t)k0 * b_row + (size_t)col * NDIAG;
#pragma unroll 4
      for (int kk = warp; kk < kc; kk += WARPS) {
        const int8_t* bk = bp + (size_t)kk * b_row;
        int32_t w[NDIAG];
#pragma unroll
        for (int q = 0; q < NDIAG; ++q) w[q] = bk[q];
        const uint2 av = *reinterpret_cast<const uint2*>(sa[kk]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t lo = (av.x >> (8 * r)) & 0xFFu;
          const uint32_t hi = (av.y >> (8 * r)) & 0xFFu;
#pragma unroll
          for (int q = 0; q < NDIAG; ++q) {
            mac(acc[r][q], lo, w[q]);
            mac(acc[r + 4][q], hi, w[q]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Sum over the warps, one diagonal per round.  Thread (warp, lane) owns
  // out[row0 + warp, col] and collects its NDIAG diagonals.
  int32_t diag[NDIAG];
#pragma unroll
  for (int q = 0; q < NDIAG; ++q) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) red[warp][r][lane] = acc[r][q];
    __syncthreads();
    Acc s = Acc(0);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][warp][lane];
    diag[q] = to_int32(s);
    __syncthreads();
  }
  const int row = row0 + warp;
  if (row < n && col < d) {
    out[(size_t)row * d + col] = (int32_t)fold_diagonals<NDIAG>(diag, m);
  }
}

template <int NDIAG>
void launch(const uint8_t* a, const int8_t* b3, int32_t* out, int n, int k,
            int d, uint32_t m, int fp32, cudaStream_t s) {
  const dim3 grid((d + COLS - 1) / COLS, (n + ROWS - 1) / ROWS);
  const dim3 block(ROWS * COLS);
  if (fp32) {
    fused_ntt_tile_kernel<float, NDIAG><<<grid, block, 0, s>>>(
        a, b3, out, n, k, d, m);
  } else {
    fused_ntt_tile_kernel<uint32_t, NDIAG><<<grid, block, 0, s>>>(
        a, b3, out, n, k, d, m);
  }
}

}  // namespace

// n_diag in 1..8 (5 for Dilithium, 7 for BN254); anything else is refused
// with cudaErrorInvalidValue before any launch.  The output holds uint32
// residues < m < 2**31 in int32 words.
extern "C" int fused_ntt_tile_launch(const void* a, const void* b3, void* out,
                                     int n, int k, int d, int n_diag,
                                     int modulus, int fp32, int device,
                                     void* stream) {
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b3);
  int32_t* po = static_cast<int32_t*>(out);
  const uint32_t m = (uint32_t)modulus;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_on(device, [&]() {
    switch (n_diag) {
      case 1: launch<1>(pa, pb, po, n, k, d, m, fp32, s); break;
      case 2: launch<2>(pa, pb, po, n, k, d, m, fp32, s); break;
      case 3: launch<3>(pa, pb, po, n, k, d, m, fp32, s); break;
      case 4: launch<4>(pa, pb, po, n, k, d, m, fp32, s); break;
      case 5: launch<5>(pa, pb, po, n, k, d, m, fp32, s); break;
      case 6: launch<6>(pa, pb, po, n, k, d, m, fp32, s); break;
      case 7: launch<7>(pa, pb, po, n, k, d, m, fp32, s); break;
      case 8: launch<8>(pa, pb, po, n, k, d, m, fp32, s); break;
      default: return cudaErrorInvalidValue;
    }
    return cudaSuccess;
  });
}

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
// or 0.21 µs at 3.35 TB/s, against 10.5 M int8 operations.  B is the same
// tensor for every dispatch of a plan, so it normally sits in L2.  Neither
// bytes nor operations bound it: the launch and the latency of its loads
// to L2 do.
//
// The first design lost on both: a block owned 8 rows × 32 columns and its
// 8 warps split K as k = warp, warp + 8, ..., so at K = 513 each warp made
// 65 trips, each waiting on one byte load of B, and M = 1280 gave a grid of
// 40 blocks (M = 448 gave 14) for 132 SMs.  It took 11.3 µs at
// (8, 513, 1280), 54× its byte bound.
//
// Design.  A block owns 8 rows × 8 columns of C: M = 1280 gives 160 blocks,
// M = 2560 320 and M = 448 56.  Its 128 threads split K, thread t owning
// k = t, t + 128, ...  For each of its k a thread loads the block's 8 B
// bytes as one 8-byte word (eight masked byte loads when M is not a multiple
// of 8 or B is not 8-byte aligned) and the 8 A bytes of the block's rows.
// All loads of U = 5 k per thread are issued before the first multiply, so
// a thread waits for one round trip, not one per k; for K ≤ 640, every
// replay pass, that is its whole K range.  Each k has a single owner, so A is
// read once per block straight into registers: the old design staged it
// transposed in shared memory because 32 lanes shared each k, and here
// nothing shares it, so there is no staging and no barrier before the
// multiplies.  Limbs and digits are widened once per k (accum.cuh), then a
// thread accumulates the 64 sums of its 8 × 8 tile in registers.  A
// reduce-scatter over the warp (five shuffle rounds, each halving what a
// lane holds) leaves each lane two sums over the warp; each lane keeps its
// tile in its own order of rows and columns (see halve), so a round is one
// shuffle and one add per sum, with no choice of what to send.  A 1 KB
// shared buffer adds the 4 warps, and 64 threads write C once.  Ragged N, K
// and M are masked in the kernel (K = 513 is odd); nothing is padded.
//
// No tensor cores.  The replay's fp32_mantissa model must stay a float32
// FFMA sum, which no integer MMA computes, and at N = 8 the multiply-adds
// are not what bounds the kernel (10.5 M at (8, 513, 2560) are about 0.4 µs
// of CUDA-core work spread over the card).
//
// The two accumulator models (int32 wrap, fp32 FFMA) are in accum.cuh,
// shared with K3.
//
// Each block triggers its programmatic dependents once it has issued its
// first loads (griddepcontrol.launch_dependents), so that K2, launched after
// it with programmatic stream serialization, is scheduled while K1's
// multiplies and reduction run.  K2 waits for K1's completion and stores
// before it reads (mont_fold.cu), so where the trigger sits changes only
// when K2's blocks arrive, never what they read.  A trigger at block start
// let K2's blocks sit on the SMs through K1's load latency and made the pass
// slower at (8, 513, 2560); one after the multiplies hid less of K2's
// launch (a sweep of the three places on the card).
#include <cuda_runtime.h>
#include <stdint.h>

#include "accum.cuh"
#include "instances.cuh"
#include "launch.cuh"

namespace {

constexpr int ROWS = 8;                 // C rows per block (the replay's n_c)
constexpr int COLS = 8;                 // C columns per block: 8 bytes of a B row
constexpr int TILE = ROWS * COLS;       // sums per thread
constexpr int THREADS = 128;            // threads per block, splitting K
constexpr int WARPS = THREADS / 32;
constexpr int U = 5;                    // k per thread with loads in flight together
constexpr unsigned FULL = 0xffffffffu;

// The block's 8 columns of B row kk as one word, byte c = column col0 + c.
// VEC: one 8-byte load (M % 8 == 0 and B 8-byte aligned).  Otherwise eight
// byte loads, the columns past M masked to 0.
template <bool VEC>
__device__ __forceinline__ uint2 load_b(const int8_t* __restrict__ b, int kk,
                                        int m, int col0) {
  const int8_t* p = b + (size_t)kk * m + col0;
  if (VEC) return *reinterpret_cast<const uint2*>(p);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    if (col0 + c < m) w[c / 4] |= (uint32_t)(uint8_t)p[c] << (8 * (c % 4));
  }
  return make_uint2(w[0], w[1]);
}

// One k of the 8 × 8 tile: acc[r·COLS + c] += a[r] · b[c], where av and bw
// already hold the lane's permutation of rows and columns (see halve).
template <typename Acc>
__device__ __forceinline__ void mac_tile(Acc (&acc)[TILE],
                                         const uint32_t (&av)[ROWS], uint2 bw) {
  Acc bv[2][4];
  widen_s8x4(bv[0], bw.x);
  widen_s8x4(bv[1], bw.y);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    Acc ar;
    widen_u8(ar, av[r]);
#pragma unroll
    for (int c = 0; c < COLS; ++c) mac(acc[r * COLS + c], ar, bv[c / 4][c % 4]);
  }
}

// One round of the warp's reduce-scatter: v[i] += partner's v[i + H] for
// i < H, the partner being lane ^ O.  Lane L keeps tile element e at
// position e ^ 2L (row r in row slot r ^ (L >> 2), column c in column slot
// c ^ 2(L & 3)), so the element a lane keeps at position i is the one its
// partner holds at i + H, and no lane has to choose what to send.  After the
// rounds (H, O) = (32, 16), (16, 8), (8, 4), (4, 2), (2, 1), v[0] and v[1]
// of lane L are elements 2L and 2L + 1 summed over the warp.
template <int H, int O, typename Acc>
__device__ __forceinline__ void halve(Acc (&v)[TILE]) {
#pragma unroll
  for (int i = 0; i < H; ++i) v[i] += __shfl_xor_sync(FULL, v[i + H], O);
}

// The lane's column permutation of a B word: column slot c holds column
// c ^ 2(L & 3), so lane bit 1 swaps the two 4-byte halves and lane bit 0
// the 2-byte halves of each.
__device__ __forceinline__ uint2 permute_columns(uint2 w, int lane) {
  const uint32_t sel = lane & 1 ? 0x1032u : 0x3210u;
  const uint32_t x = lane & 2 ? w.y : w.x;
  const uint32_t y = lane & 2 ? w.x : w.y;
  return make_uint2(__byte_perm(x, 0u, sel), __byte_perm(y, 0u, sel));
}

template <typename Acc, bool VEC>
__global__ void __launch_bounds__(THREADS)
limb_matmul_kernel(const uint8_t* __restrict__ a, const int8_t* __restrict__ b,
                   int32_t* __restrict__ c, int n, int k, int m) {
  __shared__ Acc red[WARPS][TILE];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col0 = blockIdx.x * COLS;
  const int row0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, n - row0);   // rows of A in this block
  const int row_perm = lane >> 2;          // row slot r holds row r ^ row_perm

  Acc acc[TILE];
#pragma unroll
  for (int i = 0; i < TILE; ++i) acc[i] = Acc(0);

  for (int k0 = 0; k0 < k; k0 += U * THREADS) {
    // Issue every load of this chunk first: U words of B, U × 8 bytes of A.
    uint2 bw[U];
    uint32_t av[U][ROWS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k0 + u * THREADS + tid;
      const bool live = kk < k;
      bw[u] = live ? load_b<VEC>(b, kk, m, col0) : make_uint2(0u, 0u);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = r ^ row_perm;
        av[u][r] = live && row < rows ? a[(size_t)(row0 + row) * k + kk] : 0u;
      }
    }
    // The first loads are in flight: let a programmatic dependent (K2)
    // be scheduled.  It still waits for this grid to complete.
    if (k0 == 0) asm volatile("griddepcontrol.launch_dependents;");
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u * THREADS + tid < k) {
        mac_tile(acc, av[u], permute_columns(bw[u], lane));
      }
    }
  }

  halve<32, 16>(acc);
  halve<16, 8>(acc);
  halve<8, 4>(acc);
  halve<4, 2>(acc);
  halve<2, 1>(acc);
  red[warp][2 * lane] = acc[0];
  red[warp][2 * lane + 1] = acc[1];
  __syncthreads();
  if (tid < TILE) {
    Acc s = red[0][tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w][tid];
    const int row = row0 + tid / COLS;
    const int col = col0 + tid % COLS;
    if (row < n && col < m) c[(size_t)row * m + col] = to_int32(s);
  }
}

dim3 grid_of(int n, int m) {
  return dim3((m + COLS - 1) / COLS, (n + ROWS - 1) / ROWS);
}

template <typename Acc>
void launch(const uint8_t* a, const int8_t* b, int32_t* c, int n, int k,
            int m, cudaStream_t s) {
  const bool vec = m % COLS == 0 && reinterpret_cast<uintptr_t>(b) % 8 == 0;
  if (vec) {
    limb_matmul_kernel<Acc, true><<<grid_of(n, m), THREADS, 0, s>>>(a, b, c, n, k, m);
  } else {
    limb_matmul_kernel<Acc, false><<<grid_of(n, m), THREADS, 0, s>>>(a, b, c, n, k, m);
  }
}

}  // namespace

int limb_matmul_instances(KernelInstance* out) {
  out[0] = {(const void*)limb_matmul_kernel<uint32_t, false>, 1, 0, 0, 0};
  out[1] = {(const void*)limb_matmul_kernel<uint32_t, true>, 1, 0, 0, 1};
  out[2] = {(const void*)limb_matmul_kernel<float, false>, 1, 1, 0, 0};
  out[3] = {(const void*)limb_matmul_kernel<float, true>, 1, 1, 0, 1};
  return 4;
}

// Blocks in the grid of one launch at (n, ·, m).
extern "C" int limb_matmul_blocks(int n, int m) {
  const dim3 g = grid_of(n, m);
  return (int)(g.x * g.y);
}

extern "C" int limb_matmul_launch(const void* a, const void* b, void* c,
                                  int n, int k, int m, int fp32, int device,
                                  void* stream) {
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  int32_t* pc = static_cast<int32_t*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_on(device, [&]() {
    if (fp32) {
      launch<float>(pa, pb, pc, n, k, m, s);
    } else {
      launch<uint32_t>(pa, pb, pc, n, k, m, s);
    }
    return cudaSuccess;
  });
}

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
// What bounds it on an H100.  Two regimes.
// - Few rows, a large operand: Dilithium d = 2048 at 8 rows reads a 63 MB
//   twiddle operand B, more than the 50 MB L2, so K3 streams it from HBM and
//   the bytes bound it (18.8 µs at 3.35 TB/s).  Holding that rate needs
//   megabytes of B in flight across the card, tens of KB per SM.
// - 128 rows at d = 256 (98 KB of A, 0.66–0.98 MB of B): each B byte serves
//   8 rows per block and is read once per row block, so the 84–126 M
//   multiply-adds bound it: 2.5–3.8 µs as FFMA on the CUDA cores, half that
//   as dp4a.  Below that sits a fixed cost per block (staging, the cluster
//   reduction, the fold), about 3 µs for a block alone.
// The first port gave a block 8 rows × 32 coefficients and let its
// 8 warps walk K one dependent byte load at a time: 64 blocks at d = 2048,
// about 5 KB in flight per SM, 0.270–0.275 ms (14.6× the bound, 3.3× the
// unfused K1 + K2 pair) and 18.6–23.4 µs at d = 256 (NVIDIA H100 80GB HBM3,
// 700 W, chip_smoke.py).
//
// Design.
// - A block owns a tile of 8 rows × CC = 32 whole coefficients, i.e. the
//   CC · NDIAG contiguous bytes of each B row that hold every diagonal of its
//   coefficients, so the fold stays the block's epilogue.
// - K is split over a thread-block cluster of c ≤ 8 blocks (the portable
//   size), one contiguous K slice each: this takes the place of the Pallas
//   kernel's sequential k grid axis.  c doubles while the grid has fewer
//   blocks than half the SMs or a slice is longer than 2048, as long as
//   every rank keeps two slabs: 256 blocks (64 tiles, c = 4) at
//   (8, 6144, 2048), 32 (8 tiles, c = 4) at (8, 513, 256), and no split at
//   128 rows, d = 256 (128 tiles).
// - One producer warp and 32 · NDIAG consumer threads share a ring of STAGES
//   slots in dynamic shared memory.  A slot holds KT = 64 rows of B and the
//   slab's 8 × 64 limbs of A.  The producer fills a slot once every consumer
//   has arrived on its "empty" mbarrier: its lanes store A (loaded while the
//   slot before waited), then, in the bulk variant (d · NDIAG a multiple of
//   16 and B 16-byte aligned), lane 0 starts one TMA box (cp.async.bulk.
//   tensor over B seen as a (K, d · NDIAG / 4) tensor of words, zeros past
//   its edges) that completes the slot's "full" mbarrier.  Otherwise
//   (350-byte rows, a B off the 16-byte grid) the lanes load B byte by byte.
//   The producer runs STAGES − 1 slabs ahead of the consumers.
// - The inner loop reads only shared memory.  A consumer owns 8 rows × 4
//   columns.  int32_native: it takes the k quads q ≡ g (mod 4), transposes
//   the 4 × 4 bytes of B (8 byte permutes) and adds 32 dp4a (u8 × s8, four
//   products a step, wrapping in int32 as IMAD would), with A stored four k
//   to a word.  fp32_mantissa: it takes the k ≡ g (mod 4) and adds 32 FFMA
//   (accum.cuh's exact float widening, A stored as floats): a float32 FFMA
//   sum, no tensor cores, no TF32.  Inside the 2**24 window every order of
//   summation gives the same bits, so the split order is free there.
// - Epilogue: the 4 partial tiles of a block go through the freed ring and
//   are added; rank r of the cluster then sums the outputs o ≡ r (mod c)
//   over the ranks in fixed rank order through distributed shared memory,
//   casts each diagonal with to_int32 and folds it with K2's fold
//   (fold.cuh: independent terms, constants computed on the host by the C
//   entry).
// Ragged N, K and D are masked (A is zero past N and K, B past D); nothing is
// padded (the Pallas wrapper's zero padding adds nothing to any sum, so the
// bits are the same).  Times: PERF.md.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "accum.cuh"
#include "fold.cuh"
#include "instances.cuh"
#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int ROWS = 8;          // output rows per block
constexpr int CC = 32;           // coefficients per block
constexpr int KT = 64;           // B rows per ring slab
constexpr int STAGES = 4;        // slabs in the ring
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int MAX_SLICE = 2048;  // K per cluster rank, if c allows
constexpr int BARS = 128;        // bytes for the 2·STAGES mbarriers

// The block's work split for one accumulator model.  A consumer thread owns
// 8 rows × TC = 4 columns.  int32 (INT32): it takes the k quads
// q ≡ g (mod KG = 4) and sums them with dp4a, four u8 × s8 products a step,
// wrapping in int32.  fp32: it takes the k ≡ g (mod 4), in float FFMA.
// Either way 32 · NDIAG consumer threads.  A ring slot holds KT rows of B, then the
// slab's limbs of A: packed, four k of a row to a word, for dp4a; floats, 8
// per k, for FFMA.
template <int NDIAG, bool INT32>
struct Tile {
  static constexpr int W = CC * NDIAG;       // bytes of a B row in the tile
  static constexpr int TC = 4;               // columns per thread
  static constexpr int KG = 4;               // k groups
  static constexpr int NW = W / TC;          // column words per B row
  static constexpr int THREADS = NW * KG;    // consumers
  static constexpr int A_SLAB = KT * ROWS * (INT32 ? 1 : 4);
  static constexpr int SLAB = KT * W + A_SLAB;
  static constexpr int RING = STAGES * SLAB;
  // Outputs a thread folds at most (a cluster of one).
  static constexpr int MAX_OUT = (ROWS * CC + THREADS + 31) / (THREADS + 32);
  // The KG partial tiles of the epilogue reuse the ring.
  static_assert(KG * ROWS * W * 4 <= RING, "partials fit in the ring");
  static_assert(W % 16 == 0, "a tile row is whole 16-byte pieces");
  static_assert(THREADS % 32 == 0, "consumers are whole warps");
  // The producer's lanes stage A_LANE limbs of A each per slab.
  static constexpr int A_LANE = KT * ROWS / 32;
  static_assert(KT % (4 * KG) == 0 && A_LANE % 4 == 0, "slabs split evenly");
  static_assert(SLAB % 128 == 0, "every slot is aligned for TMA");
};
static_assert(2 * STAGES * 8 <= BARS, "mbarriers fit");

struct Plan {
  int ctiles, rtiles, cluster, slice;
};

// Half the SMs of `device`: the grid the cluster rule aims to fill (66 on an
// H100 SXM).  Read once per device.
cudaError_t target_blocks(int device, int* target) {
  static int cached[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    int sms = 0;
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cached[device] = sms / 2 > 0 ? sms / 2 : 1;
  }
  *target = cached[device];
  return cudaSuccess;
}

// The cluster size c doubles (up to 8) while the grid has fewer blocks than
// `target` or a rank's K slice is longer than MAX_SLICE, as long as every
// rank keeps two slabs.  Splitting costs the cluster reduction, so 128
// tiles (128 rows, d = 256) are not split (PERF.md).
Plan plan_of(int n, int k, int d, int target) {
  Plan p;
  p.ctiles = (d + CC - 1) / CC;
  p.rtiles = (n + ROWS - 1) / ROWS;
  const long tiles = (long)p.ctiles * p.rtiles;
  int c = 1;
  while (c < MAX_CLUSTER &&
         (tiles * c < target || (k + c - 1) / c > MAX_SLICE) &&
         k >= 4 * c * KT) {
    c *= 2;
  }
  p.cluster = c;
  p.slice = (k + c - 1) / c;
  return p;
}

bool bulk_ok(int d, int n_diag, const void* b3) {
  return ((long)d * n_diag) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b3) % 16 == 0;
}

template <int NDIAG, bool INT32>
constexpr int smem_bytes() {
  return BARS + Tile<NDIAG, INT32>::RING;
}

// --- mbarriers and bulk copies (PTX) ----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}"
               ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One box of the tensor map at (x, y) = (word column, B row) into dst.
__device__ __forceinline__ void tensor_load(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier"
               "::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
               ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
               "r"(x), "r"(y), "r"(smem_addr(bar))
               : "memory");
}

// d + Σ_i a.byte[i] · b.sbyte[i]: four u8 × s8 products, wrapping in int32.
__device__ __forceinline__ uint32_t dp4a_us(uint32_t a, uint32_t b,
                                            uint32_t d) {
  uint32_t r;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(d));
  return r;
}

// int32: one k quad of the thread's 8 × 4 tile.  a_q holds the quad's
// limbs of the 8 rows (row r in word r, k in byte order); w[i] holds the 4
// column digits of B row 4q + i.  The 4 × 4 byte transpose gives each column
// its 4 digits in k order, then 32 dp4a.
__device__ __forceinline__ void mac_quad(uint32_t (&acc)[ROWS][4],
                                         const uint32_t* a_q,
                                         const uint32_t (&w)[4]) {
  const uint4 lo = *reinterpret_cast<const uint4*>(a_q);
  const uint4 hi = *reinterpret_cast<const uint4*>(a_q + 4);
  const uint32_t av[ROWS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  const uint32_t bv[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                          __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = dp4a_us(av[r], bv[c], acc[r][c]);
  }
}

// fp32: one k of the thread's 8 × 4 tile, acc[r][c] += a[r] · b[c] in float
// FFMA, the 8 limbs already floats, the 4 digits widened from bw.
__device__ __forceinline__ void mac_k(float (&acc)[ROWS][4], const float* a_k,
                                      uint32_t bw) {
  const float4 lo = *reinterpret_cast<const float4*>(a_k);
  const float4 hi = *reinterpret_cast<const float4*>(a_k + 4);
  const float av[ROWS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  float bv[4];
  widen_s8x4(bv, bw);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <typename Acc, int NDIAG, bool BULK>
__global__ void __launch_bounds__(
    Tile<NDIAG, std::is_same<Acc, uint32_t>::value>::THREADS + 32)
fused_ntt_tile_kernel(const uint8_t* __restrict__ a,
                      const int8_t* __restrict__ b3, int32_t* __restrict__ out,
                      const __grid_constant__ CUtensorMap b_map, int pitch,
                      int box_rows, int n, int k, int d, int slice,
                      const FoldConsts<NDIAG> fc) {
  constexpr bool INT32 = std::is_same<Acc, uint32_t>::value;
  using T = Tile<NDIAG, INT32>;
  constexpr int TC = T::TC;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  int8_t* ring = reinterpret_cast<int8_t*>(smem + BARS);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int col0 = (blockIdx.x / csize) * CC;
  const int cols = min(CC, d - col0);
  const int row0 = blockIdx.y * ROWS;
  const int k_begin = min(k, rank * slice);
  const int klen = min(k, k_begin + slice) - k_begin;
  const int n_slabs = (klen + KT - 1) / KT;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], T::THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Acc acc[ROWS][TC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = Acc(0);
  }

  if (tid >= T::THREADS) {
    // The producer warp fills slab j (slot j % STAGES) once every consumer
    // has arrived on the slot's "empty" barrier.  Its lanes store the slab's
    // limbs of A (A_LANE each, zeros past N and the slice, loaded while the
    // slab before waited), then B: bulk, lane 0 starts one TMA box of
    // box_rows × pitch bytes (zeros past D and K); otherwise the lanes load
    // it byte by byte, masked.  Each lane arrives on "full" (lane 0 of the
    // bulk variant with the box's byte count).
    const int lane = tid - T::THREADS;
    const size_t b_row = (size_t)d * NDIAG;
    const int tile_bytes = cols * NDIAG;
    if (BULK && lane == 0) {
      asm volatile("prefetch.tensormap [%0];"
                   ::"l"(reinterpret_cast<uint64_t>(&b_map)) : "memory");
    }
    // Limb u of the lane's share of a slab's A: int32, byte u % 4 of word
    // i = lane + 32 · (u / 4), which holds k quad i / 8 of row i % 8; fp32,
    // float i = lane + 32 · u, which holds k i / 8 of row i % 8.
    uint32_t raw[T::A_LANE];
    auto fetch = [&](int j) {
#pragma unroll
      for (int u = 0; u < T::A_LANE; ++u) {
        const int i = lane + 32 * (INT32 ? u / 4 : u);
        const int r = i % ROWS;
        const int kk = j * KT + (INT32 ? 4 * (i / ROWS) + u % 4 : i / ROWS);
        raw[u] = row0 + r < n && kk < klen
                     ? a[(size_t)(row0 + r) * k + k_begin + kk] : 0u;
      }
    };
    if (n_slabs > 0) fetch(0);
    for (int j = 0; j < n_slabs; ++j) {
      const int s = j % STAGES;
      if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
      int8_t* slab = ring + s * T::SLAB;
      if constexpr (INT32) {
        uint32_t* sa = reinterpret_cast<uint32_t*>(slab + KT * T::W);
#pragma unroll
        for (int u = 0; u < T::A_LANE / 4; ++u) {
          sa[lane + 32 * u] = raw[4 * u] | raw[4 * u + 1] << 8 |
                              raw[4 * u + 2] << 16 | raw[4 * u + 3] << 24;
        }
      } else {
        float* sa = reinterpret_cast<float*>(slab + KT * T::W);
#pragma unroll
        for (int u = 0; u < T::A_LANE; ++u) widen_u8(sa[lane + 32 * u], raw[u]);
      }
      const int k0 = k_begin + j * KT;
      if (BULK) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], box_rows * pitch);
          tensor_load(slab, &b_map, col0 * NDIAG / 4, k0, &full[s]);
        } else {
          mbar_arrive(&full[s]);
        }
      } else {
        const int rows = min(KT, klen - j * KT);
        const int8_t* src = b3 + (size_t)k0 * b_row + (size_t)col0 * NDIAG;
        for (int i = lane; i < rows * T::W; i += 32) {
          const int r = i / T::W;
          const int c = i - r * T::W;
          slab[i] = c < tile_bytes ? src[(size_t)r * b_row + c] : 0;
        }
        mbar_arrive(&full[s]);
      }
      if (j + 1 < n_slabs) fetch(j + 1);
    }
  } else {
    // Consumer (w, g): column word w of each slab, k groups g.  A is zero
    // past the slice, so the rows of the last slab past it (zeros, another
    // rank's B or, byte-load variant, stale bytes) add nothing and no step
    // needs a mask.
    const int w = tid % T::NW;
    const int g = tid / T::NW;
    for (int j = 0; j < n_slabs; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const int8_t* slab = ring + s * T::SLAB;
      if constexpr (INT32) {
        const uint32_t* sa = reinterpret_cast<const uint32_t*>(slab + KT * T::W);
#pragma unroll
        for (int i = 0; i < KT / 4 / T::KG; ++i) {
          const int q = g + i * T::KG;
          uint32_t wq[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            wq[b] = *reinterpret_cast<const uint32_t*>(
                slab + (4 * q + b) * pitch + TC * w);
          }
          mac_quad(acc, sa + q * ROWS, wq);
        }
      } else {
        const float* sa = reinterpret_cast<const float*>(slab + KT * T::W);
#pragma unroll
        for (int i = 0; i < KT / T::KG; ++i) {
          const int kk = g + i * T::KG;
          mac_k(acc, sa + kk * ROWS,
                *reinterpret_cast<const uint32_t*>(slab + kk * pitch + TC * w));
        }
      }
      mbar_arrive(&empty[s]);
    }
  }

  // Epilogue.  The ring is free once every consumer is past its last slab.
  __syncthreads();
  Acc* red = reinterpret_cast<Acc*>(ring);   // [KG][ROWS][W]
  if (tid < T::THREADS) {
    const int w = tid % T::NW;
    const int g = tid / T::NW;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int c = 0; c < TC; ++c) red[(g * ROWS + r) * T::W + TC * w + c] = acc[r][c];
    }
  }
  __syncthreads();
  for (int e = tid; e < ROWS * T::W; e += blockDim.x) {
    Acc s = red[e];
#pragma unroll
    for (int gg = 1; gg < T::KG; ++gg) s += red[gg * ROWS * T::W + e];
    red[e] = s;
  }
  // Rank r of the cluster folds the outputs o ≡ r (mod c): each diagonal is
  // the sum of the ranks' partial tiles in rank order (through distributed
  // shared memory), cast with to_int32 and folded with K2's fold.  A
  // rank arrives on the cluster barrier once it has read the others, and
  // waits on it before it exits.
  if (csize > 1) {
    cluster.sync();   // every rank's partial tile is in its shared memory
  } else {
    __syncthreads();
  }
  int32_t diag[T::MAX_OUT][NDIAG];
#pragma unroll
  for (int i = 0; i < T::MAX_OUT; ++i) {
    const int o = rank + csize * (tid + i * (int)blockDim.x);
    if (o < ROWS * CC) {
      const int e = (o / CC) * T::W + (o % CC) * NDIAG;
      Acc sum[NDIAG];
#pragma unroll
      for (int q = 0; q < NDIAG; ++q) sum[q] = Acc(0);
      for (int r = 0; r < csize; ++r) {
        const Acc* src = r == rank ? red : cluster.map_shared_rank(red, r);
#pragma unroll
        for (int q = 0; q < NDIAG; ++q) sum[q] += src[e + q];
      }
#pragma unroll
      for (int q = 0; q < NDIAG; ++q) diag[i][q] = to_int32(sum[q]);
    }
  }
  if (csize > 1) asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
#pragma unroll
  for (int i = 0; i < T::MAX_OUT; ++i) {
    const int o = rank + csize * (tid + i * (int)blockDim.x);
    const int row = row0 + o / CC;
    const int c = o % CC;
    if (o < ROWS * CC && row < n && c < cols) {
      out[(size_t)row * d + col0 + c] = (int32_t)fold_diagonals<NDIAG>(diag[i], fc);
    }
  }
  if (csize > 1) asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query so
// that the library needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// B as a 2-D tensor of 4-byte words, (K rows) × (d·NDIAG / 4 columns), read
// in boxes of box_rows × pitch bytes, zeros past its edges.  Words, not
// bytes, because a box row holds at most 256 elements.
cudaError_t make_b_map(CUtensorMap* map, const int8_t* b3, int k, int d,
                       int n_diag, int pitch, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)d * n_diag;
  const cuuint64_t dims[2] = {row / 4, (cuuint64_t)(k > 0 ? k : 1)};
  const cuuint64_t strides[1] = {row};
  const cuuint32_t box[2] = {(cuuint32_t)pitch / 4, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
      const_cast<void*>(static_cast<const void*>(b3)), dims, strides, box,
      steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Acc, int NDIAG, bool BULK>
cudaError_t launch_kernel(const uint8_t* a, const int8_t* b3, int32_t* out,
                          int n, int k, int d, uint32_t m, const Plan& p,
                          cudaStream_t s) {
  auto kernel = fused_ntt_tile_kernel<Acc, NDIAG, BULK>;
  constexpr bool INT32 = std::is_same<Acc, uint32_t>::value;
  using T = Tile<NDIAG, INT32>;
  // The instance's shared memory, allowed once per device (above 48 KB it
  // must be).
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<NDIAG, INT32>());
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctiles * p.cluster, p.rtiles);
  cfg.blockDim = dim3(T::THREADS + 32);
  cfg.dynamicSmemBytes = smem_bytes<NDIAG, INT32>();
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // The bulk variant's box: the tile's row bytes (all of a B row when it is
  // narrower) × a slab (all of K when it is shorter).
  CUtensorMap b_map = {};
  int pitch = T::W;
  int box_rows = KT;
  if (BULK) {
    pitch = d * NDIAG < pitch ? d * NDIAG : pitch;
    box_rows = k > 0 && k < box_rows ? k : box_rows;
    err = make_b_map(&b_map, b3, k, d, NDIAG, pitch, box_rows);
    if (err != cudaSuccess) return err;
  }
  return cudaLaunchKernelEx(&cfg, kernel, a, b3, out, b_map, pitch, box_rows,
                            n, k, d, p.slice, make_fold_consts<NDIAG>(m));
}

template <int NDIAG>
cudaError_t launch(const uint8_t* a, const int8_t* b3, int32_t* out, int n,
                   int k, int d, uint32_t m, int fp32, int device,
                   cudaStream_t s) {
  int target = 0;
  const cudaError_t err = target_blocks(device, &target);
  if (err != cudaSuccess) return err;
  const Plan p = plan_of(n, k, d, target);
  const bool bulk = bulk_ok(d, NDIAG, b3);
  if (fp32) {
    return bulk ? launch_kernel<float, NDIAG, true>(a, b3, out, n, k, d, m, p, s)
                : launch_kernel<float, NDIAG, false>(a, b3, out, n, k, d, m, p, s);
  }
  return bulk ? launch_kernel<uint32_t, NDIAG, true>(a, b3, out, n, k, d, m, p, s)
              : launch_kernel<uint32_t, NDIAG, false>(a, b3, out, n, k, d, m, p, s);
}

template <int NDIAG>
void list_instances(KernelInstance* out) {
  KernelInstance* o = out + 4 * (NDIAG - 1);
  o[0] = {(const void*)fused_ntt_tile_kernel<uint32_t, NDIAG, false>, 3, 0, NDIAG, 0};
  o[1] = {(const void*)fused_ntt_tile_kernel<uint32_t, NDIAG, true>, 3, 0, NDIAG, 1};
  o[2] = {(const void*)fused_ntt_tile_kernel<float, NDIAG, false>, 3, 1, NDIAG, 0};
  o[3] = {(const void*)fused_ntt_tile_kernel<float, NDIAG, true>, 3, 1, NDIAG, 1};
  if constexpr (NDIAG < 8) list_instances<NDIAG + 1>(out);
}

}  // namespace

int fused_ntt_tile_instances(KernelInstance* out) {
  list_instances<1>(out);
  return 32;
}

// The launch geometry of one call at (n, k, d, n_diag) on the operand b3 on
// `device`, as the launch computes it: out[0] blocks, out[1] the cluster
// size (blocks splitting K for one tile), out[2] 1 for the bulk-copy variant
// and 0 for the byte-load one.
extern "C" int fused_ntt_tile_grid(int n, int k, int d, int n_diag,
                                   const void* b3, int device, void* out) {
  int target = 0;
  const cudaError_t err = target_blocks(device, &target);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan_of(n, k, d, target);
  int* o = static_cast<int*>(out);
  o[0] = p.ctiles * p.cluster * p.rtiles;
  o[1] = p.cluster;
  o[2] = bulk_ok(d, n_diag, b3) ? 1 : 0;
  return 0;
}

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
      case 1: return launch<1>(pa, pb, po, n, k, d, m, fp32, device, s);
      case 2: return launch<2>(pa, pb, po, n, k, d, m, fp32, device, s);
      case 3: return launch<3>(pa, pb, po, n, k, d, m, fp32, device, s);
      case 4: return launch<4>(pa, pb, po, n, k, d, m, fp32, device, s);
      case 5: return launch<5>(pa, pb, po, n, k, d, m, fp32, device, s);
      case 6: return launch<6>(pa, pb, po, n, k, d, m, fp32, device, s);
      case 7: return launch<7>(pa, pb, po, n, k, d, m, fp32, device, s);
      case 8: return launch<8>(pa, pb, po, n, k, d, m, fp32, device, s);
      default: return cudaErrorInvalidValue;
    }
  });
}

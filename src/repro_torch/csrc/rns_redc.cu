// rns_redc: (..., n+1) int64 RNS residues of BN254 transform outputs -> the
// canonical element X mod p of each, as 23 digits of 12 bits (int64 each,
// the "digits" form) or as its 8 little-endian 32-bit words (int64 each,
// the "words" form).  It computes exactly core/rns.py::rns_to_field and,
// for the words form, montgomery.py::digits_to_words_u32(...)[..., :8].
//
// Replaces no Pallas kernel: the JAX package does this step in jnp
// (src/repro/core/rns.py:rns_to_field), which XLA fuses.  The port ran it
// as ~3,600 int64 ATen kernels in every bn254_full launch (~1 µs a node,
// ~80 % of the launch's device time); this kernel is one node.
//
// What bounds it on an H100.  Not bytes: at (8 rows, d = 512, 18 channels)
// it reads 4,096 × 144 B and writes 4,096 × 64 B (0.9 MB, ~0.3 µs at
// 3.35 TB/s).  It does ~3,000 32-bit integer operations an element, whose
// longest dependent chain (the REDC's running low digit) is ~150
// instructions; at the served sizes (512 to 65,536 elements) the launch
// and that latency set its time.
//
// Design.  One thread an element.  A block stages its elements' residues
// through shared memory (coalesced loads) and its results back out
// (coalesced stores); everything between stays in registers.  The chain's
// constants (moduli, (M/m_i)^{-1} mod m_i, M/m_i mod m_r, M^{-1} mod m_r,
// the digits of T_i, V and p, -p^{-1} mod β) come by value in the kernel's
// parameters, which the launch copies into the node of a captured CUDA
// graph: the constant bank serves every thread's uniform reads, nothing is
// uploaded to the device, and nothing is written outside the graph's
// capture.  Per element:
//   1. ξ_i = r_i·(M/m_i)^{-1} mod m_i, by Barrett reduction of 64-bit
//      products (μ = ⌊2^64/m⌋, one conditional subtract).
//   2. The Shenoy–Kumaresan α = (Σ ξ_i·(M/m_i) − r_red)·M^{-1} mod m_r.
//   3. Y = Σ ξ_i·T_i + α·V in 27 digit-12 columns: each scalar split into
//      three 12-bit digits, every product < 2^24, every column < 2^30
//      (3 × 18 digit products), exact in uint32.
//   4. 23 Montgomery steps on the columns as they are, carries deferred:
//      q = t_0·(−p^{-1}) mod β, t ← (t + q·p)/β, where only the low column's
//      carry is taken (it is exact: t_0 + q·p_0 ≡ 0 mod β) and every other
//      column just adds q·p_j.  A column then stays below
//      2^30 + 23·2^24 + 2^20 < 2^31, and t_0 + q·p_0 below 2^32.
//   5. One carry pass, then the conditional subtract of p (the REDC result
//      is below 2p), then the digits or the words.
// The plain version normalises Y first and carries at every step; both
// compute the same integer (Y + Q·p)/β^23, so the canonical result is the
// same bit for bit, for any residues below 2^32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int BETA_BITS = 12;
constexpr uint32_t MASK = (1u << BETA_BITS) - 1;
constexpr int ND = 25;         // digits of T_i and V
constexpr int NRED = 23;       // Montgomery digits of p (β^NRED the radix)
constexpr int NCOL = ND + 2;   // columns of Y: 3 digits of a scalar × ND
constexpr int NWORDS = 8;      // 32-bit words of an element of F_p

template <int NB>
struct RedcConsts {
  uint64_t mu[NB + 1];    // ⌊2^64 / m⌋ of each modulus
  uint32_t m[NB + 1];     // base moduli, then the redundant m_r
  uint32_t inv_mi[NB];    // (M/m_i)^{-1} mod m_i
  uint32_t mi_mr[NB];     // (M/m_i) mod m_r
  uint32_t T[NB][ND];     // digits of (M/m_i)·β^NRED mod p
  uint32_t V[ND];         // digits of (−M·β^NRED) mod p
  uint32_t P[NRED];       // digits of p
  uint32_t m_inv_mr;      // M^{-1} mod m_r
  uint32_t p_prime;       // −p^{-1} mod β
};

// x mod m for any 64-bit x and 1 < m < 2^31, with mu = ⌊2^64/m⌋: the
// estimate ⌊x·mu/2^64⌋ is ⌊x/m⌋ or one less, so x − q·m < 2m.
__device__ __forceinline__ uint32_t barrett(uint64_t x, uint32_t m,
                                            uint64_t mu) {
  const uint64_t q = __umul64hi(x, mu);
  const uint32_t r = (uint32_t)(x - q * m);
  return r >= m ? r - m : r;
}

template <int NB, bool WORDS>
__global__ void __launch_bounds__(THREADS)
rns_redc_kernel(const int64_t* __restrict__ residues,
                int64_t* __restrict__ out, int n_el,
                const __grid_constant__ RedcConsts<NB> c) {
  constexpr int NIN = NB + 1;
  constexpr int NOUT = WORDS ? NWORDS : NRED;
  __shared__ int64_t in[THREADS * NIN];
  __shared__ int64_t res[THREADS * NOUT];

  const int first = blockIdx.x * THREADS;
  const int cnt = min(THREADS, n_el - first);
  const int64_t* src = residues + (size_t)first * NIN;
  for (int k = threadIdx.x; k < cnt * NIN; k += THREADS) in[k] = src[k];
  __syncthreads();

  if ((int)threadIdx.x < cnt) {
    const int64_t* r = in + threadIdx.x * NIN;

    // 1-2. ξ_i and the overflow count α
    uint32_t xi[NB];
    uint64_t sum = 0;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const uint32_t ri = barrett((uint64_t)r[i], c.m[i], c.mu[i]);
      xi[i] = barrett((uint64_t)ri * c.inv_mi[i], c.m[i], c.mu[i]);
      sum += barrett((uint64_t)xi[i] * c.mi_mr[i], c.m[NB], c.mu[NB]);
    }
    const uint32_t mr = c.m[NB];
    const uint32_t acc = barrett(sum, mr, c.mu[NB]);
    const uint32_t rr = barrett((uint64_t)r[NB], mr, c.mu[NB]);
    const uint32_t diff = acc >= rr ? acc - rr : acc + mr - rr;
    const uint32_t alpha = barrett((uint64_t)diff * c.m_inv_mr, mr, c.mu[NB]);

    // 3. Y = Σ ξ_i·T_i + α·V in digit-12 columns
    uint32_t t[NCOL];
#pragma unroll
    for (int j = 0; j < NCOL; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i <= NB; ++i) {
      const uint32_t x = i < NB ? xi[i] : alpha;
      const uint32_t d0 = x & MASK, d1 = (x >> BETA_BITS) & MASK,
                     d2 = x >> (2 * BETA_BITS);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const uint32_t k = i < NB ? c.T[i][j] : c.V[j];
        t[j] += d0 * k;
        t[j + 1] += d1 * k;
        t[j + 2] += d2 * k;
      }
    }

    // 4. NRED Montgomery steps, carries deferred but the low column's
#pragma unroll
    for (int s = 0; s < NRED; ++s) {
      const uint32_t q = (t[0] * c.p_prime) & MASK;
      const uint32_t carry = (t[0] + q * c.P[0]) >> BETA_BITS;
#pragma unroll
      for (int j = 1; j < NCOL; ++j)
        t[j - 1] = t[j] + (j < NRED ? q * c.P[j] : 0u);
      t[NCOL - 1] = 0;
      t[0] += carry;
    }

    // 5. carry pass, conditional subtract of p
    uint32_t d[NRED], e[NRED];
    uint32_t carry = 0, borrow = 0;
#pragma unroll
    for (int j = 0; j < NRED; ++j) {
      const uint32_t v = t[j] + carry;
      d[j] = v & MASK;
      carry = v >> BETA_BITS;
      const int32_t x = (int32_t)d[j] - (int32_t)c.P[j] - (int32_t)borrow;
      borrow = x < 0;
      e[j] = (uint32_t)(x + ((int32_t)borrow << BETA_BITS));
    }
    const bool ge = borrow == 0;     // the result is at least p
#pragma unroll
    for (int j = 0; j < NRED; ++j) d[j] = ge ? e[j] : d[j];
    int64_t* o = res + threadIdx.x * NOUT;
    if constexpr (WORDS) {
#pragma unroll
      for (int k = 0; k < NWORDS; ++k) {
        uint32_t w = 0;
#pragma unroll
        for (int j = 0; j < NRED; ++j) {
          const int b = BETA_BITS * j - 32 * k;
          if (b >= 0 && b < 32) w |= d[j] << b;
          else if (b < 0 && b > -BETA_BITS) w |= d[j] >> -b;
        }
        o[k] = (int64_t)w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NRED; ++j) o[j] = (int64_t)d[j];
    }
  }
  __syncthreads();
  int64_t* dst = out + (size_t)first * NOUT;
  for (int k = threadIdx.x; k < cnt * NOUT; k += THREADS) dst[k] = res[k];
}

int blocks_of(int n_el) { return (n_el + THREADS - 1) / THREADS; }

// The host constants, as rns_redc/kernel.py packs them (uint32): the n+1
// moduli, (M/m_i)^{-1} mod m_i, M/m_i mod m_r, M^{-1} mod m_r, −p^{-1} mod
// β, T (n × ND, row-major), V (ND), p (NRED).
constexpr int consts_words(int nb) { return (nb + 1) + 2 * nb + 2 + nb * ND
                                            + ND + NRED; }

template <int NB>
RedcConsts<NB> unpack(const uint32_t* h) {
  RedcConsts<NB> c;
  for (int i = 0; i <= NB; ++i) {
    c.m[i] = *h++;
    c.mu[i] = ~0ull / c.m[i];   // = ⌊2^64/m⌋: an odd m does not divide 2^64
  }
  for (int i = 0; i < NB; ++i) c.inv_mi[i] = *h++;
  for (int i = 0; i < NB; ++i) c.mi_mr[i] = *h++;
  c.m_inv_mr = *h++;
  c.p_prime = *h++;
  for (int i = 0; i < NB; ++i)
    for (int j = 0; j < ND; ++j) c.T[i][j] = *h++;
  for (int j = 0; j < ND; ++j) c.V[j] = *h++;
  for (int j = 0; j < NRED; ++j) c.P[j] = *h++;
  return c;
}

template <int NB>
cudaError_t launch(const int64_t* r, int64_t* o, int n_el, bool words,
                   const uint32_t* h, cudaStream_t s) {
  for (int i = 0; i <= NB; ++i)
    if (h[i] < 3 || h[i] >= (1u << 31) || !(h[i] & 1))
      return cudaErrorInvalidValue;
  const RedcConsts<NB> c = unpack<NB>(h);
  if (words)
    rns_redc_kernel<NB, true><<<blocks_of(n_el), THREADS, 0, s>>>(r, o, n_el,
                                                                   c);
  else
    rns_redc_kernel<NB, false><<<blocks_of(n_el), THREADS, 0, s>>>(r, o, n_el,
                                                                    c);
  return cudaSuccess;
}

}  // namespace

// Blocks in the grid of one launch for n_el elements.
extern "C" int rns_redc_blocks(int n_el) { return blocks_of(n_el); }

// n_base 8 (the 9-channel chain) or 17 (the 18-channel chain), n_consts the
// length of the packed constants for it, and odd moduli in (2, 2^31);
// anything else is refused with cudaErrorInvalidValue before any launch.
extern "C" int rns_redc_launch(const void* residues, void* out, int n_el,
                               int n_base, int words, const void* consts,
                               int n_consts, int device, void* stream) {
  const int64_t* r = static_cast<const int64_t*>(residues);
  int64_t* o = static_cast<int64_t*>(out);
  const uint32_t* h = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_el <= 0 || n_consts != consts_words(n_base))
    return (int)cudaErrorInvalidValue;
  return launch_on(device, [&]() {
    switch (n_base) {
      case 8: return launch<8>(r, o, n_el, words != 0, h, s);
      case 17: return launch<17>(r, o, n_el, words != 0, h, s);
      default: return cudaErrorInvalidValue;
    }
  });
}

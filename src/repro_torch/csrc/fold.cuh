// The fold of limb-weight diagonals to a residue mod m, shared by K2
// (mont_fold.cu) and K3's epilogue (fused_ntt_tile.cu), so that the two
// kernels cannot drift apart.
//
// Σ_k d[k] · 2**(8k) mod m, for every int32 diagonal and 1 < m < 2**31, as
// a sum of independent terms: out = Σ_k (d[k] · w[k] mod m) mod m with
// w[k] = 2**(8k) mod m.
//
// Why not Horner.  The TPU kernel (and the first port) folds from the top
// diagonal: 8 dependent conditional doublings of the accumulator per
// diagonal, then the diagonal's remainder by a runtime modulus.  That is a
// chain of ~27 dependent instructions a diagonal (~135 at n_diag = 5, ~190
// at 7) through every thread, and K2's time followed n_diag, not its bytes.
// Here no term waits for another, and there is no division on the device.
//
// One term.  The diagonal is biased to x = d + 2**31 (its sign bit flipped),
// an unsigned 32-bit value.  With Shoup's precomputed quotient
// wq = ⌊w · 2**32 / m⌋ (< 2**32 since w < m), q = ⌊x · wq / 2**32⌋ (one
// multiply-high) is ⌊x · w / m⌋ or one less, because x < 2**32, so
// r = x · w − q · m lies in [0, 2m) and, as 2m < 2**32, the low 32 bits of
// the two products give it exactly.  One conditional subtract (an unsigned
// min of r and r − m) takes it to [0, m).
//
// The sign.  Σ_k d[k] w[k] = Σ_k x[k] w[k] − 2**31 Σ_k w[k], so one more
// term, the bias −2**31 Σ_k w[k] mod m, computed on the host, makes the
// result the floor mod of jnp.mod for every int32 diagonal, −2**31 included.
//
// The sum.  The n_diag + 1 terms, each < m, are added by a tree of add-mods
// (a + b < 2m, then the same unsigned min): 3 levels up to n_diag = 7, 4 at
// n_diag = 8.  The dependent path from a loaded diagonal to the residue is
// about 4 instructions for its term and 2 a level.
//
// The constants (w, wq, the bias; a few tens of bytes) are computed on the
// host inside each C entry by make_fold_consts, in nanoseconds, and passed to
// the kernel by value.  NDIAG is a template parameter, so every loop unrolls
// and the terms stay in registers.
#pragma once

#include <stdint.h>

template <int NDIAG>
struct FoldConsts {
  uint32_t m;            // the modulus, 1 < m < 2**31
  uint32_t bias;         // −2**31 · Σ_k w[k] mod m
  uint32_t w[NDIAG];     // 2**(8k) mod m
  uint32_t wq[NDIAG];    // ⌊w[k] · 2**32 / m⌋
};

template <int NDIAG>
__host__ inline FoldConsts<NDIAG> make_fold_consts(uint32_t m) {
  FoldConsts<NDIAG> c;
  c.m = m;
  uint64_t w = 1 % m, sum = 0;
  for (int k = 0; k < NDIAG; ++k) {
    c.w[k] = (uint32_t)w;
    c.wq[k] = (uint32_t)(((uint64_t)w << 32) / m);
    sum += w;
    w = (w << 8) % m;
  }
  const uint64_t neg = ((uint64_t)(1u << 31) % m) * (sum % m) % m;
  c.bias = (uint32_t)((m - neg) % m);
  return c;
}

// (a + b) mod m for a, b < m < 2**31: a + b < 2**32, and when it is below
// m, a + b − m wraps above it, so the unsigned min picks the residue.
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t m) {
  const uint32_t s = a + b;
  return min(s, s - m);
}

// One level of the tree: t[i] += t[i + S] mod m for i ≡ 0 (mod 2S), then
// the next level, until one term is left in t[0].
template <int N, int S>
__device__ __forceinline__ void add_tree(uint32_t (&t)[N], uint32_t m) {
  if constexpr (S < N) {
#pragma unroll
    for (int i = 0; i + S < N; i += 2 * S) t[i] = add_mod(t[i], t[i + S], m);
    add_tree<N, 2 * S>(t, m);
  }
}

template <int NDIAG>
__device__ __forceinline__ uint32_t fold_diagonals(const int32_t (&d)[NDIAG],
                                                   const FoldConsts<NDIAG>& c) {
  uint32_t t[NDIAG + 1];
#pragma unroll
  for (int k = 0; k < NDIAG; ++k) {
    const uint32_t x = (uint32_t)d[k] ^ 0x80000000u;       // d + 2**31
    const uint32_t q = __umulhi(x, c.wq[k]);
    const uint32_t r = x * c.w[k] - q * c.m;               // in [0, 2m)
    t[k] = min(r, r - c.m);
  }
  t[NDIAG] = c.bias;
  add_tree<NDIAG + 1, 1>(t, c.m);
  return t[0];
}

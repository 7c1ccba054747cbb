// The fold of limb-weight diagonals to a residue mod m, shared by K2
// (mont_fold.cu) and K3's epilogue (fused_ntt_tile.cu), so that the two
// kernels cannot drift apart.
//
// Σ_k d[k] · 2**(8k) mod m, for a modulus m < 2**31, by Horner from the top
// diagonal, in uint32_t exactly as the TPU kernels: 8 conditional doublings
// of acc (acc < m < 2**31, so acc << 1 never overflows), then the diagonal's
// remainder added mod m.  CUDA's % truncates toward zero, so a negative
// remainder gets m added: the floor mod of jnp.mod, right for every int32
// diagonal including -2**31.  NDIAG is a template parameter, so both loops
// unroll completely and a local array argument stays in registers.
#pragma once

#include <stdint.h>

template <int NDIAG>
__device__ __forceinline__ uint32_t fold_diagonals(const int32_t* d,
                                                   uint32_t m) {
  const int32_t mi = (int32_t)m;
  uint32_t acc = 0;
#pragma unroll
  for (int k = NDIAG - 1; k >= 0; --k) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      acc <<= 1;
      acc = acc >= m ? acc - m : acc;
    }
    int32_t r = d[k] % mi;
    if (r < 0) r += mi;
    const uint32_t t = acc + (uint32_t)r;
    acc = t >= m ? t - m : t;
  }
  return acc;
}

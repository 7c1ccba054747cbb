// The two accumulator models of the limb GEMMs, shared by K1
// (limb_matmul.cu) and K3 (fused_ntt_tile.cu), as on the TPU:
//   int32_native  — 32-bit integer multiply-add, wrapping mod 2**32 (done in
//                   uint32_t, where wrapping is defined);
//   fp32_mantissa — float FFMA (not TF32 tensor cores), cast to int32 at the
//                   end: exact inside the 2**24 window, rounding beyond it as
//                   the modelled v4 MXU accumulator does.
// Inside the per-pass window every order of summation gives the same bits.
#pragma once

#include <stdint.h>

__device__ __forceinline__ void mac(uint32_t& acc, uint32_t a, int32_t b) {
  acc += (uint32_t)((int32_t)a * b);
}

__device__ __forceinline__ void mac(float& acc, uint32_t a, int32_t b) {
  acc = fmaf((float)a, (float)b, acc);
}

__device__ __forceinline__ int32_t to_int32(uint32_t s) { return (int32_t)s; }
__device__ __forceinline__ int32_t to_int32(float s) { return __float2int_rz(s); }

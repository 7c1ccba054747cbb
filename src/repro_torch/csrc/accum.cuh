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

// The same multiply-adds on operands already widened to the accumulator's
// type (widen_u8, widen_s8x4), so that a tile of them is one IMAD or one
// FFMA each.  The product of a limb and a digit is below 2**15 in
// magnitude, so the float product is exact and the bits are those of mac
// above.
__device__ __forceinline__ void mac(uint32_t& acc, uint32_t a, uint32_t b) {
  acc += a * b;
}

__device__ __forceinline__ void mac(float& acc, float a, float b) {
  acc = fmaf(a, b, acc);
}

// A u8 limb (0..255) in the accumulator's type.  The float form is exact
// and needs no conversion unit: 0x4B000000 | v is the float 2**23 + v.
__device__ __forceinline__ void widen_u8(uint32_t& out, uint32_t v) { out = v; }

__device__ __forceinline__ void widen_u8(float& out, uint32_t v) {
  out = __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

// The four s8 digits packed in a word (byte 0 first) in the accumulator's
// type.  The float form biases each digit by 128 into 0..255, places it in
// the low mantissa byte of 2**23 (one byte permute) and subtracts
// 2**23 + 128: exact.
__device__ __forceinline__ void widen_s8x4(uint32_t (&out)[4], uint32_t w) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (uint32_t)(int32_t)(int8_t)(w >> (8 * i));
}

__device__ __forceinline__ void widen_s8x4(float (&out)[4], uint32_t w) {
  const uint32_t biased = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + i)) -
             8388736.0f;
  }
}

__device__ __forceinline__ int32_t to_int32(uint32_t s) { return (int32_t)s; }
__device__ __forceinline__ int32_t to_int32(float s) { return __float2int_rz(s); }

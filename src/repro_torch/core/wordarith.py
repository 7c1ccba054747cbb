"""Multi-word exact integer arithmetic in base β = 2**12 ("digit-12").

Wide values are split into 12-bit digits so that a digit product is < 2**24
and dozens of them accumulate without carry interruptions; carries are then
normalised in a handful of vectorised passes.  This is the VPU-side
complement of the limb GEMM, used by the Montgomery / base-extension phase.

Digits are carried in int64 tensors; every value stays far below 2**31, so
the bits equal the JAX package's int32/uint32 forms.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn

BETA_BITS = 12
BETA = 1 << BETA_BITS
DIGIT_MASK = BETA - 1


# --- Host-side (Python bignum) conversions -----------------------------------


def int_to_digits(x: int, n: int) -> np.ndarray:
    if x < 0:
        raise ValueError("negative")
    out = np.zeros(n, np.uint32)
    for j in range(n):
        out[j] = x & DIGIT_MASK
        x >>= BETA_BITS
    if x:
        raise ValueError(f"{n} digits insufficient")
    return out


def digits_to_int(d: np.ndarray) -> int:
    x = 0
    for j in range(len(d) - 1, -1, -1):
        x = (x << BETA_BITS) + int(d[j])
    return x


def digits_to_int_batch(d: np.ndarray) -> np.ndarray:
    """(..., n) digit arrays -> object array of Python ints."""
    flat = d.reshape(-1, d.shape[-1])
    out = np.array([digits_to_int(row) for row in flat], object)
    return out.reshape(d.shape[:-1])


# --- Device-side helpers ------------------------------------------------------


def u32_to_digits(x: torch.Tensor, n: int) -> torch.Tensor:
    """Residues [...] (< 2**32) -> (..., n) int64 digit-12 planes."""
    x = x.to(torch.int64)
    return torch.stack(
        [(x >> (BETA_BITS * t)) & DIGIT_MASK for t in range(n)], dim=-1)


def normalize_digits(d: torch.Tensor, passes: int = 6) -> torch.Tensor:
    """(..., n) possibly-denormal digits -> int64 canonical digits.

    Each pass moves carries one step up while dividing their magnitude by β;
    starting magnitudes < 2**30 vanish within 4 passes (6 for safety margin).
    The represented integer must be non-negative.
    """
    d = d.to(torch.int64)
    for _ in range(passes):
        q = torch.div(d, BETA, rounding_mode="floor")   # floor for negatives
        r = d - q * BETA                                 # in [0, β)
        carry = Fn.pad(q, (1, 0))[..., :-1]
        d = r + carry
    return d


def scalar_conv_accumulate(scalars: torch.Tensor, const_digits: torch.Tensor,
                           out_digits: int) -> torch.Tensor:
    """Σ_i scalars[..., i] · const_i as denormal digit-12 planes.

    scalars: (..., k), each < 2**31 (three digit-12 planes).
    const_digits: (k, n_c) int64 — host-precomputed digit-12 constants.
    Returns int64 (..., out_digits), denormal (caller normalises).

    The JAX package does three int32 matmuls here (the dense base-extension
    matrix-vector products of paper §6.2).  torch has no integer matmul on
    CUDA, so each becomes an int64 broadcast-multiply-sum; every partial sum
    is < 2**28, so the values are the same.
    """
    k, n_c = const_digits.shape
    sc_d = u32_to_digits(scalars, 3)                         # (..., k, 3)
    out = torch.zeros(scalars.shape[:-1] + (out_digits,), dtype=torch.int64,
                      device=scalars.device)
    for t in range(3):
        part = (sc_d[..., t, None] * const_digits).sum(dim=-2)   # (..., n_c)
        out[..., t:t + n_c] += part
    return out


def cond_subtract(t: torch.Tensor, p_digits) -> torch.Tensor:
    """Multi-digit conditional subtract: t - p if t >= p else t (canonical)."""
    n = len(p_digits)
    diff = torch.zeros_like(t)
    borrow = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
    for j in range(n):
        d = t[..., j] - int(p_digits[j]) - borrow
        b = (d < 0).to(t.dtype)
        diff[..., j] = d + b * BETA
        borrow = b
    take_diff = borrow == 0  # t >= p
    return torch.where(take_diff[..., None], diff, t)


def digits_submod_p(a: torch.Tensor, b: torch.Tensor, p_digits) -> torch.Tensor:
    """(a - b) mod p over canonical digit arrays (a, b < p)."""
    n = len(p_digits)
    diff = torch.zeros_like(a)
    summ = torch.zeros_like(a)
    borrow = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    carry = torch.zeros_like(borrow)
    for j in range(n):
        d = a[..., j] - b[..., j] - borrow
        bo = (d < 0).to(a.dtype)
        diff[..., j] = d + bo * BETA
        borrow = bo
        s = diff[..., j] + int(p_digits[j]) + carry
        summ[..., j] = s & DIGIT_MASK
        carry = s >> BETA_BITS               # final top carry (=1) drops: +p-β^n
    underflow = borrow == 1
    return torch.where(underflow[..., None], summ, diff)


def digits_geq(t: torch.Tensor, p_digits) -> torch.Tensor:
    """t >= p comparison over canonical digit arrays."""
    borrow = torch.zeros(t.shape[:-1], dtype=torch.int64, device=t.device)
    for j in range(len(p_digits)):
        d = t[..., j] - int(p_digits[j]) - borrow
        borrow = (d < 0).to(torch.int64)
    return borrow == 0

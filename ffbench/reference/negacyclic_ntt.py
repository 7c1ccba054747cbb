"""Plain reference of one request of the Dilithium (ML-DSA) class.

A request of degree ``d_i`` asks for the forward negacyclic transform mod
``q`` of its coefficients, zero-padded to its bucket ``d``:

    y[j] = sum_i a[i] * psi**(i * (2j + 1))   (mod q),   j = 0 .. d-1,

with ``psi`` the primitive 2d-th root of unity found by the first base
``g >= 2`` whose power ``g**((q-1)/2d)`` has order exactly ``2d``, in
natural order.  That is ``psi = 6,757,063`` at d = 256 for q = 8,380,417.

The matrix product runs in float64 on two 12-bit limbs of the twiddle
matrix: a coefficient is below 2**23, a limb below 2**12, so each product is
below 2**35 and a row of at most 2**13 of them sums below 2**48, under
float64's 2**53.  Every partial sum is then an integer held exactly, in any
order of summation, so the result does not depend on the library's GEMM.
``dtype=torch.float32`` computes the same thing one precision lower: the
benchmark's control, which must come out wrong.

This file imports nothing of the program under test.
"""
from __future__ import annotations

import contextlib

import torch

LIMB_BITS = 12
BLOCK_ROWS = 1 << 15


def _prime_factors(n: int) -> list[int]:
    out, p = [], 2
    while p * p <= n:
        if n % p == 0:
            out.append(p)
            while n % p == 0:
                n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


def primitive_root(q: int, order: int) -> int:
    """The first ``g**((q-1)/order)``, g = 2, 3, ..., of order exactly
    ``order`` modulo the prime ``q``."""
    if (q - 1) % order:
        raise ValueError(f"{order} does not divide {q} - 1")
    factors = _prime_factors(order)
    for g in range(2, q):
        w = pow(g, (q - 1) // order, q)
        if w != 1 and all(pow(w, order // f, q) != 1 for f in factors):
            return w
    raise ValueError(f"no root of order {order} modulo {q}")


def twiddles(d: int, q: int, device=None) -> torch.Tensor:
    """W[i, j] = psi**(i(2j+1)) mod q as a (d, d) int64 tensor."""
    psi = primitive_root(q, 2 * d)
    powers = [1] * (2 * d)
    for k in range(1, 2 * d):
        powers[k] = powers[k - 1] * psi % q
    table = torch.tensor(powers, dtype=torch.int64, device=device)
    i = torch.arange(d, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    return table[(i * (2 * j + 1)) % (2 * d)]


@contextlib.contextmanager
def _no_tf32():
    """float32 matrix products in float32, not TF32 (the control is one
    precision below float64, not two)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def transform(x: torch.Tensor, q: int, *, w: torch.Tensor | None = None,
              dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(n, d) coefficients in [0, q) -> (n, d) int64 forward transforms,
    on ``x``'s device, in blocks of rows."""
    n, d = x.shape
    if w is None:
        w = twiddles(d, q, x.device)
    mask = (1 << LIMB_BITS) - 1
    w_lo = (w & mask).to(dtype)
    w_hi = (w >> LIMB_BITS).to(dtype)
    out = torch.empty((n, d), dtype=torch.int64, device=x.device)
    with _no_tf32():
        for lo in range(0, n, BLOCK_ROWS):
            a = x[lo:lo + BLOCK_ROWS].to(dtype)
            y_lo = torch.round(a @ w_lo).to(torch.int64) % q
            y_hi = torch.round(a @ w_hi).to(torch.int64) % q
            out[lo:lo + BLOCK_ROWS] = (y_lo + (y_hi << LIMB_BITS)) % q
    return out

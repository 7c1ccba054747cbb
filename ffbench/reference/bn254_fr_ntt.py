"""Plain reference of one request of the BN254 class: the forward transform
over the scalar field F_r of BN254 (r is ``R`` below, 254 bits).

A request of degree ``d_i`` asks for the cyclic forward transform mod ``r``
of its coefficients, zero-padded to its bucket ``d``:

    y[j] = sum_i a[i] * omega**(i * j)   (mod r),   j = 0 .. d-1,

in natural order, with ``omega`` the first ``g**((r-1)/d)``, g = 2, 3, ...,
of order exactly ``d`` (g = 5 at every bucket from 64 to 512).  That is a
PLONK or Groth16 prover's coefficient-to-evaluation FFT on the subgroup of
size ``d``.  A coefficient and an answer are field elements given as 8
little-endian 32-bit words, held in int64.

The arithmetic is exact whatever the library's order of summation:

1. every input and every twiddle is split into 16 limbs of 16 bits;
2. for each input limb, one matrix product ``(n, d) @ (d, 16 d)`` against
   every twiddle limb at once: each product is below 2**32 and a column of
   ``d <= 2**20`` of them sums below 2**52, under float64's 2**53, so every
   partial sum is an integer held exactly;
3. the products are summed by limb position in int64 and their carries
   propagated: the value is below ``d r**2 < 2**(508 + log2 d)``, 34 limbs;
4. the limbs from bit 256 up are folded with 2**(16k) mod r (below
   ``2**256 + 18 * 2**16 * r < 2**277``), a quotient is estimated from the
   top 53 bits, which leaves a remainder in [0, 2r), and one conditional
   subtraction makes it canonical.

``dtype=torch.float32`` (TF32 off) runs step 2 one precision lower: the
benchmark's control, which must come out wrong, since a 16 x 16-bit product
needs 32 bits of mantissa.  Rows are taken in blocks sized to fit.

This file imports nothing of the program under test.
"""
from __future__ import annotations

import torch

from ffbench.reference.negacyclic_ntt import _no_tf32, primitive_root

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
WORDS = 8
LIMB_BITS = 16
LIMBS = 2 * WORDS          # limbs of one field element
MASK = (1 << LIMB_BITS) - 1
WIDE = 34                  # limbs of an unreduced sum of d products
BLOCK_ELEMENTS = 1 << 18   # rows x d of one block


def _limbs(v: int, n: int = LIMBS) -> list[int]:
    return [(v >> (LIMB_BITS * k)) & MASK for k in range(n)]


def _check_modulus(q: int):
    if not (1 << 253) <= q < (1 << 256):
        raise ValueError("the reduction is laid out for a 254- to 256-bit "
                         f"modulus, not {q.bit_length()} bits")


def twiddles(d: int, q: int, device=None) -> torch.Tensor:
    """W[i, j] = omega**(i j) mod q as a (d, d, 16) int64 tensor of 16-bit
    limbs, little-endian."""
    _check_modulus(q)
    omega = primitive_root(q, d)
    powers, p = [], 1
    for _ in range(d):
        powers.append(_limbs(p))
        p = p * omega % q
    table = torch.tensor(powers, dtype=torch.int64, device=device)
    i = torch.arange(d, dtype=torch.int64, device=device)[:, None]
    return table[(i * i.T) % d]


def _carry(x: torch.Tensor) -> torch.Tensor:
    """Propagate the carries of (..., L) int64 limbs of any sign whose value
    is not negative: limbs 0 .. L-2 end in [0, 2**16), and the last holds
    the rest (negative only when the value is)."""
    x = x.clone()
    for k in range(x.shape[-1] - 1):
        x[..., k + 1] += x[..., k] >> LIMB_BITS
        x[..., k] &= MASK
    return x


def _reduce(v: torch.Tensor, q: int) -> torch.Tensor:
    """(..., WIDE) carried limbs of a value below 2**544 -> (..., 16) limbs
    of the value mod q, in [0, q)."""
    dev = v.device
    fold = torch.tensor([_limbs(pow(2, LIMB_BITS * k, q))
                         for k in range(LIMBS, WIDE)], dtype=torch.int64,
                        device=dev)                      # (WIDE - 16, 16)
    low = torch.zeros(v.shape[:-1] + (LIMBS + 2,), dtype=torch.int64,
                      device=dev)
    low[..., :LIMBS] = v[..., :LIMBS]
    for k in range(WIDE - LIMBS):
        low[..., :LIMBS] += v[..., LIMBS + k, None] * fold[k]
    low = _carry(low)                                    # below 2**277
    # top = floor(low / 2**224) < 2**53 and q_top = floor(q / 2**224) >=
    # 2**29, so q_hat = top // (q_top + 1) is floor(low / q) or one less,
    # and low - q_hat q lies in [0, 2q)
    top = (low[..., 14] + (low[..., 15] << 16) + (low[..., 16] << 32)
           + (low[..., 17] << 48))
    q_hat = top // ((q >> 224) + 1)
    qq = torch.tensor(_limbs(q, LIMBS + 2), dtype=torch.int64, device=dev)
    rem = _carry(low - q_hat[..., None] * qq)
    less = _carry(rem - qq)
    rem = torch.where((less[..., -1] < 0)[..., None], rem, less)
    return rem[..., :LIMBS]


def transform(x: torch.Tensor, q: int, *, w: torch.Tensor | None = None,
              dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(n, d, 8) int64 words of elements in [0, q) -> (n, d, 8) int64 words
    of their forward transforms, canonical, on ``x``'s device, in blocks of
    rows."""
    _check_modulus(q)
    n, d, _ = x.shape
    if w is None:
        w = twiddles(d, q, x.device)
    w_mat = w.reshape(d, d * LIMBS).to(dtype)            # [i, j * 16 + m]
    out = torch.empty((n, d, WORDS), dtype=torch.int64, device=x.device)
    step = max(1, BLOCK_ELEMENTS // d)
    with _no_tf32():
        for lo in range(0, n, step):
            words = x[lo:lo + step]
            limbs = torch.stack([words & MASK, words >> LIMB_BITS],
                                dim=-1).flatten(-2)      # (b, d, 16)
            acc = torch.zeros(limbs.shape[:2] + (WIDE,), dtype=torch.int64,
                              device=x.device)
            for l in range(LIMBS):
                prod = limbs[..., l].to(dtype) @ w_mat   # (b, d * 16)
                acc[..., l:l + LIMBS] += torch.round(prod).to(
                    torch.int64).reshape(-1, d, LIMBS)
            y = _reduce(_carry(acc), q).reshape(-1, d, WORDS, 2)
            out[lo:lo + step] = y[..., 0] + (y[..., 1] << LIMB_BITS)
    return out

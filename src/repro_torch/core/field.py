"""Prime-field parameters and exact modular arithmetic on torch tensors.

Residues are carried in int64 tensors (every modulus here is < 2**31, so a
product of two residues is < 2**62 and exact).  torch implements no uint32
arithmetic on the CPU and only part of it on CUDA, so the JAX package's
uint32 forms become int64 forms with the same bits.  Moduli are Python ints
or int64 tensors that broadcast against the operands.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

# --- Field constants (host-side Python bignums) -----------------------------

# BN254 scalar field (Fr) — the NTT field of Groth16/PLONK over BN254.
BN254_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BN254_FR_TWO_ADICITY = 28

# CRYSTALS-Dilithium / ML-DSA prime, q = 2^23 - 2^13 + 1.
DILITHIUM_Q = 8380417
DILITHIUM_ZETA = 1753  # primitive 512th root of unity mod Q (FIPS 204)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field as staged on the accelerator."""

    name: str
    modulus: int          # Python bignum; may exceed 32 bits (BN254)
    limbs: int            # u8 limbs per 32-bit staged word
    n_channels: int       # RNS channels (1 = direct single-word field)

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()


DILITHIUM_FIELD = FieldSpec("dilithium", DILITHIUM_Q, limbs=3, n_channels=1)
BN254_FIELD = FieldSpec("bn254", BN254_FR, limbs=4, n_channels=9)


# --- Exact modular arithmetic (int64 tensors, residues < m < 2**31) ----------


def addmod(a, b, m):
    """(a + b) mod m for 0 <= a, b < m."""
    s = a + b
    return torch.where(s >= m, s - m, s)


def submod(a, b, m):
    """(a - b) mod m for 0 <= a, b < m."""
    return torch.where(a >= b, a - b, a + m - b)


def _shiftk_mod(x, m, k: int):
    """(x << k) mod m via k conditional doublings; 0 <= x < m."""
    for _ in range(k):
        x = x << 1
        x = torch.where(x >= m, x - m, x)
    return x


def shift8_mod(x, m):
    return _shiftk_mod(x, m, 8)


def shift16_mod(x, m):
    return _shiftk_mod(x, m, 16)


def mulmod(a, b, m):
    """(a * b) mod m, exact, for 0 <= a, b < m < 2**31.

    One int64 product (< 2**62) and a remainder: the same value as the JAX
    package's 16-bit schoolbook ``mulmod_u32``, which exists only because the
    TPU has no 64-bit multiply.
    """
    return torch.remainder(a.to(torch.int64) * b, m)


def negmod(a, m):
    return torch.where(a == 0, a, m - a)


def fold_diagonals(diags: torch.Tensor, m: int) -> torch.Tensor:
    """Fold limb-weight diagonals into a residue mod m (the "VPU fold").

    diags: int32 or int64 [..., n_diag]; diagonal k carries weight 2**(8k)
    and may be negative (balanced twiddle recode).  Returns int64 [...] =
    (Σ_k diags[..., k] << 8k) mod m, by Horner from the top diagonal with
    the floor-mod of each diagonal (``torch.remainder``, as ``jnp.mod``;
    never the truncating ``fmod``).  This is the plain version of the
    ``mont_fold`` kernel.
    """
    n_diag = diags.shape[-1]
    acc = torch.zeros(diags.shape[:-1], dtype=torch.int64, device=diags.device)
    for k in range(n_diag - 1, -1, -1):
        acc = shift8_mod(acc, m)
        dk = torch.remainder(diags[..., k].to(torch.int64), m)   # non-negative
        acc = addmod(acc, dk, m)
    return acc


@functools.lru_cache(maxsize=None)
def field_for(name: str) -> FieldSpec:
    if name == "dilithium":
        return DILITHIUM_FIELD
    if name == "bn254":
        return BN254_FIELD
    raise KeyError(name)

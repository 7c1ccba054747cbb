"""u8 limb decomposition / recomposition and balanced signed recoding.

Device operands (polynomial coefficients) are staged as **unsigned** u8 limbs,
twiddle matrices as **balanced signed** s8 limbs.  Balanced recoding keeps
every twiddle digit in [-128, 127], bounding each limb cross-product by
255·128 = 32,640 (paper §5.1).

The tensor functions take residues held in int32 or int64 tensors (values in
[0, 2**32)); torch has no usable uint32 arithmetic, so nothing here computes
in ``torch.uint32``.
"""
from __future__ import annotations

import numpy as np
import torch


def decompose_u8(x: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """Residues [...] -> u8 limb planes [..., n_limbs], little-endian."""
    x = x.to(torch.int64)
    limbs = [(x >> (8 * k)) & 0xFF for k in range(n_limbs)]
    return torch.stack(limbs, dim=-1).to(torch.uint8)


def recompose_u32(limbs: torch.Tensor) -> torch.Tensor:
    """u8 limb planes [..., n_limbs] -> int64 [...] (values < 2**32)."""
    limbs = limbs.to(torch.int64)
    out = torch.zeros(limbs.shape[:-1], dtype=torch.int64, device=limbs.device)
    for k in range(limbs.shape[-1] - 1, -1, -1):
        out = ((out << 8) + limbs[..., k]) & 0xFFFFFFFF
    return out


# --- Host-side (numpy / Python-int) helpers ---------------------------------


def balanced_residue(w: np.ndarray, m: int) -> np.ndarray:
    """Map residues in [0, m) to balanced representatives in (-m/2, m/2]."""
    w = w.astype(np.int64)
    return np.where(w > m // 2, w - m, w)


def signed_digits(x: np.ndarray, n_limbs: int) -> np.ndarray:
    """Balanced base-256 signed-digit recode of int64 values.

    Digits lie in [-128, 127]; covers |x| <= 127·(256^n - 1)/255 + eps, which
    holds for balanced residues of any modulus < 2**31 at n_limbs=4 and for
    balanced Dilithium residues (|x| <= Q/2 < 2**22) at n_limbs=3.
    """
    x = x.astype(np.int64)
    digits = np.zeros(x.shape + (n_limbs,), np.int64)
    rem = x.copy()
    for k in range(n_limbs):
        d = ((rem + 128) & 0xFF) - 128  # digit in [-128, 127], rem ≡ d (mod 256)
        digits[..., k] = d
        rem = (rem - d) >> 8
    if np.any(rem != 0):
        raise ValueError("values out of range for signed-digit recode")
    if np.any(digits > 127) or np.any(digits < -128):
        raise ValueError("digit overflow")
    return digits.astype(np.int8)


def unsigned_digits_np(x: np.ndarray, n_limbs: int) -> np.ndarray:
    """numpy little-endian u8 digit extraction (host twin of decompose_u8)."""
    x = x.astype(np.uint64)
    out = np.zeros(x.shape + (n_limbs,), np.uint8)
    for k in range(n_limbs):
        out[..., k] = ((x >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.uint8)
    return out


def signed_digits_value(digits: np.ndarray) -> np.ndarray:
    """Recompose signed digits back to int64 values (test helper)."""
    digits = digits.astype(np.int64)
    val = np.zeros(digits.shape[:-1], np.int64)
    for k in range(digits.shape[-1] - 1, -1, -1):
        val = (val << 8) + digits[..., k]
    return val

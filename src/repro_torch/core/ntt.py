"""Number Theoretic Transform matrices (host side, numpy / Python bignums).

* ``ntt_matrix`` / ``intt_matrix`` — the dense matrix-form NTT operand (the
  paper's O(d²) object) and its inverse.
* ``matrix_ntt_oracle_np`` — the exact bignum oracle ``(a @ W) mod m``.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.core import primes as P


def _power_table(base: int, count: int, m: int) -> np.ndarray:
    out = np.empty(count, object)
    acc = 1
    for k in range(count):
        out[k] = acc
        acc = acc * base % m
    return out.astype(np.uint32) if m < 2**32 else out


@functools.lru_cache(maxsize=64)
def _roots(m: int, order: int) -> int:
    return P.primitive_root_of_unity(m, order)


def ntt_matrix(d: int, m: int, *, negacyclic: bool = False) -> np.ndarray:
    """Dense forward-NTT matrix W (uint32, d×d) with y = a @ W (mod m).

    Cyclic:      W[i, j] = ω^{ij},          ω a primitive d-th root.
    Negacyclic:  W[i, j] = ψ^{i(2j+1)},     ψ a primitive 2d-th root
                 (evaluation at odd powers of ψ — the Dilithium convention).
    """
    if negacyclic:
        psi = _roots(m, 2 * d)
        table = _power_table(psi, 2 * d, m)
        i = np.arange(d, dtype=np.int64)[:, None]
        j = np.arange(d, dtype=np.int64)[None, :]
        idx = (i * (2 * j + 1)) % (2 * d)
        return table[idx]
    omega = _roots(m, d)
    table = _power_table(omega, d, m)
    i = np.arange(d, dtype=np.int64)[:, None]
    j = np.arange(d, dtype=np.int64)[None, :]
    idx = (i * j) % d
    return table[idx]


def intt_matrix(d: int, m: int, *, negacyclic: bool = False) -> np.ndarray:
    """Inverse transform matrix: (a @ W) @ Winv == a (mod m)."""
    dinv = pow(d, m - 2, m)
    if negacyclic:
        psi = _roots(m, 2 * d)
        psi_inv = pow(psi, 2 * d - 1, m)
        # Winv[j, i] = d^{-1} ψ^{-i(2j+1)}
        i = np.arange(d, dtype=np.int64)[None, :]
        j = np.arange(d, dtype=np.int64)[:, None]
        table = _power_table(psi_inv, 2 * d, m)
        idx = (i * (2 * j + 1)) % (2 * d)
        out = (table[idx].astype(object) * dinv) % m
        return out.astype(np.uint32)
    omega = _roots(m, d)
    omega_inv = pow(omega, d - 1, m)
    table = _power_table(omega_inv, d, m)
    i = np.arange(d, dtype=np.int64)[None, :]
    j = np.arange(d, dtype=np.int64)[:, None]
    idx = (i * j) % d
    out = (table[idx].astype(object) * dinv) % m
    return out.astype(np.uint32)


def matrix_ntt_oracle_np(a: np.ndarray, w: np.ndarray, m: int) -> np.ndarray:
    """Exact host oracle: (a @ W) mod m with Python bignums."""
    acc = a.astype(object) @ w.astype(object)
    return (acc % m).astype(np.uint32)

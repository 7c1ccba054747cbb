"""Number Theoretic Transform constructions.

* ``ntt_matrix`` / ``intt_matrix`` — the dense matrix-form NTT operand (the
  paper's O(d²) object) and its inverse, host numpy / Python bignums.
* ``matrix_ntt_oracle_np`` — the exact bignum oracle ``(a @ W) mod m``.
* ``cooley_tukey_ntt`` — the O(d log d) radix-2 NTT in plain torch int64
  ops on the input's device (the algorithmic baseline of Fig. 3), with its
  bignum oracle ``cooley_tukey_oracle_np``.
* ``morph_stage_matrices`` — the MORPH single-tenant baseline: the radix-2
  butterfly as log2(d) dense per-stage matrices (paper §7.2.1).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import field as F
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


# --- O(d log d) Cooley-Tukey in torch int64 ----------------------------------


def _bit_reverse_perm(d: int) -> np.ndarray:
    bits = d.bit_length() - 1
    idx = np.arange(d)
    rev = np.zeros(d, np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=64)
def _ct_stage_twiddles(d: int, m: int) -> tuple:
    """Per-stage twiddle vectors for iterative radix-2 DIT (cyclic)."""
    omega = _roots(m, d)
    stages = []
    span = 1
    while span < d:
        w_span = pow(omega, d // (2 * span), m)
        stages.append(_power_table(w_span, span, m))
        span *= 2
    return tuple(stages)


@functools.lru_cache(maxsize=64)
def _ct_tables(d: int, m: int, negacyclic: bool, device: torch.device) -> tuple:
    """(pre-twist or None, bit-reversal index, stage twiddles) as int64
    tensors on ``device``, uploaded once, so that a call enqueues no host
    copy and can be captured in a CUDA graph."""
    pre = None
    if negacyclic:
        pre = torch.as_tensor(
            _power_table(_roots(m, 2 * d), d, m).astype(np.int64), device=device)
    rev = torch.as_tensor(_bit_reverse_perm(d), device=device)
    tws = tuple(torch.as_tensor(tw.astype(np.int64), device=device)
                for tw in _ct_stage_twiddles(d, m))
    return pre, rev, tws


def cooley_tukey_ntt(a: torch.Tensor, m: int, *,
                     negacyclic: bool = False) -> torch.Tensor:
    """Radix-2 DIT NTT; a: (..., d) residues < m in an integer tensor.
    O(d log d) mulmods.  Returns int64 (..., d) on ``a``'s device.

    The JAX form is plain uint32 ``jnp`` ops, not a Pallas kernel; here it
    is plain torch ops in int64 (``field.mulmod``, ``addmod``, ``submod``):
    a pre-twist (negacyclic), a gather, then per stage one multiply, one
    add and one subtract mod m and a stack."""
    d = a.shape[-1]
    pre, rev, tws = _ct_tables(d, m, negacyclic, a.device)
    x = a.to(torch.int64)
    if pre is not None:
        x = F.mulmod(x, pre, m)
    x = x.index_select(-1, rev)
    for tw in tws:
        span = tw.shape[0]
        xr = x.reshape(x.shape[:-1] + (d // (2 * span), 2, span))
        u = xr[..., 0, :]
        t = F.mulmod(xr[..., 1, :], tw, m)
        x = torch.stack([F.addmod(u, t, m), F.submod(u, t, m)],
                        dim=-2).reshape(x.shape)
    return x


def cooley_tukey_oracle_np(a: np.ndarray, m: int, *,
                           negacyclic: bool = False) -> np.ndarray:
    """Host bignum oracle for the CT transform = matrix NTT (same convention).

    Cyclic CT computes â_j = Σ a_i ω^{ij}, which is a @ ntt_matrix.  The
    negacyclic form twists the input by ψ^i first and then takes the cyclic
    transform, so the oracle twists and reuses the cyclic matrix oracle.
    """
    if negacyclic:
        d = a.shape[-1]
        pre = _power_table(_roots(m, 2 * d), d, m).astype(object)
        a = (a.astype(object) * pre) % m
    w = ntt_matrix(a.shape[-1], m, negacyclic=False)
    return matrix_ntt_oracle_np(a, w, m)


# --- MORPH baseline: butterfly as dense per-stage GEMMs ----------------------


@functools.lru_cache(maxsize=16)
def morph_stage_matrices(d: int, m: int) -> tuple:
    """Dense (d×d) uint32 matrices S_1..S_log2(d) plus the bit-reversal
    permutation matrix P such that a @ P @ S_1 @ ... @ S_k == cyclic NTT(a).

    Built by applying the iterative butterfly stages to identity columns with
    bignum arithmetic — each S_s has exactly 2 nonzeros per row, but MORPH
    dispatches it as a dense tile-resident GEMM.
    """
    rev = _bit_reverse_perm(d)
    perm = np.zeros((d, d), np.uint32)
    perm[rev, np.arange(d)] = 1

    mats = []
    span = 1
    omega = _roots(m, d)
    while span < d:
        w_span = pow(omega, d // (2 * span), m)
        tw = _power_table(w_span, span, m)
        s = np.zeros((d, d), object)
        nblocks = d // (2 * span)
        for blk in range(nblocks):
            base = blk * 2 * span
            for j in range(span):
                u, v = base + j, base + span + j
                # lo = u + tw*v ; hi = u - tw*v   (row = input, col = output)
                s[u, u] = 1
                s[u, v] = 1
                s[v, u] = int(tw[j])
                s[v, v] = (m - int(tw[j])) % m
        mats.append((s % m).astype(np.uint32))
        span *= 2
    return (perm,) + tuple(mats)

"""The arithmetic of the fold that K2 and K3's epilogue run (``csrc/fold.cuh``).

The CUDA code runs only on the card, so its steps are repeated here in
numpy uint64, every 32-bit result masked to 32 bits as the kernel's
registers hold it: the constants the C entry computes on the host, the
diagonal biased by 2**31, Shoup's multiply-high reduction of each term to
[0, 2m), the conditional subtract, the bias term that makes the sum a floor
mod, and the tree of add-mods in the kernel's order.  The emulation is held
bit for bit against the port's plain fold (``core.field.fold_diagonals``,
the Horner reference) and the JAX package's Pallas ``mont_fold`` (interpret
mode), for n_diag 1 to 8, every int32 edge on every diagonal and the
moduli at both ends of the range.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import field as JF
from repro.core import rns as JR
from repro.kernels import mont_fold as j_mont_fold
from repro_torch.core import field as TF

U32 = np.uint64(0xFFFFFFFF)
EDGES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 1], np.int64)
MODULI = [2, 3, 17, JF.DILITHIUM_Q, JR.make_chain(9).moduli[0],
          JR.make_chain(18).moduli[-1], (1 << 31) - 99, 2**31 - 1]


def fold_consts(m: int, n_diag: int):
    """``make_fold_consts``: the weights w, Shoup's quotients wq and the
    bias, step by step as the C entry computes them."""
    w, wq, total, wk = [], [], 0, 1 % m
    for _ in range(n_diag):
        w.append(wk)
        wq.append((wk << 32) // m)
        total += wk
        wk = (wk << 8) % m
    bias = (m - (2**31 % m) * (total % m) % m) % m
    return w, wq, bias


def fold_emulated(diags: np.ndarray, m: int) -> np.ndarray:
    """``fold_diagonals`` of fold.cuh on int32 (..., n_diag) diagonals."""
    n_diag = diags.shape[-1]
    w, wq, bias = fold_consts(m, n_diag)
    mm = np.uint64(m)

    def min_sub(v):                     # min(v, v - m) in uint32
        return np.minimum(v, (v - mm) & U32)

    x = diags.astype(np.int32).view(np.uint32).astype(np.uint64) ^ np.uint64(2**31)
    terms = []
    for k in range(n_diag):
        q = (x[..., k] * np.uint64(wq[k])) >> np.uint64(32)      # __umulhi
        r = (x[..., k] * np.uint64(w[k]) - q * mm) & U32
        assert (r < 2 * mm).all(), "Shoup's bound: r in [0, 2m)"
        terms.append(min_sub(r))
    terms.append(np.full(diags.shape[:-1], bias, np.uint64))
    s = 1                               # add_tree: stride 1, 2, 4, 8
    while s < len(terms):
        for i in range(0, len(terms) - s, 2 * s):
            terms[i] = min_sub((terms[i] + terms[i + s]) & U32)
        s *= 2
    return terms[0]


def _diagonals(n_diag: int) -> np.ndarray:
    """int32 (8, R, n_diag): every combination of the int32 edges over the
    diagonals (at most 4,096, else each edge on all diagonals at once and
    4,096 random combinations), κ-summed diagonals over the whole int32
    range, and one pass's diagonals (|d| < 2**24)."""
    rng = np.random.default_rng(1000 + n_diag)
    if len(EDGES) ** n_diag <= 4096:
        idx = np.indices((len(EDGES),) * n_diag).reshape(n_diag, -1).T
    else:
        idx = np.concatenate([
            np.repeat(np.arange(len(EDGES))[:, None], n_diag, 1),
            rng.integers(0, len(EDGES), (4096, n_diag))])
    rows = np.concatenate([EDGES[idx],
                           rng.integers(-2**31, 2**31, (512, n_diag)),
                           rng.integers(-2**24, 2**24, (512, n_diag))])
    rows = np.resize(rows, (-(-len(rows) // 8) * 8, n_diag))
    return rows.astype(np.int32).reshape(8, -1, n_diag)


@pytest.mark.parametrize("m", MODULI)
@pytest.mark.parametrize("n_diag", range(1, 9))
def test_fold_arithmetic_matches_plain_and_pallas(n_diag, m):
    w, wq, bias = fold_consts(m, n_diag)
    assert w == [pow(2, 8 * k, m) for k in range(n_diag)]
    assert all(q < 2**32 and q == w_k * 2**32 // m for q, w_k in zip(wq, w))
    assert bias == -(2**31) * sum(w) % m
    diags = _diagonals(n_diag)
    got = fold_emulated(diags, m)
    plain = TF.fold_diagonals(torch.from_numpy(diags), m).numpy()
    pallas = np.asarray(j_mont_fold(jnp.asarray(diags), m))
    np.testing.assert_array_equal(got, plain.astype(np.uint64))
    np.testing.assert_array_equal(got, pallas.astype(np.uint64))

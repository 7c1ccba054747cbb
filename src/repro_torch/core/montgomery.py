"""Montgomery reduction phases: eager digit-12 REDC + the deferred κ-window fold.

**Eager path** — CIOS-style REDC over β = 2**12 digits: ``redc_digits(Y)``
returns the canonical digits of Y·β^{-nred} mod p.  With the
Montgomery-corrected CRT accumulation in
:func:`repro_torch.core.rns.rns_to_field` the β^{nred} factors cancel and the
output is exactly X mod p.  It is a long serial chain of small elementwise
ops (paper Table 3); on CUDA each op is one launch.

**Deferred path** (paper §7.2.1) — ``deferred_fold`` is the single modular
reduction per κ-window of the lazy discipline.  It runs the ``mont_fold``
kernel (:mod:`repro_torch.kernels.mont_fold`) unless ``fold_fn`` swaps it,
inside the scopes ``lazy_window_{i}/vpu_fold_lazy`` that the validator's
V6/V7 key on (one fold per window).
"""
from __future__ import annotations

import torch

from repro_torch.core import field as F
from repro_torch.core import wordarith as W
from repro_torch.core.zones import scope
from repro_torch.kernels.mont_fold.ops import mont_fold


def fold_diagonals_lax(diags: torch.Tensor, m: int) -> torch.Tensor:
    """The JAX package's window-scoped fold, bit for bit: the plain
    :func:`repro_torch.core.field.fold_diagonals` (Horner from the top
    diagonal, floor-mod of each).  Returns int64 (...).

    The JAX form emits every op through raw ``jax.lax`` primitives only so
    that XLA's name stack stays live per window (jnp's cached inner jits
    would stamp every window's ops with ``lazy_window_0``); the port tags
    calls with :func:`repro_torch.core.zones.scope`, which has no such
    cache, so nothing of that carries over.  :func:`deferred_fold`'s
    default on the card stays the ``mont_fold`` kernel (K2).
    """
    return F.fold_diagonals(diags, m)


def deferred_fold(acc_diag: torch.Tensor, modulus: int, *,
                  window_index: int = 0, fold_fn=None) -> torch.Tensor:
    """Fold one κ-window of unreduced diagonals to a canonical residue.

    acc_diag: int32 (..., n_diag) — the summed diagonals of every staging pass
    of window ``window_index`` (bounds proven by the lazy accumulator).
    ``fold_fn(acc_diag, modulus)`` overrides the reduction; the default is
    the ``mont_fold`` kernel wrapper (its plain version on a CPU tensor).
    The window scope is load-bearing: validator checks V6/V7 key on
    ``lazy_window_{i}/vpu_fold_lazy`` to count the folds of each window.
    """
    dev = acc_diag.device
    with scope(f"lazy_window_{window_index}", dev), \
            scope("vpu_fold_lazy", dev):
        return (fold_fn or mont_fold)(acc_diag, modulus)


def redc_digits(y_digits: torch.Tensor, chain) -> torch.Tensor:
    """y_digits: (..., ny) canonical digit-12 (ny >= nred + 2).

    Returns int64 (..., nred) canonical digits of Y·β^{-nred} mod p.
    """
    n = chain.n_red_digits
    p_dig = [int(x) for x in chain.p_digits]
    p_prime = int(chain.p_prime)
    mask = W.DIGIT_MASK

    ny = y_digits.shape[-1]
    t = [y_digits[..., j].to(torch.int64) for j in range(ny)]

    for _ in range(n):
        # The JAX uint32 product wraps mod 2**32; the low 12 bits that the
        # mask keeps are the same in int64.
        q = (t[0] * p_prime) & mask                      # < 2^12
        # t = (t + q·p) >> (one digit); running carry < 2^13
        carry = (t[0] + q * p_dig[0]) >> W.BETA_BITS
        for j in range(1, ny):
            pj = p_dig[j] if j < n else 0
            acc = t[j] + q * pj + carry                   # < 2^25
            t[j - 1] = acc & mask
            carry = acc >> W.BETA_BITS
        t[ny - 1] = carry

    out = torch.stack(t[:n], dim=-1)
    # REDC bound: result < 2p (top digits beyond nred are zero by range).
    return W.cond_subtract(out, chain.p_digits)


def digits_to_words_u32(digits: torch.Tensor) -> torch.Tensor:
    """(..., nd) digit-12 -> (..., ceil(nd·12/32)) 32-bit words (output form),
    each held in int64 (values < 2**32)."""
    nd = digits.shape[-1]
    total_bits = nd * W.BETA_BITS
    n_words = (total_bits + 31) // 32
    out = []
    d = digits.to(torch.int64)
    for w in range(n_words):
        lo_bit = 32 * w
        acc = torch.zeros(digits.shape[:-1], dtype=torch.int64,
                          device=digits.device)
        for j in range(nd):
            b = j * W.BETA_BITS - lo_bit
            if -W.BETA_BITS < b < 32:
                if b >= 0:
                    # uint32 shifts drop the bits above 2**32; mask them here
                    acc = acc | ((d[..., j] << b) & 0xFFFFFFFF)
                else:
                    acc = acc | (d[..., j] >> -b)
        out.append(acc)
    return torch.stack(out, dim=-1)

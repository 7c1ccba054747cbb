"""The K2 wrapper: checks, then the CUDA kernel or, on the CPU, the plain version."""
from __future__ import annotations

import torch

from repro_torch.core.zones import KERNEL_CALL, record_launch
from repro_torch.kernels.mont_fold.kernel import COUNTER, mont_fold_cuda
from repro_torch.kernels.mont_fold.ref import mont_fold_ref

MAX_DIAG = 8    # the kernel is instantiated for n_diag 1..8


def mont_fold(diags: torch.Tensor, modulus: int) -> torch.Tensor:
    """int32 (..., n_diag) -> int32 (...) folded mod m (values in [0, m)).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  Diagonals may be κ-pass sums of any int32 magnitude.
    An open launch log records the call on either device.
    """
    modulus = int(modulus)
    if not 1 < modulus < 2**31:
        raise ValueError(f"mont_fold needs 1 < m < 2**31, got {modulus}")
    if diags.dtype != torch.int32:
        raise TypeError(f"mont_fold takes int32 diagonals, got {diags.dtype}")
    if diags.dim() < 1 or not 1 <= diags.shape[-1] <= MAX_DIAG:
        raise ValueError(f"mont_fold needs 1..{MAX_DIAG} diagonals on the "
                         f"last axis, got shape {tuple(diags.shape)}")
    COUNTER.calls += 1
    with KERNEL_CALL:     # what the kernel runs, not its caller
        if diags.is_cuda:
            if not diags.is_contiguous():
                raise ValueError("mont_fold needs contiguous diagonals")
            out = mont_fold_cuda(diags, modulus)
        elif diags.is_cpu:
            out = mont_fold_ref(diags, modulus).to(torch.int32)
        else:
            raise ValueError(
                f"mont_fold runs on cuda or cpu, not {diags.device}")
    record_launch("mont_fold", (diags,), out, n_out=out.numel(),
                  n_diag=diags.shape[-1], modulus=modulus)
    return out


def mont_fold_window_fn():
    """``fold_fn`` adapter for the κ-window lazy mode: the
    ``fold_fn(acc_diag, modulus)`` contract of
    :func:`repro_torch.core.montgomery.deferred_fold`, through K2."""

    def fold(acc_diag, modulus):
        return mont_fold(acc_diag, int(modulus))

    return fold

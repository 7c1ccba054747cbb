"""ctypes binding of the K2 CUDA kernel ``mont_fold_launch``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

COUNTER = build.KernelCounter()


def mont_fold_cuda(diags: torch.Tensor, modulus: int) -> torch.Tensor:
    """Launch K2 on PyTorch's current stream of ``diags``' device.  The
    caller (``ops.mont_fold``) has checked dtype, n_diag, modulus and
    contiguity; a non-contiguous operand still raises here, before the C
    call.  Residues leave in an int32 tensor: the kernel writes uint32
    values < m < 2**31, whose bits are the same."""
    out = diags.new_empty(diags.shape[:-1])
    ptrs = build.pointers("mont_fold_launch", diags, out)
    n_out = out.numel()
    if n_out:
        build.launch("mont_fold_launch", diags, *ptrs, n_out,
                     diags.shape[-1], modulus)
        COUNTER.launches += 1
    return out


def grid_blocks(n_out: int) -> int:
    """Blocks in K2's grid for ``n_out`` outputs, as the launch computes
    them (builds the library on first use)."""
    return build.entries()["mont_fold_blocks"](n_out)

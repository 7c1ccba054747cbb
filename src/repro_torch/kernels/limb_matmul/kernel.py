"""ctypes binding of the K1 CUDA kernel ``limb_matmul_launch``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

COUNTER = build.KernelCounter()


def limb_matmul_cuda(a_u8: torch.Tensor, b_s8: torch.Tensor,
                     accum: str) -> torch.Tensor:
    """Launch K1 on PyTorch's current stream of the operands' device.  The
    caller (``ops.limb_matmul``) has checked dtypes, shapes, devices and
    contiguity; a non-contiguous operand still raises here, before the C
    call."""
    n, k = a_u8.shape
    m = b_s8.shape[1]
    out = a_u8.new_empty((n, m), dtype=torch.int32)
    ptrs = build.pointers("limb_matmul_launch", a_u8, b_s8, out)
    if n and m:
        build.launch("limb_matmul_launch", a_u8, *ptrs, n, k, m,
                     accum == "fp32_mantissa")
        COUNTER.launches += 1
    return out


def grid_blocks(n: int, m: int) -> int:
    """Blocks in K1's grid for an (n, ·, m) launch, as the kernel computes
    them (builds the library on first use)."""
    return build.entries()["limb_matmul_blocks"](n, m)

"""ctypes binding of the K3 CUDA kernel ``fused_ntt_tile_launch``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

COUNTER = build.KernelCounter()


def fused_ntt_tile_cuda(a_u8: torch.Tensor, b3_s8: torch.Tensor, modulus: int,
                        accum: str) -> torch.Tensor:
    """Launch K3 on PyTorch's current stream of the operands' device.  The
    caller (``ops.fused_ntt_tile``) has checked dtypes, shapes, devices,
    n_diag, modulus and contiguity.  Residues leave in an int32 tensor, as
    K2's do."""
    n, k = a_u8.shape
    _, d, n_diag = b3_s8.shape
    out = a_u8.new_empty((n, d), dtype=torch.int32)
    if n and d:
        build.launch("fused_ntt_tile_launch", a_u8, a_u8.data_ptr(),
                     b3_s8.data_ptr(), out.data_ptr(), n, k, d, n_diag,
                     modulus, accum == "fp32_mantissa")
        COUNTER.launches += 1
    return out

"""ctypes binding of the K3 CUDA kernel ``fused_ntt_tile_launch``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

COUNTER = build.KernelCounter()


def fused_ntt_tile_cuda(a_u8: torch.Tensor, b3_s8: torch.Tensor, modulus: int,
                        accum: str) -> torch.Tensor:
    """Launch K3 on PyTorch's current stream of the operands' device.  The
    caller (``ops.fused_ntt_tile``) has checked dtypes, shapes, devices,
    n_diag, modulus and contiguity; a non-contiguous operand still raises
    here, before the C call.  Residues leave in an int32 tensor, as K2's
    do."""
    n, k = a_u8.shape
    _, d, n_diag = b3_s8.shape
    out = a_u8.new_empty((n, d), dtype=torch.int32)
    ptrs = build.pointers("fused_ntt_tile_launch", a_u8, b3_s8, out)
    if n and d:
        build.launch("fused_ntt_tile_launch", a_u8, *ptrs, n, k, d, n_diag,
                     modulus, accum == "fp32_mantissa")
        COUNTER.launches += 1
    return out


def launch_grid(n: int, k: int, d: int, n_diag: int, b3_s8: torch.Tensor) -> dict:
    """K3's launch geometry for an (n, k, d, n_diag) call on ``b3_s8``, as
    the kernel computes it on the card that holds ``b3_s8`` (builds the
    library on first use): blocks in the grid, the cluster size (blocks
    splitting K for one output tile) and the variant that loads B (``bulk``
    copies or ``bytes``)."""
    index = b3_s8.get_device()
    if index < 0:
        raise ValueError("fused_ntt_tile_grid: the launch geometry needs a "
                         f"CUDA tensor, got one on {b3_s8.device}")
    out = (ctypes.c_int * 3)()
    build.check(build.entries()["fused_ntt_tile_grid"](
        n, k, d, n_diag, b3_s8.data_ptr(), index, ctypes.addressof(out)),
        "fused_ntt_tile_grid")
    return {"blocks": out[0], "cluster": out[1],
            "variant": "bulk" if out[2] else "bytes"}

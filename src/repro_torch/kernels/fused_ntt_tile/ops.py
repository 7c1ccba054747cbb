"""The K3 wrapper: checks, then the CUDA kernel or, on the CPU, the plain version."""
from __future__ import annotations

import torch

from repro_torch.core.zones import KERNEL_CALL, record_launch
from repro_torch.kernels.fused_ntt_tile.kernel import COUNTER, fused_ntt_tile_cuda
from repro_torch.kernels.fused_ntt_tile.ref import fused_ntt_tile_ref
from repro_torch.kernels.limb_matmul.ops import ACCUMS
from repro_torch.kernels.mont_fold.ops import MAX_DIAG


def fused_ntt_tile(a_u8: torch.Tensor, b3_s8: torch.Tensor, *, modulus: int,
                   accum: str = "int32_native") -> torch.Tensor:
    """(N, K) u8 × (K, D, n_diag) s8 -> int32 (N, D) folded mod m (values in
    [0, m)).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  No padding: the kernel masks ragged edges itself.  An
    open launch log records the call on either device.
    """
    modulus = int(modulus)
    if accum not in ACCUMS:
        raise ValueError(f"unknown accum {accum!r}; expected one of {ACCUMS}")
    if not 1 < modulus < 2**31:
        raise ValueError(f"fused_ntt_tile needs 1 < m < 2**31, got {modulus}")
    if a_u8.dtype != torch.uint8 or b3_s8.dtype != torch.int8:
        raise TypeError(f"fused_ntt_tile takes uint8 × int8, got "
                        f"{a_u8.dtype} × {b3_s8.dtype}")
    if a_u8.dim() != 2 or b3_s8.dim() != 3 or a_u8.shape[1] != b3_s8.shape[0]:
        raise ValueError(f"fused_ntt_tile shapes {tuple(a_u8.shape)} × "
                         f"{tuple(b3_s8.shape)} do not chain")
    if not 1 <= b3_s8.shape[2] <= MAX_DIAG:
        raise ValueError(f"fused_ntt_tile needs 1..{MAX_DIAG} diagonals on "
                         f"the last axis, got shape {tuple(b3_s8.shape)}")
    if a_u8.device != b3_s8.device:
        raise ValueError(f"operands on {a_u8.device} and {b3_s8.device}")
    COUNTER.calls += 1
    with KERNEL_CALL:     # what the kernel runs, not its caller
        if a_u8.is_cuda:
            if not (a_u8.is_contiguous() and b3_s8.is_contiguous()):
                raise ValueError(
                    "fused_ntt_tile needs contiguous row-major operands")
            out = fused_ntt_tile_cuda(a_u8, b3_s8, modulus, accum)
        elif a_u8.is_cpu:
            out = fused_ntt_tile_ref(a_u8, b3_s8, modulus,
                                     accum).to(torch.int32)
        else:
            raise ValueError(f"fused_ntt_tile runs on cuda or cpu, not "
                             f"{a_u8.device}")
    n, k = a_u8.shape
    _, d, n_diag = b3_s8.shape
    record_launch("fused_ntt_tile", (a_u8, b3_s8), out, n=n, k=k, d=d,
                  n_diag=n_diag, modulus=modulus,
                  fp32=accum == "fp32_mantissa")
    return out

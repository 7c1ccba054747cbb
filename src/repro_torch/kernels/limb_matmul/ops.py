"""The K1 wrapper: checks, then the CUDA kernel or, on the CPU, the plain version."""
from __future__ import annotations

import torch

from repro_torch.core.zones import KERNEL_CALL, record_launch
from repro_torch.kernels.limb_matmul.kernel import COUNTER, limb_matmul_cuda
from repro_torch.kernels.limb_matmul.ref import limb_matmul_ref

ACCUMS = ("fp32_mantissa", "int32_native")


def limb_matmul(a_u8: torch.Tensor, b_s8: torch.Tensor, *,
                accum: str = "int32_native") -> torch.Tensor:
    """(N, K) u8 × (K, M) s8 -> (N, M) int32.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  No padding: the kernel masks ragged edges itself.  An
    open launch log (:func:`repro_torch.core.zones.launch_log`) records the
    call on either device.
    """
    if accum not in ACCUMS:
        raise ValueError(f"unknown accum {accum!r}; expected one of {ACCUMS}")
    if a_u8.dtype != torch.uint8 or b_s8.dtype != torch.int8:
        raise TypeError(f"limb_matmul takes uint8 × int8, got "
                        f"{a_u8.dtype} × {b_s8.dtype}")
    if a_u8.dim() != 2 or b_s8.dim() != 2 or a_u8.shape[1] != b_s8.shape[0]:
        raise ValueError(f"limb_matmul shapes {tuple(a_u8.shape)} × "
                         f"{tuple(b_s8.shape)} do not chain")
    if a_u8.device != b_s8.device:
        raise ValueError(f"operands on {a_u8.device} and {b_s8.device}")
    COUNTER.calls += 1
    with KERNEL_CALL:     # what the kernel runs, not its caller
        if a_u8.is_cuda:
            if not (a_u8.is_contiguous() and b_s8.is_contiguous()):
                raise ValueError(
                    "limb_matmul needs contiguous row-major operands")
            out = limb_matmul_cuda(a_u8, b_s8, accum)
        elif a_u8.is_cpu:
            out = limb_matmul_ref(a_u8, b_s8, accum)
        else:
            raise ValueError(
                f"limb_matmul runs on cuda or cpu, not {a_u8.device}")
    n, k = a_u8.shape
    record_launch("limb_matmul", (a_u8, b_s8), out, n=n, k=k,
                  m=b_s8.shape[1], fp32=accum == "fp32_mantissa")
    return out

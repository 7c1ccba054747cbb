"""Plain PyTorch version of the limb-interleaved u8×s8 matmul."""
from __future__ import annotations

import torch


def limb_matmul_ref(a_u8: torch.Tensor, b_s8: torch.Tensor,
                    accum: str = "int32_native") -> torch.Tensor:
    """a: (N, K) u8, b: (K, M) s8 -> (N, M) int32.

    ``fp32_mantissa`` accumulates in float32 (the v4 MXU path) and casts to
    int32 at the end.  ``int32_native`` must give the int32 sum with its
    wrap-around; torch has no integer matmul on CUDA, so the product is taken
    in float64 — exact while |sum| < 2**53, i.e. for any K below 2**37 — and
    wrapped to int32 through int64.  The same code runs on the CPU and on the
    card.
    """
    if accum == "fp32_mantissa":
        return torch.mm(a_u8.to(torch.float32), b_s8.to(torch.float32)).to(
            torch.int32)
    out = torch.mm(a_u8.to(torch.float64), b_s8.to(torch.float64))
    return out.to(torch.int64).to(torch.int32)

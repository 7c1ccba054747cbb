"""Plain PyTorch version of the fused staging pass: limb matmul, then the fold."""
from __future__ import annotations

import torch

from repro_torch.core import field as F
from repro_torch.kernels.limb_matmul.ref import limb_matmul_ref


def fused_ntt_tile_ref(a_u8: torch.Tensor, b3_s8: torch.Tensor, modulus: int,
                       accum: str = "int32_native") -> torch.Tensor:
    """a: (N, K) u8, b3: (K, D, n_diag) s8 -> int64 (N, D) = fold(a @ b3) mod m.

    The diagonals are K1's int32 sums (wrapping, or fp32 cast to int32), so
    the result is K2's fold of K1's output, as the JAX oracle computes it.
    """
    k, d, n_diag = b3_s8.shape
    diags = limb_matmul_ref(a_u8, b3_s8.reshape(k, d * n_diag), accum)
    return F.fold_diagonals(diags.reshape(a_u8.shape[0], d, n_diag), modulus)

"""Hand-written CUDA kernels and their staged-transform adapters.

* ``limb_matmul`` (K1) — the u8×s8 limb GEMM of one staging pass, int32 or
  fp32-mantissa accumulation (``csrc/limb_matmul.cu``).
* ``mont_fold`` (K2) — the fold of limb-weight diagonals to residues mod m
  (``csrc/mont_fold.cu``).
* ``fused_ntt_tile`` (K3) — K1's GEMM with K2's fold as its epilogue, so the
  diagonals never reach device memory (``csrc/fused_ntt_tile.cu``).
* ``rns_redc`` — BN254's residues to the canonical element of F_p (the
  Shenoy–Kumaresan base extension and the digit-12 Montgomery reduction),
  its digits or its words written by the epilogue (``csrc/rns_redc.cu``).

Each wrapper launches its kernel on a CUDA tensor and runs the plain PyTorch
version on a CPU tensor.  :func:`repro_torch.core.limb_gemm.staged_transform`
(the multi-tenant replay's path) calls K1 and K2; ``tile_fn`` and
``mont_fold_window_fn`` are the explicit ``kernel_fn``/``fold_fn`` adapters,
as in the JAX package.  :func:`fused_transform` is the single-tenant fast
path: one K3 launch per staging pass, the counterpart of the JAX package's
``pallas_fused_transform``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import field as F
from repro_torch.core import limbs as L
from repro_torch.kernels.fused_ntt_tile.ops import fused_ntt_tile
from repro_torch.kernels.limb_matmul.ops import limb_matmul
from repro_torch.kernels.mont_fold.ops import mont_fold, mont_fold_window_fn
from repro_torch.kernels.rns_redc.ops import rns_redc

__all__ = ["fused_ntt_tile", "fused_operand_3d", "fused_transform",
           "limb_matmul", "mont_fold", "mont_fold_window_fn", "rns_redc",
           "tile_fn"]


def tile_fn():
    """``kernel_fn`` for staged_transform: K1 once per staging pass on the
    fused operand layout."""
    from repro_torch.core import limb_gemm as G

    def fn(a_tile, w_planes_tile, fused_tile, plan):
        if fused_tile is None:
            raise ValueError("tile fn requires the fused operand layout")
        return G.tile_diagonals(a_tile, None, fused_tile, plan)

    return fn


def _require_fused(plan):
    if plan.fused_operand is None:
        raise ValueError(f"the fused transform needs the fused operand layout; "
                         f"this plan (d={plan.d}) is per-plane")


def fused_operand_3d(plan) -> np.ndarray:
    """(d·La, d, n_diag) int8 view of the plan's fused operand, K3's layout."""
    _require_fused(plan)
    return plan.fused_operand.reshape(
        plan.d * plan.data_limbs, plan.d, plan.n_diag)


def fused_transform(a: torch.Tensor, plan, *, planes=None) -> torch.Tensor:
    """Full staged transform of one channel, one K3 launch per staging pass.

    a: (N, d) residues (< modulus) in an integer tensor.  Returns (N, d)
    int64, as :func:`repro_torch.core.limb_gemm.staged_transform` does.
    Eager folding (one fold per pass, inside the kernel), passes of the
    plan's own ``d_max``.  ``planes`` — the ``(w_planes, fused_operand)``
    device tensors of :func:`repro_torch.core.limb_gemm.plane_operands`;
    without them the fused operand is uploaded for this call.  A plan with
    no fused operand (d above ``fuse_below``) raises ValueError.
    """
    _require_fused(plan)
    la, d, m = plan.data_limbs, plan.d, plan.modulus
    fused = planes[1] if planes is not None else torch.as_tensor(
        plan.fused_operand, device=a.device)
    b3 = fused.view(d * la, d, plan.n_diag)
    n = a.shape[0]
    y = torch.zeros((n, d), dtype=torch.int64, device=a.device)
    for lo, hi in plan.tile_bounds():
        limbs = L.decompose_u8(a[:, lo:hi], la).reshape(n, -1)
        y = F.addmod(y, fused_ntt_tile(limbs, b3[lo * la:hi * la], modulus=m,
                                       accum=plan.accum), m)
    return y

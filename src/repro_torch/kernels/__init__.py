"""Hand-written CUDA kernels for the replay path, and their staged-transform adapters.

* ``limb_matmul`` (K1) — the u8×s8 limb GEMM of one staging pass, int32 or
  fp32-mantissa accumulation (``csrc/limb_matmul.cu``).
* ``mont_fold`` (K2) — the fold of limb-weight diagonals to residues mod m
  (``csrc/mont_fold.cu``).

Each wrapper launches its kernel on a CUDA tensor and runs the plain PyTorch
version on a CPU tensor.  :func:`repro_torch.core.limb_gemm.staged_transform`
calls both by default; ``tile_fn``/``mont_fold_window_fn`` are the explicit
``kernel_fn``/``fold_fn`` adapters, as in the JAX package.  The JAX
package's third kernel, ``fused_ntt_tile``, is not ported yet.
"""
from __future__ import annotations

from repro_torch.kernels.limb_matmul.ops import limb_matmul
from repro_torch.kernels.mont_fold.ops import mont_fold, mont_fold_window_fn

__all__ = ["limb_matmul", "mont_fold", "mont_fold_window_fn", "tile_fn"]


def tile_fn():
    """``kernel_fn`` for staged_transform: K1 once per staging pass on the
    fused operand layout."""
    from repro_torch.core import limb_gemm as G

    def fn(a_tile, w_planes_tile, fused_tile, plan):
        if fused_tile is None:
            raise ValueError("tile fn requires the fused operand layout")
        return G.tile_diagonals(a_tile, None, fused_tile, plan)

    return fn

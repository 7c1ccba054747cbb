"""Plain PyTorch version of the fold of limb diagonals mod m."""
from __future__ import annotations

import torch

from repro_torch.core import field as F


def mont_fold_ref(diags: torch.Tensor, m: int) -> torch.Tensor:
    """int (..., n_diag) weight-class diagonals -> int64 (...) mod m."""
    return F.fold_diagonals(diags, m)

"""Limb-interleaved exact matrix transforms (paper §5.1, §6.2).

A field dot product  y_j = Σ_i a_i · W_ij  (mod m)  is staged as:

  1. u8 limb planes of the data (unsigned) and balanced s8 limb planes of the
     twiddle matrix (signed) — :mod:`repro_torch.core.limbs`;
  2. one **fused interleaved GEMM** per staging pass: the limbs of both
     operands are interleaved into a single (N, d·La)×(d·La, d·n_diag)
     product whose K dimension accumulates the multi-limb convolution
     (Property 5.1 packing), or the identical per-plane form (La·Lw separate
     products) for large d.  Every product is the ``limb_matmul`` kernel (K1);
  3. the fold: under the **eager** discipline one fold per staging pass;
     under the **lazy** κ-amortised discipline (paper §7.2.1) unreduced int32
     diagonals accumulate across up to κ passes
     (:class:`repro_torch.core.accumulator.LazyWindowAccumulator` checks the
     overflow bound) and fold once per window.  Every fold is the
     ``mont_fold`` kernel (K2) unless ``fold_fn`` swaps it.

:func:`staged_transform_traced` takes the twiddle planes as an operand and
:func:`staged_transform_scan` pads to whole κ-windows as the JAX ``lax.scan``
form does; both run the same per-plane passes on K1 and K2.
:func:`matrix_transform_ref` is the plain mulmod/addmod oracle.

Accumulator models: ``fp32_mantissa`` (TPU v4, exact within 2**24) and
``int32_native`` (v5e/v5p, exact to 2**31 - 1).  The per-pass ceiling
d_max = ⌊window / (C · 32640)⌋ gives the paper's d_max^BN = 128 and
d_max^Dil = 171.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

from repro_torch.core import accumulator as ACC
from repro_torch.core import field as F
from repro_torch.core import limbs as L
from repro_torch.core.accumulator import (AccumModel, MAX_PIXEL_PRODUCT,  # noqa: F401
                                          accumulator_window)
from repro_torch.core.zones import scope
from repro_torch.kernels.limb_matmul.ops import limb_matmul
from repro_torch.kernels.mont_fold.ops import mont_fold

Reduction = Literal["eager", "lazy"]
REDUCTIONS = ("eager", "lazy")


def check_reduction(reduction: str, kappa: int | None = None) -> str:
    """Validate a reduction-mode string; with ``kappa``, also reject the
    eager+κ>1 combination (deferral depth only means something when folds
    are deferred)."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction mode {reduction!r}; "
                         f"expected one of {REDUCTIONS}")
    if reduction == "eager" and kappa not in (None, 1):
        raise ValueError("kappa-amortisation requires reduction='lazy' "
                         f"(got kappa={kappa} with eager folds)")
    return reduction


def lazy_window_sizes(n_passes: int, d_tile: int, c: int, accum: AccumModel,
                      kappa: int | None) -> tuple[int, ...]:
    """κ-window cut of a staged transform, overflow-checked for ``accum``;
    raises ValueError when κ exceeds κ_max(accum, d_tile, c)."""
    return ACC.window_plan(n_passes, kappa, ACC.kappa_max(accum, d_tile, c))


def staging_d_max(data_limbs: int, tw_limbs: int, accum: AccumModel) -> int:
    """Per-pass unpadded degree ceiling before VPU re-injection (Prop. 5.1)."""
    c = min(data_limbs, tw_limbs)  # densest convolution diagonal
    return accumulator_window(accum) // (c * MAX_PIXEL_PRODUCT)


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """Precompiled single-channel transform: twiddle limb planes + staging."""

    modulus: int
    d: int
    data_limbs: int
    tw_limbs: int
    accum: AccumModel
    w_planes: np.ndarray | None  # (d, d, Lw) int8, balanced signed digits;
    #                              None when the planes are an operand
    fused_operand: np.ndarray | None  # (d·La, d·n_diag) int8, or None for big d

    @property
    def n_diag(self) -> int:
        return self.data_limbs + self.tw_limbs - 1

    @property
    def d_max(self) -> int:
        return staging_d_max(self.data_limbs, self.tw_limbs, self.accum)

    @property
    def n_passes(self) -> int:
        return math.ceil(self.d / self.d_max)

    @property
    def gemms_per_pass(self) -> int:
        """K1 calls per staging pass: one on the fused layout, one per
        (p, q) limb pair in per-plane mode."""
        return 1 if self.fused_operand is not None else \
            self.data_limbs * self.tw_limbs

    def tile_bounds(self, d_max: int | None = None) -> list[tuple[int, int]]:
        step = d_max or self.d_max
        out, lo = [], 0
        while lo < self.d:
            hi = min(lo + step, self.d)
            out.append((lo, hi))
            lo = hi
        return out


def plane_operands(plan: ChannelPlan, device) -> tuple:
    """Device-resident copies of a plan's twiddle tensors, uploaded once.

    Returns ``(w_planes, fused_operand)`` int8 tensors with exactly one entry
    not None (matching the plan's mode); staging tiles are row slices of it.
    """
    if plan.fused_operand is not None:
        return (None, torch.as_tensor(plan.fused_operand, device=device))
    return (torch.as_tensor(plan.w_planes, device=device), None)


def _fused_operand(w_planes: np.ndarray, data_limbs: int) -> np.ndarray:
    """Interleave twiddle limb planes into the fused (d·La, d·n_diag) matrix."""
    d, d2, lw = w_planes.shape
    assert d == d2
    n_diag = data_limbs + lw - 1
    fused = np.zeros((d, data_limbs, d, n_diag), np.int8)
    for p in range(data_limbs):
        for q in range(lw):
            fused[:, p, :, p + q] = w_planes[:, :, q]
    return fused.reshape(d * data_limbs, d * n_diag)


def make_channel_plan(
    w_u32: np.ndarray,
    modulus: int,
    *,
    data_limbs: int,
    tw_limbs: int,
    accum: AccumModel = "fp32_mantissa",
    fuse_below: int = 2049,
) -> ChannelPlan:
    """Host-side precompilation of a channel twiddle matrix."""
    d = w_u32.shape[0]
    assert w_u32.shape == (d, d)
    balanced = L.balanced_residue(w_u32, modulus)
    planes = L.signed_digits(balanced, tw_limbs)  # (d, d, Lw) int8
    fused = _fused_operand(planes, data_limbs) if d <= fuse_below else None
    return ChannelPlan(
        modulus=modulus, d=d, data_limbs=data_limbs, tw_limbs=tw_limbs,
        accum=accum, w_planes=planes, fused_operand=fused,
    )


# --- Device-side diagonal computation ----------------------------------------


def tile_diagonals(a_tile: torch.Tensor, w_planes_tile, fused_tile,
                   plan: ChannelPlan) -> torch.Tensor:
    """Diagonal sums for one staging pass, every product through K1.

    a_tile: (N, dt) residues for this pass.
    w_planes_tile: (dt, d, Lw) int8 tensor — per-plane mode.
    fused_tile: (dt·La, d·n_diag) int8 tensor or None — fused mode.
    Returns int32 (N, d, n_diag).
    """
    n = a_tile.shape[0]
    la = plan.data_limbs
    limbs = L.decompose_u8(a_tile, la)  # (N, dt, La) u8
    with scope("mxu_pointwise", a_tile.device):
        if fused_tile is not None:
            a_flat = limbs.reshape(n, -1)   # (N, dt·La) — K = (i, p)
            out = limb_matmul(a_flat, fused_tile, accum=plan.accum)
            return out.reshape(n, plan.d, plan.n_diag)
        parts = []
        for k in range(plan.n_diag):
            terms = []
            for p in range(la):
                q = k - p
                if 0 <= q < plan.tw_limbs:
                    terms.append(limb_matmul(limbs[..., p].contiguous(),
                                             w_planes_tile[..., q].contiguous(),
                                             accum=plan.accum))
            parts.append(sum(terms[1:], terms[0]))
        return torch.stack(parts, dim=-1)


def _tile_step(d: int, d_max: int | None, ceiling: int,
               accum: AccumModel) -> int:
    """Width of a staging tile: ``d_max`` (default the per-pass ceiling),
    at most d.  Property 5.1: one staging pass must itself fit the
    accumulator window — an oversized tile silently rounds under fp32."""
    step = min(d_max or ceiling, d)
    if step > ceiling:
        raise ValueError(
            f"staging tile d_tile={step} exceeds the {accum} per-pass "
            f"ceiling d_max={ceiling}")
    return step


def staged_transform(
    a: torch.Tensor,
    plan: ChannelPlan,
    *,
    reduction: Reduction = "eager",
    kappa: int | None = None,
    kernel_fn=None,
    fold_fn=None,
    d_max: int | None = None,
    planes=None,
):
    """Full staged matrix transform of one channel.

    a: (N, d) residues (< modulus) in an integer tensor.
    Returns ((N, d) int64 result, stats dict with fold/pass/window counts).

    ``planes`` — optional ``(w_planes, fused_operand)`` device tensors (see
    :func:`plane_operands`); without them the plan's planes are uploaded
    for this call.
    ``kernel_fn(a_tile, w_tile, f_tile, plan)`` swaps the per-pass diagonal
    computation (default: :func:`tile_diagonals`, i.e. K1);
    ``fold_fn(diag, modulus)`` swaps the fold (default: K2).  Unlike the JAX
    package, ``fold_fn`` applies to the eager per-pass fold as well as the
    lazy window fold, so both run through K2 on the card.

    eager: fold after every staging pass; ``kappa`` must be None or 1.
    lazy: accumulate unreduced int32 diagonals across up to κ passes per
      window and fold once per window; ``kappa=None`` means one window for
      the whole transform.  κ is checked against κ_max and overflowing
      windows raise.

    The JAX package puts ``optimization_barrier`` between passes so XLA
    cannot fuse a fold into an open summation.  The port has no compiler to
    reorder the ops, but a captured CUDA graph does not complete them in
    program order either: K2 is a programmatic dependent of K1 (PDL), so
    K2's blocks start while K1 runs.  The scopes (``staging_pass_{t}``,
    ``mxu_pointwise``, ``vpu_fold``; ``lazy_window_{i}/vpu_fold_lazy``
    inside the accumulator's fold) tag every kernel call, and the
    structural validator (:mod:`repro_torch.core.validator`) checks the
    captured graph's nodes and edges against them: the K1 → K2 → next pass
    order (V1) and a path of full edges from each fold to the next pass's
    GEMM (V2).
    """
    check_reduction(reduction, kappa)
    step = _tile_step(plan.d, d_max, plan.d_max, plan.accum)
    if planes is None:
        planes = plane_operands(plan, a.device)
    return _staged_passes(a, plan, plan.tile_bounds(d_max), step, planes,
                          reduction=reduction, kappa=kappa,
                          kernel_fn=kernel_fn, fold_fn=fold_fn)


def _staged_passes(a, plan: ChannelPlan, tiles, step: int, planes, *,
                   reduction: Reduction, kappa: int | None, kernel_fn=None,
                   fold_fn=None):
    """The passes of a staged transform over the input column ranges
    ``tiles`` (each at most ``step`` wide): one ``kernel_fn`` call per pass,
    then a fold per pass (eager) or per κ-window (lazy).  Returns ((N, d')
    int64, stats), d' the output columns of the planes (``plan.d`` on the
    fused layout)."""
    kernel_fn = kernel_fn or tile_diagonals
    fold_fn = fold_fn or mont_fold
    m = plan.modulus
    n = a.shape[0]
    stats = {"n_passes": len(tiles), "n_folds": 0, "reduction": reduction,
             "kappa": 1, "n_windows": len(tiles)}

    acc = None
    if reduction == "lazy":
        c = min(plan.data_limbs, plan.tw_limbs)
        windows = lazy_window_sizes(len(tiles), step, c, plan.accum, kappa)
        stats["kappa"] = windows[0]
        stats["n_windows"] = len(windows)
        acc = ACC.LazyWindowAccumulator(plan.modulus, plan.accum, c,
                                        kappa=windows[0], fold_fn=fold_fn)

    w_full, f_full = planes
    cols = plan.d if w_full is None else w_full.shape[1]
    y = torch.zeros((n, cols), dtype=torch.int64, device=a.device)
    dev = a.device
    for t, (lo, hi) in enumerate(tiles):
        with scope(f"staging_pass_{t}", dev):
            a_tile = a[:, lo:hi]
            w_tile, f_tile = None, None
            if f_full is not None:
                la = plan.data_limbs
                f_tile = f_full[lo * la:hi * la]
            else:
                w_tile = w_full[lo:hi]
            diag = kernel_fn(a_tile, w_tile, f_tile, plan)
            if reduction == "eager":
                with scope("vpu_fold", dev):
                    y = F.addmod(y, fold_fn(diag, m), m)
                stats["n_folds"] += 1
        if reduction == "lazy":
            acc.add(diag, hi - lo)
            if acc.ready() or t + 1 == len(tiles):
                y = F.addmod(y, acc.fold(), m)
                stats["n_folds"] += 1
    return y, stats


# --- Traced-operand and scan forms (per-plane only) ---------------------------


def _planar_plan(w_planes: torch.Tensor, modulus: int, data_limbs: int,
                 accum: AccumModel) -> ChannelPlan:
    """The plan of a transform whose twiddle planes are an operand: its
    metadata only (``w_planes`` is the caller's tensor, no fused layout).
    The planes may be a block of output columns, (d, d', Lw): a mesh
    device's shard of the (d, d, Lw) planes; the plan's ``d`` is the input
    degree, which sets the passes."""
    if w_planes.dim() != 3 or w_planes.dtype != torch.int8:
        raise ValueError(f"w_planes must be (d, d', Lw) int8, got "
                         f"{tuple(w_planes.shape)} {w_planes.dtype}")
    d, _, tw_limbs = w_planes.shape
    return ChannelPlan(modulus=modulus, d=d, data_limbs=data_limbs,
                       tw_limbs=tw_limbs, accum=accum, w_planes=None,
                       fused_operand=None)


def staged_transform_traced(
    a: torch.Tensor,
    w_planes: torch.Tensor,
    *,
    modulus: int,
    data_limbs: int,
    accum: AccumModel = "fp32_mantissa",
    reduction: Reduction = "eager",
    kappa: int | None = None,
    barriers: bool = True,
    d_max: int | None = None,
) -> torch.Tensor:
    """Staged transform with the twiddle limb planes as an operand.

    w_planes: (d, d, Lw) int8 tensor (balanced signed digits) on the
    device of ``a``, in place of a plan's baked planes, or a block of its
    output columns (d, d', Lw), as one mesh device holds them.  Per-plane mode
    only: each (p, q) plane product is one ``limb_matmul`` call (K1), each
    fold one ``mont_fold`` call (K2), lazy windows go through
    :class:`~repro_torch.core.accumulator.LazyWindowAccumulator`.  The
    same passes, windows, checks and launches as :func:`staged_transform`
    on a per-plane plan: ⌈d / tile⌉ passes of La·Lw K1 calls each, and one
    K2 call per pass (eager) or per κ-window (lazy).  Returns (N, d') int64
    residues.

    ``barriers`` is accepted for the JAX signature.  There it places
    ``optimization_barrier`` between passes (or windows) so XLA cannot
    fuse a fold into an open summation; the port has no compiler to
    reorder the calls, and the structural validator checks the captured
    order (see :func:`staged_transform`).
    """
    plan = _planar_plan(w_planes, modulus, data_limbs, accum)
    return staged_transform(a, plan, reduction=reduction, kappa=kappa,
                            d_max=d_max, planes=(w_planes, None))[0]


def staged_transform_scan(
    a: torch.Tensor,
    w_planes: torch.Tensor,
    *,
    modulus: int,
    data_limbs: int,
    accum: AccumModel = "fp32_mantissa",
    d_max: int | None = None,
    reduction: Reduction = "eager",
    kappa: int | None = None,
) -> torch.Tensor:
    """The JAX package's ``lax.scan`` form of :func:`staged_transform_traced`.

    As there, the input rows are padded with zeros to a whole number of
    κ-windows of full tiles (κ = 1 when eager), and every pass is a full
    tile.  PyTorch has no scan to keep the program O(1) in the pass count,
    so the passes run unrolled, each on K1 and K2 as in the traced form;
    what stays is the padding: the zero tiles contribute zero diagonals but
    launch like any other.  With T = ⌈d / tile⌉ passes unpadded and
    κ_eff the window depth, this runs T' = ⌈T / κ_eff⌉·κ_eff passes:
    T'·La·Lw K1 calls, and T' K2 calls (eager) or T' / κ_eff (lazy).
    Returns (N, d') int64 residues, equal to the traced form's (the planes
    may be a block of output columns, as there).
    """
    check_reduction(reduction, kappa)
    plan = _planar_plan(w_planes, modulus, data_limbs, accum)
    d = plan.d
    step = _tile_step(d, d_max, plan.d_max, accum)
    k_eff = 1
    if reduction == "lazy":
        c = min(data_limbs, plan.tw_limbs)
        k_eff = lazy_window_sizes(math.ceil(d / step), step, c, accum,
                                  kappa)[0]
    pad = (-d) % (step * k_eff)
    if pad:
        a = torch.cat([a, a.new_zeros((a.shape[0], pad))], dim=1)
        w_planes = torch.cat(
            [w_planes, w_planes.new_zeros((pad,) + w_planes.shape[1:])])
    tiles = [(lo, lo + step) for lo in range(0, d + pad, step)]
    return _staged_passes(a, plan, tiles, step, (w_planes, None),
                          reduction=reduction, kappa=kappa)[0]


def matrix_transform_ref(a: torch.Tensor, w: torch.Tensor,
                         modulus: int) -> torch.Tensor:
    """Plain mulmod/addmod oracle: y = a @ W mod m, no limb machinery.

    a: (N, d) and w: (d, d') residues < m in integer tensors.  Returns
    (N, d') int64.  The JAX form adds the products one by one with addmod;
    here each chunk of rows of W sums its products (each < m < 2**31) in
    int64 before one remainder, which gives the same value.
    """
    a = a.to(torch.int64)
    w = w.to(torch.int64)
    n, d = a.shape
    cols = w.shape[1]
    y = torch.zeros((n, cols), dtype=torch.int64, device=a.device)
    step = max(1, (1 << 22) // max(1, n * cols))
    for lo in range(0, d, step):
        prod = F.mulmod(a[:, lo:lo + step, None], w[None, lo:lo + step], modulus)
        y = torch.remainder(y + prod.sum(dim=1), modulus)
    return y

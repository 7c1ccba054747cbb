"""Workload engines: the paper's unit-of-work "op" per cryptographic class.

* ``DilithiumEngine`` — forward negacyclic NTT over Q = 8,380,417 (3-limb
  u8×s8, single channel).  One op = one forward NTT of degree d (paper §7).
* ``BN254Engine``     — 9-channel ERNS matrix-form transform with
  CRT-consistent twiddles + per-coefficient Shenoy–Kumaresan / Montgomery
  reduction (paper §6.2).  ``n_channels=18`` selects the extended
  full-exactness chain (``bn254_full``).

Each class's requests take one form on the served path, which its engine
owns: ``operand_shape`` gives a launch's operand shape, ``launch_operand``
turns a stacked batch's host operand into the uint32 array the program
takes, and ``serve`` is the e2e that takes it.  A Dilithium row is one
uint32 word a coefficient; a ``bn254`` row is residues over its 9 channels
(the JAX package's form; raw integers are ingested on the host); a
``bn254_full`` row is field elements of F_r as 8 little-endian uint32
words, turned into residues and back into words on the device
(``BN254Engine.e2e_words``).

An engine lives on one device (CUDA unless ``device="cpu"``) and takes and
returns tensors there.  Its transform runs every staging-pass GEMM through
the ``limb_matmul`` kernel and every fold through ``mont_fold``, and BN254's
reduction to F_p through ``rns_redc``; on the CPU the kernel wrappers run
their plain versions.  A plan or chain computed elsewhere (e.g. carried
from the JAX package with :mod:`repro_torch.core.convert`) can be passed in
instead of being rebuilt.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core import field as F
from repro_torch.core import limb_gemm as G
from repro_torch.core import ntt as NTT
from repro_torch.core import rns as R
from repro_torch.core import zones as Z
from repro_torch.device import resolve_device
from repro_torch.kernels.rns_redc.ops import rns_redc


@dataclasses.dataclass(frozen=True)
class WorkloadClass:
    """Workload-class descriptor used by the scheduler for zone segregation."""

    name: str
    precision_zone: int    # limb count — MXU type-homogeneity class
    data_limbs: int
    tw_limbs: int
    n_channels: int


DILITHIUM = WorkloadClass("dilithium", precision_zone=3, data_limbs=3,
                          tw_limbs=3, n_channels=1)
BN254 = WorkloadClass("bn254", precision_zone=4, data_limbs=4, tw_limbs=4,
                      n_channels=9)
BN254_FULL = WorkloadClass("bn254_full", precision_zone=4, data_limbs=4,
                           tw_limbs=4, n_channels=18)

CLASSES = {c.name: c for c in (DILITHIUM, BN254, BN254_FULL)}


def _fold_profile(plans, reduction: str, kappa: int | None,
                  d_tile: int | None) -> dict:
    """Static fold/window census of an engine's transform (all channels
    share a plan shape).  Mirrors the window maths of
    :func:`repro_torch.core.limb_gemm.staged_transform` exactly; the replay's
    launch census checks the kernel call counters against it."""
    plan = plans[0]
    step = min(d_tile or plan.d_max, plan.d)
    if step > plan.d_max:
        raise ValueError(
            f"staging tile d_tile={step} exceeds the {plan.accum} per-pass "
            f"ceiling d_max={plan.d_max}")
    n_passes = math.ceil(plan.d / step)
    if reduction == "eager":
        windows_per_channel = n_passes
    else:
        c = min(plan.data_limbs, plan.tw_limbs)
        windows_per_channel = len(
            G.lazy_window_sizes(n_passes, step, c, plan.accum, kappa))
    return {
        "reduction": reduction,
        "kappa": kappa,
        "n_passes": n_passes,
        "n_channels": len(plans),
        "windows_per_channel": windows_per_channel,
        "n_folds": windows_per_channel * len(plans),
        "n_diag": plan.n_diag,
    }


def _operand(a, device: torch.device) -> torch.Tensor:
    """numpy uint32 or a tensor -> int64 tensor on ``device``."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a.astype(np.int64))
    return a.to(device=device, dtype=torch.int64)


class DilithiumEngine:
    """Forward negacyclic NTT over F_Q; exact end-to-end for all inputs."""

    wclass = DILITHIUM

    def __init__(self, d: int, *, accum: G.AccumModel = "fp32_mantissa",
                 reduction: G.Reduction = "eager", kappa: int | None = None,
                 d_tile: int | None = None, plan: G.ChannelPlan | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.d = d
        self.accum = accum
        self.reduction = G.check_reduction(reduction)
        self.kappa = kappa
        # Staging-pass tile override: None → the accumulator-window ceiling
        # d_max.  A smaller tile (e.g. the fp32-era 171) under int32_native
        # keeps the paper's pass structure while κ defers the folds.
        self.d_tile = d_tile
        # FIPS-204 negacyclic convention needs 2d | Q-1 (2-adicity 13 → d ≤
        # 4096); larger edge-polynomial degrees use the cyclic transform.
        self.negacyclic = (F.DILITHIUM_Q - 1) % (2 * d) == 0
        if plan is None:
            w = NTT.ntt_matrix(d, F.DILITHIUM_Q, negacyclic=self.negacyclic)
            plan = G.make_channel_plan(
                w, F.DILITHIUM_Q, data_limbs=3, tw_limbs=3, accum=accum)
        elif (plan.d, plan.modulus, plan.accum) != (d, F.DILITHIUM_Q, accum):
            raise ValueError("carried plan does not match this engine")
        self.plan = plan
        self.fold_profile = _fold_profile([self.plan], self.reduction, kappa,
                                          d_tile)
        self._device_planes = None

    @property
    def n_channels(self) -> int:
        return 1

    @property
    def n_passes(self) -> int:
        return self.fold_profile["n_passes"]

    @property
    def n_diag(self) -> int:
        return self.plan.n_diag

    @property
    def plans(self) -> list:
        return [self.plan]

    def device_planes(self):
        """Per-channel ``(w_planes, fused)`` twiddle tensors on the engine's
        device, uploaded once per engine."""
        if self._device_planes is None:
            self._device_planes = [G.plane_operands(self.plan, self.device)]
        return self._device_planes

    def evaluate(self, a, *, kernel_fn=None, fold_fn=None, planes=None):
        """(N, d) residues -> (N, d) int64 forward NTT (one op per row)."""
        dev = self.device
        with Z.workload_zone("dilithium", dev), Z.precision_zone(3, dev):
            y, self.last_stats = G.staged_transform(
                _operand(a, dev), self.plan, reduction=self.reduction,
                kappa=self.kappa, d_max=self.d_tile, kernel_fn=kernel_fn,
                fold_fn=fold_fn,
                planes=(planes or self.device_planes())[0])
        return y

    e2e = evaluate  # Dilithium op == the forward transform

    def operand_shape(self, rows: int) -> tuple:
        """A launch's operand shape: one word a coefficient."""
        return (rows, self.d)

    def launch_operand(self, a: np.ndarray) -> np.ndarray:
        """A stacked batch's (N, d) words as the program takes them."""
        return np.asarray(a, np.uint32)

    def serve(self, a, *, kernel_fn=None, fold_fn=None, planes=None):
        """The e2e of the class's served request form: ``e2e`` on words."""
        return self.e2e(a, kernel_fn=kernel_fn, fold_fn=fold_fn,
                        planes=planes)

    def oracle_np(self, a_np: np.ndarray) -> np.ndarray:
        w = NTT.ntt_matrix(self.d, F.DILITHIUM_Q, negacyclic=self.negacyclic)
        return NTT.matrix_ntt_oracle_np(a_np, w, F.DILITHIUM_Q)


class BN254Engine:
    """ERNS matrix transform + per-coefficient Montgomery reduction."""

    def __init__(self, d: int, *, accum: G.AccumModel = "fp32_mantissa",
                 reduction: G.Reduction = "eager", kappa: int | None = None,
                 d_tile: int | None = None, n_channels: int = 9,
                 p: int = F.BN254_FR, evaluation_matrix: np.ndarray | None = None,
                 chain: R.RnsChain | None = None, plans: list | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.wclass = BN254 if n_channels == 9 else BN254_FULL
        self.d = d
        self.accum = accum
        self.reduction = G.check_reduction(reduction)
        self.kappa = kappa
        self.d_tile = d_tile
        self.chain = chain if chain is not None else R.make_chain(n_channels, p=p)
        if len(self.chain.moduli) != n_channels or self.chain.p != p:
            raise ValueError("carried chain does not match this engine")
        # CRT-consistent evaluation operand: residues of one integer matrix Ω.
        if evaluation_matrix is None:
            evaluation_matrix = NTT.ntt_matrix(d, p)  # F_p NTT twiddles
        self.omega = evaluation_matrix
        if plans is None:
            plans = []
            for m in self.chain.moduli:
                w_ch = (evaluation_matrix.astype(object) % m).astype(np.uint32)
                plans.append(G.make_channel_plan(
                    w_ch, m, data_limbs=4, tw_limbs=4, accum=accum))
        elif [(pl.d, pl.modulus, pl.accum) for pl in plans] != \
                [(d, m, accum) for m in self.chain.moduli]:
            raise ValueError("carried plans do not match this engine's chain")
        self.plans = list(plans)
        self.fold_profile = _fold_profile(self.plans, self.reduction, kappa,
                                          d_tile)
        self._device_planes = None

    @property
    def n_channels(self) -> int:
        return len(self.chain.moduli)

    @property
    def n_passes(self) -> int:
        return self.fold_profile["n_passes"]

    @property
    def n_diag(self) -> int:
        return self.plans[0].n_diag

    def ingest(self, coeffs_np: np.ndarray) -> torch.Tensor:
        """Host object-int coefficients [..., d] -> (..., d, C) int64 residues
        on the engine's device."""
        return _operand(R.to_rns_np(coeffs_np, self.chain), self.device)

    def device_planes(self):
        """Per-channel ``(w_planes, fused)`` twiddle tensors on the engine's
        device, uploaded once per engine."""
        if self._device_planes is None:
            self._device_planes = [G.plane_operands(p, self.device)
                                   for p in self.plans]
        return self._device_planes

    def evaluate(self, a_res, *, kernel_fn=None, fold_fn=None, planes=None):
        """(N, d, C) residues -> (N, d, C) int64 transformed residues."""
        dev = self.device
        a_res = _operand(a_res, dev)
        planes = planes or self.device_planes()
        outs = []
        self.last_stats = None
        with Z.workload_zone("bn254", dev), Z.precision_zone(4, dev):
            for ci, plan in enumerate(self.plans):
                with Z.scope(f"channel_{ci}", dev):
                    y, st = G.staged_transform(
                        a_res[..., ci], plan, reduction=self.reduction,
                        kappa=self.kappa, d_max=self.d_tile,
                        kernel_fn=kernel_fn, fold_fn=fold_fn,
                        planes=planes[ci])
                outs.append(y)
                self.last_stats = st
            return torch.stack(outs, dim=-1)

    def reduce(self, y_res: torch.Tensor, *, form: str = "digits"
               ) -> torch.Tensor:
        """(N, d, C) int64 transformed residues -> (N, d, nred) int64 field
        digits, or with ``form="words"`` (N, d, n_words) int64 words (each
        < 2**32) of the canonical element: ``rns_to_field`` in one kernel
        (``rns_redc``; its plain version on the CPU)."""
        dev = self.device
        with Z.workload_zone("bn254", dev), Z.scope("vpu_montgomery", dev):
            return rns_redc(y_res, self.chain, form=form)

    def e2e(self, a_res, *, kernel_fn=None, fold_fn=None, planes=None):
        """The paper's BN254 op for N stacked tenant rows."""
        return self.reduce(self.evaluate(a_res, kernel_fn=kernel_fn,
                                         fold_fn=fold_fn, planes=planes))

    def ingest_words(self, words) -> torch.Tensor:
        """(N, d, n_words) little-endian words of field elements (int32
        holding uint32 bits, or any integer dtype) -> (N, d, C) int64
        residues, on the engine's device."""
        dev = self.device
        with Z.workload_zone("bn254", dev), Z.scope("bn254_ingest", dev):
            return R.words_to_rns(_operand(words, dev), self.chain)

    def e2e_words(self, words, *, kernel_fn=None, fold_fn=None, planes=None):
        """The served ``bn254_full`` op: (N, d, n_words) words of field
        elements -> (N, d, n_words) words of y mod p, every step on the
        engine's device: ingest, the channels, and the reduction, which
        writes the words."""
        y = self.evaluate(self.ingest_words(words), kernel_fn=kernel_fn,
                          fold_fn=fold_fn, planes=planes)
        return self.reduce(y, form="words")

    def operand_shape(self, rows: int) -> tuple:
        """A launch's operand shape: ``bn254_full`` takes a field element
        as ``chain.n_words`` words, ``bn254`` its residues."""
        if self.wclass is BN254_FULL:
            return (rows, self.d, self.chain.n_words)
        return (rows, self.d, self.n_channels)

    def launch_operand(self, a: np.ndarray) -> np.ndarray:
        """A stacked batch's host operand as the program takes it: words
        or residues as they come; ``bn254`` raw integers (N, d) ingested
        here into residues (N, d, C)."""
        if self.wclass is BN254 and a.ndim == 2:
            return R.to_rns_np(a.astype(object), self.chain)
        return np.asarray(a, np.uint32)

    def serve(self, operand, *, kernel_fn=None, fold_fn=None, planes=None):
        """The e2e of the class's served request form: ``e2e_words`` for
        ``bn254_full``, ``e2e`` on residues for ``bn254``."""
        e2e = self.e2e_words if self.wclass is BN254_FULL else self.e2e
        return e2e(operand, kernel_fn=kernel_fn, fold_fn=fold_fn,
                   planes=planes)

    # --- host oracles ---------------------------------------------------------

    def oracle_eval_np(self, coeffs_np: np.ndarray) -> np.ndarray:
        """Exact bignum evaluation X_j = Σ a_i Ω_ij (object ints)."""
        return coeffs_np.astype(object) @ self.omega.astype(object)

    def in_envelope(self, coeffs_np: np.ndarray) -> bool:
        x = self.oracle_eval_np(coeffs_np)
        return int(np.max(x)) < self.chain.M


@functools.lru_cache(maxsize=32)
def make_engine(name: str, d: int, accum: str = "fp32_mantissa",
                reduction: str = "eager", kappa: int | None = None,
                d_tile: int | None = None, device: str | None = None):
    """Process-wide engine cache, one engine per configuration and device
    (pass the device as a string, e.g. ``"cuda:0"`` or ``"cpu"``)."""
    kw = dict(accum=accum, reduction=reduction, kappa=kappa, d_tile=d_tile,
              device=device)
    if name == "dilithium":
        return DilithiumEngine(d, **kw)
    if name == "bn254":
        return BN254Engine(d, n_channels=9, **kw)
    if name == "bn254_full":
        return BN254Engine(d, n_channels=18, **kw)
    raise KeyError(name)

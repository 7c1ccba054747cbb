"""Accumulator disciplines: exactness windows and κ-amortisation.

The two accumulator models the paper measures, and what the staged transform
derives from their window bound W(accum):

* ``fp32_mantissa`` (TPU v4 path) — partial sums materialise through an FP32
  accumulator; exact iff every unreduced integer stays <= 2**24;
* ``int32_native`` (v5e/v5p path) — true int32 accumulation, exact through
  2**31 - 1.

The κ_max derivation (``kappa_max``): one staging pass over a tile of
``d_tile`` coefficients produces limb-convolution diagonals bounded by
``d_tile · c · MAX_PIXEL_PRODUCT`` (c = densest diagonal multiplicity).
Deferring the fold across κ passes keeps the unreduced sum exact iff
``κ · d_tile · c · MAX_PIXEL_PRODUCT <= W(accum)``.  ``kappa_max_bruteforce``
re-derives the same number by direct search.  ``LazyWindowAccumulator`` is
the κ-window accumulator :func:`repro_torch.core.limb_gemm.staged_transform`
drives in lazy mode: it sums unreduced int32 diagonals across passes, checks
the analytic bound on every add, and folds once per window through
:func:`repro_torch.core.montgomery.deferred_fold`.

The Table-1 probes (``probe_exact``, ``table1_rows``) ask whether the
accumulator path reproduces a partial sum S near and past the fp32 window;
in the port that path is one ``limb_matmul`` call (K1 on the card).
"""
from __future__ import annotations

import math
from typing import Literal

import numpy as np
import torch

# u8 × s8 worst-case pixel product (paper §5.1); the twiddle recode is
# balanced-signed, so |w| <= 128 while data limbs stay unsigned <= 255.
MAX_PIXEL_PRODUCT = 255 * 128

AccumModel = Literal["fp32_mantissa", "int32_native"]

_WINDOW = {"fp32_mantissa": 1 << 24, "int32_native": (1 << 31) - 1}


def accumulator_window(accum: AccumModel) -> int:
    """Largest S such that every integer in [-S, S] survives the accumulator."""
    return _WINDOW[accum]


# --- κ-amortisation bound (paper §7.2.1) --------------------------------------


def pass_bound(d_tile: int, c: int,
               pixel_product: int = MAX_PIXEL_PRODUCT) -> int:
    """Worst-case |diagonal entry| contributed by ONE staging pass.

    Each diagonal entry sums ``d_tile`` coefficient positions × at most ``c``
    limb pairs × one u8·s8 product each; signs can align, so the triangle
    bound is attained (all data limbs 255, all twiddle limbs ±128).
    """
    return d_tile * c * pixel_product


def kappa_max(accum: AccumModel, d_tile: int, c: int,
              pixel_product: int = MAX_PIXEL_PRODUCT) -> int:
    """Analytic max deferral depth: most passes one window may accumulate.

    Derivation: after κ passes the unreduced sum is bounded by
    κ · pass_bound; exactness requires that bound <= W(accum).  κ_max = 0
    means even a single pass of this tile width overflows the discipline —
    the tile itself is illegal.
    """
    return accumulator_window(accum) // pass_bound(d_tile, c, pixel_product)


def exact_window_bruteforce(accum: AccumModel) -> int:
    """Largest S with [0, S] fully representable, found by search (not formula).

    Doubling scan + bisection over the first integer the accumulator cannot
    hold: for fp32 that is the first non-representable integer (2**24 + 1),
    for int32 the first value past the two's-complement ceiling.
    """
    if accum == "int32_native":
        # int32 holds every integer up to the type ceiling; probe the dtype
        # itself (wrap-around cast) rather than trusting the formula.
        def fits(v: int) -> bool:
            return int(np.array(v, np.int64).astype(np.int32)) == v
    else:
        def fits(v: int) -> bool:
            return float(np.float32(v)) == float(v)

    # [0, S] is fully representable iff S and S-1 both fit: once the float
    # spacing exceeds 1 no two consecutive integers fit, so the predicate is
    # monotone and bisectable (isolated representable evens don't fool it).
    def contig(s: int) -> bool:
        return fits(s) and fits(s - 1)

    hi = 2
    while contig(hi):
        hi *= 2
    lo = hi // 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if contig(mid):
            lo = mid
        else:
            hi = mid
    return lo


def pass_bound_bruteforce(d_tile: int, la: int, lw: int,
                          data_max: int = 255, tw_mag: int = 128) -> int:
    """Exhaustive worst-case |diagonal| over extreme operand assignments.

    For small (d_tile, la, lw) word sizes, enumerate every extreme data/twiddle
    limb assignment (data in {0, data_max}, twiddles in {-tw_mag, +tw_mag})
    and maximise |Σ_i Σ_{p+q=k} a_p[i] · w_q[i]| over diagonals k.  Matches
    ``pass_bound(d_tile, min(la, lw))`` — the analytic triangle bound is tight.
    """
    n_diag = la + lw - 1
    best = 0
    data_choices = [0, data_max]
    tw_choices = [-tw_mag, tw_mag]
    n_a = len(data_choices) ** (d_tile * la)
    n_w = len(tw_choices) ** (d_tile * lw)
    if n_a * n_w > 1 << 20:
        raise ValueError("word size too large for exhaustive search")
    for ai in range(n_a):
        a = [[data_choices[(ai >> (i * la + p)) & 1] for p in range(la)]
             for i in range(d_tile)]
        for wi in range(n_w):
            w = [[tw_choices[(wi >> (i * lw + q)) & 1] for q in range(lw)]
                 for i in range(d_tile)]
            for k in range(n_diag):
                s = sum(a[i][p] * w[i][k - p]
                        for i in range(d_tile)
                        for p in range(la) if 0 <= k - p < lw)
                best = max(best, abs(s))
    return best


def kappa_max_bruteforce(accum: AccumModel, d_tile: int, la: int, lw: int,
                         data_max: int = 255, tw_mag: int = 128) -> int:
    """κ_max by direct search: brute-force window / brute-force pass bound."""
    bound = pass_bound_bruteforce(d_tile, la, lw, data_max, tw_mag)
    return exact_window_bruteforce(accum) // bound


def window_plan(n_passes: int, kappa: int | None, k_max: int) -> tuple[int, ...]:
    """Cut ``n_passes`` staging passes into κ-sized deferral windows.

    ``kappa=None`` selects the whole-transform single-window discipline (the
    MORPH-style fully-lazy mode).  Raises ``ValueError`` when the requested
    depth exceeds the analytic κ_max — this is the overflow check:
    a window the discipline cannot prove exact never runs.
    """
    if n_passes < 1:
        raise ValueError(f"need >= 1 staging pass, got {n_passes}")
    k_eff = n_passes if kappa is None else kappa
    if k_eff < 1:
        raise ValueError(f"kappa must be >= 1, got {kappa}")
    if k_eff > k_max:
        raise ValueError(
            f"deferral depth kappa={k_eff} exceeds kappa_max={k_max} for this "
            f"accumulator discipline — the unreduced window would overflow")
    n_windows = math.ceil(n_passes / k_eff)
    sizes = [k_eff] * (n_passes // k_eff)
    if n_passes % k_eff:
        sizes.append(n_passes % k_eff)
    assert len(sizes) == n_windows and sum(sizes) == n_passes
    return tuple(sizes)


class LazyWindowAccumulator:
    """κ-window deferred-reduction accumulator.

    Sums unreduced int32 diagonal planes across up to κ staging passes and
    folds once per window.  Every ``add`` re-checks the analytic magnitude
    bound (covering ragged final tiles, whose true bound is smaller than the
    uniform κ·d_tile estimate), so an overflow-unsafe window raises before
    anything is summed instead of silently wrapping on the device.
    """

    def __init__(self, modulus: int, accum: AccumModel, c: int, *,
                 kappa: int, fold_fn=None):
        self.modulus = modulus
        self.accum = accum
        self.c = c
        self.kappa = kappa
        self.window_limit = accumulator_window(accum)
        self.fold_fn = fold_fn
        self._acc = None
        self._bound = 0          # worst-case |entry| of the pending window
        self._n_pending = 0      # passes accumulated since the last fold
        self.window_index = 0    # folds emitted so far (scopes the fold)
        self.n_folds = 0

    def add(self, diag, d_tile: int):
        """Accumulate one pass's diagonals (int32 (N, d, n_diag))."""
        new_bound = self._bound + pass_bound(d_tile, self.c)
        if new_bound > self.window_limit:
            raise ValueError(
                f"lazy window overflow: accumulating a d_tile={d_tile} pass "
                f"would raise the unreduced bound to {new_bound} > "
                f"{self.window_limit} ({self.accum} window)")
        if self._n_pending >= self.kappa:
            raise ValueError(
                f"window already holds kappa={self.kappa} passes — fold first")
        self._acc = diag if self._acc is None else self._acc + diag
        self._bound = new_bound
        self._n_pending += 1

    @property
    def pending(self) -> int:
        return self._n_pending

    def ready(self) -> bool:
        return self._n_pending >= self.kappa

    def fold(self):
        """Fold the pending window to a canonical residue; resets the window."""
        from repro_torch.core import montgomery as MONT
        if self._acc is None:
            raise ValueError("fold() on an empty window")
        y = MONT.deferred_fold(self._acc, self.modulus,
                               window_index=self.window_index,
                               fold_fn=self.fold_fn)
        self._acc = None
        self._bound = 0
        self._n_pending = 0
        self.window_index += 1
        self.n_folds += 1
        return y


# --- Table 1 probes (paper Table 1) -------------------------------------------


def _operands_for_target(s: int) -> tuple[np.ndarray, np.ndarray]:
    """u8/s8 operand pair whose exact dot product equals -s (s >= 0).

    The probe accumulates toward the negative target so every rhs entry is
    s8-representable.  Steps use the *odd* pixel product 253·127 = 32,131 so
    partial sums land on generic (odd) integers — an aligned all-(255·128)
    pattern would stay fp32-exact by 2-adic alignment and mask the mantissa
    ceiling the paper probes.
    """
    step = 253 * 127
    n_full, rem = divmod(s, step)
    lhs = [253] * n_full
    rhs = [-127] * n_full
    if rem:
        q, r = divmod(rem, 253)
        if q:
            lhs.append(253)
            rhs.append(-q)
        if r:
            lhs.append(r)
            rhs.append(-1)
    lhs_a = np.asarray(lhs, np.uint8)[None, :]
    rhs_a = np.asarray(rhs, np.int8)[:, None]
    return lhs_a, rhs_a


def probe_sum(s: int, accum: AccumModel, *, device=None) -> int:
    """The sum the accumulator path returns for target ``s``: one
    ``limb_matmul`` call, (1, K) u8 × (K, 1) s8 with ``accum`` the model,
    whose exact value is -s.  On the card that is K1, which splits K over
    128 threads and adds their partial sums in a tree; on the CPU it is
    K1's plain version (``torch.mm`` in float32, or exact in float64 and
    wrapped to int32)."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels.limb_matmul.ops import limb_matmul
    dev = resolve_device(device)
    lhs, rhs = _operands_for_target(s)
    out = limb_matmul(torch.as_tensor(lhs, device=dev),
                      torch.as_tensor(rhs, device=dev), accum=accum)
    return int(out[0, 0])


def probe_exact(s: int, accum: AccumModel, *, device=None) -> bool:
    """True iff the accumulator path reproduces the exact partial sum |S|."""
    return probe_sum(s, accum, device=device) == -s


# Paper Table 1 probe targets.
TABLE1_TARGETS = (2**23, 2**24 - 1, 2**24, 2**24 + 1, 2**25 - 1, 2**28, 2**30)


def table1_rows(*, device=None) -> dict[str, list[bool]]:
    """``probe_exact`` of every Table-1 target under both models, on CUDA
    unless ``device="cpu"``.  The keys are the JAX package's, so the rows
    compare key for key; on the card they name the accumulator model K1
    runs (fp32 FFMA, int32 wrapping), not a TPU."""
    return {
        "tpu_v4_fp32_mantissa": [probe_exact(s, "fp32_mantissa", device=device)
                                 for s in TABLE1_TARGETS],
        "tpu_v5_int32_native": [probe_exact(s, "int32_native", device=device)
                                for s in TABLE1_TARGETS],
    }

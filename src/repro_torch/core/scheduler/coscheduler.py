"""Tier 2 — the Slice-Level Co-Scheduler (paper §4.1) + the dispatch fast path.

Maps workload-homogeneous stacked batches onto disjoint device groups so
heterogeneous primitives (Dilithium next to BN254) run on their own devices
when there are several.  How the JAX package's mechanisms map here:

* a ``Mesh`` per workload group becomes a ``torch.device`` per group (the
  group's first device; row-sharding one launch across GPUs is not ported);
* the jit cache per ``(workload, d_bucket)`` becomes a cache of captured
  programs (:mod:`repro_torch.core.scheduler.program`), one per launched
  operand shape: on CUDA each is the engine's whole ``e2e`` (K1/K2 for
  every pass and channel, BN254's ``rns_to_field``) as one CUDA graph, so
  every dispatch replays one program per launch group.
  ``trace_counts[(w, d)]`` counts the captures, as the JAX count counts the
  retraces, so the ladder bounds it the same way;
* ``copy_to_host_async`` becomes a launch slot of the program
  (:class:`~repro_torch.core.scheduler.program.LaunchSlot`): the operand is
  merged into the slot's pinned input, one graph replay copies it in, runs
  the e2e and copies the result into the slot's pinned output, and the
  slot's CUDA event, which ``gather`` waits on, is recorded behind it.  The
  slot is held until the gather has copied the rows out, so no later
  launch writes a slot that a flight can still gather;
* ``donate`` is recorded only: the program's static input is the donated
  buffer, written by every launch and owned by the program.

The three levers are kept and stay bit-for-bit neutral: M-axis
super-batching (``merge``), the row ladder (``row_ladder``), and the
two-phase ``launch_mixed``/``gather`` pipeline.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.core import limb_gemm as G
from repro_torch.core import workloads as WK
from repro_torch.core.scheduler.program import E2EProgram, capture_pool
from repro_torch.core.scheduler.rectangular import StackedBatch, merge_operands
from repro_torch.device import resolve_devices
from repro_torch.obs.tracing import clock

# Bounded history of per-launch merge/padding records.
DISPATCH_LOG_MAX = 4096

# Minimum legal row-ladder rung.
MIN_ROW_TILE = 2


def validate_row_ladder(row_ladder) -> tuple[int, ...]:
    """Validate a rung ladder at construction time: unique, strictly
    increasing, every rung at least ``MIN_ROW_TILE`` tall."""
    ladder = tuple(int(r) for r in row_ladder)
    if not ladder:
        raise ValueError("row_ladder must name at least one rung")
    low = [r for r in ladder if r < MIN_ROW_TILE]
    if low:
        raise ValueError(
            f"row_ladder rungs must be ≥ {MIN_ROW_TILE} (the minimum M-tile "
            f"height): got {low} in {ladder}")
    for prev, cur in zip(ladder, ladder[1:]):
        if cur == prev:
            raise ValueError(
                f"row_ladder has a duplicate rung {cur} in {ladder}: each "
                f"rung is one launch shape — duplicates would double-count "
                f"the shape budget")
        if cur < prev:
            raise ValueError(
                f"row_ladder must be strictly increasing, got {cur} after "
                f"{prev} in {ladder}: launch_rows snaps a height to the "
                f"first rung that fits, so a shuffled ladder launches at "
                f"the wrong height")
    return ladder


def default_row_ladder(n_max: int, n_min: int = 8) -> tuple[int, ...]:
    """Geometric rung set ``n_min, 2·n_min, … ≥ n_max``."""
    if n_max < 1 or n_min < 1:
        raise ValueError(f"row ladder needs positive bounds "
                         f"(got n_min={n_min}, n_max={n_max})")
    rungs, r = [], n_min
    while r < n_max:
        rungs.append(r)
        r *= 2
    rungs.append(n_max)     # top rung is exactly n_max (the merge cap)
    return tuple(rungs)


def expected_kernel_calls(eng) -> tuple[int, int]:
    """(K1 calls, K2 calls) one e2e of ``eng`` must make, from its static
    ``fold_profile``: one GEMM per staging pass and channel (per limb pair
    in per-plane mode); one fold per pass and channel when eager, one per
    window and channel (``n_folds``) when lazy."""
    fp = eng.fold_profile
    k1 = fp["n_passes"] * fp["n_channels"] * eng.plans[0].gemms_per_pass
    return k1, fp["n_folds"]


def check_launch_census(eng, k1_calls: int, k2_calls: int, what: str):
    """The launch census, checked beside the structural validator
    (:mod:`repro_torch.core.validator`) on its K1/K2 node counts: one e2e
    of ``eng`` must have made exactly the kernel calls its ``fold_profile``
    implies (eager: a GEMM and a fold per pass and channel; lazy: a fold
    per window and channel).  Raises on any mismatch."""
    want = expected_kernel_calls(eng)
    if (k1_calls, k2_calls) != want:
        raise RuntimeError(
            f"launch census failed for {what}: limb_matmul/mont_fold calls "
            f"({k1_calls}, {k2_calls}) != ({want[0]}, {want[1]}) from "
            f"fold_profile {eng.fold_profile}")


@dataclasses.dataclass
class DispatchResult:
    batch: StackedBatch
    outputs: dict          # tenant_id -> result rows (numpy uint32)
    stats: dict
    rows: object = None    # (n_rows, ...) result array, batch row order


@dataclasses.dataclass
class _LaunchGroup:
    """One launch: ≥1 same-class batches stacked along M."""
    workload: str
    d_bucket: int
    members: list          # (input index, StackedBatch, row_lo, row_hi)
    operand_rows: int = 0  # stacked operand height before ladder padding
    live_rows: int = 0     # tenant rows only (excludes batcher zero-pad rows)
    lid: int = 0           # causal launch ID (0 when tracing is off)


@dataclasses.dataclass
class InflightDispatch:
    """launch_mixed → gather handle: per group, its program and the launch
    slot that the group holds until its gather."""
    groups: list           # (_LaunchGroup, E2EProgram, LaunchSlot)
    n_batches: int


class SliceCoScheduler:
    """Static workload → device-group assignment.

    ``device`` is one device spec or a list of them (default: every CUDA
    device; raises without one — pass ``device="cpu"`` for the plain
    versions).  The devices are split evenly between Dilithium and BN254
    (both share the one device when there is one); ``bn254_full`` runs on
    the BN254 group.  ``reduction`` sets the
    default fold discipline and ``reduction_by_workload`` overrides it per
    class; mode strings and κ are validated here.  The JAX constructor's
    explicit ``assignment`` map has no caller and is not ported.
    """

    def __init__(self, *, accum: str = "fp32_mantissa",
                 reduction: str = "eager",
                 reduction_by_workload: dict[str, str] | None = None,
                 kappa: int | None = None, d_tile: int | None = None,
                 merge: bool = True, row_ladder: tuple | None = None,
                 merge_rows_max: int = 128, donate: bool = False,
                 host: int | None = None, device=None):
        self.devices = resolve_devices(device)
        half = max(1, len(self.devices) // 2)
        bn254 = self.devices[half:] or self.devices
        self.assignment = {w: self.devices[:half] if w == "dilithium"
                           else bn254 for w in WK.CLASSES}
        self.accum = accum
        self.reduction = G.check_reduction(reduction)
        self.reduction_by_workload = dict(reduction_by_workload or {})
        for w, mode in self.reduction_by_workload.items():
            if w not in WK.CLASSES:
                raise ValueError(f"unknown workload class {w!r} in "
                                 f"reduction_by_workload")
            G.check_reduction(mode)
        # κ only means something under lazy folding: if no class is lazy,
        # reject the deferral depth at construction time.
        modes = {self.reduction} | set(self.reduction_by_workload.values())
        if "lazy" not in modes:
            G.check_reduction(self.reduction, kappa)
        self.kappa = kappa
        self.d_tile = d_tile
        self.merge = merge
        if row_ladder is not None:
            row_ladder = validate_row_ladder(row_ladder)
        self.row_ladder = row_ladder
        self.merge_rows_max = (row_ladder[-1] if row_ladder
                               else merge_rows_max)
        # recorded only: each program's static input is the donated buffer
        self.donate = donate
        self.host = host
        self._engines: dict = {}
        # (workload, d_bucket) -> {operand shape: E2EProgram}; trace_counts
        # holds the number of captures per key (the JAX retrace count).
        self._programs: dict = {}
        self.trace_counts: dict = {}
        self.dispatch_log: collections.deque = collections.deque(
            maxlen=DISPATCH_LOG_MAX)
        # Observability hook (a repro_torch.obs.Tracer), set by a serving
        # layer; launches then emit host spans of their steps and a
        # device-track span from enqueue to the result on the host.
        self.tracer = None

    def reduction_for(self, workload: str) -> str:
        """The fold discipline this slice applies to a workload class."""
        return self.reduction_by_workload.get(workload, self.reduction)

    def device_for(self, workload: str) -> torch.device:
        """The device a workload class launches on (its group's first)."""
        return self.assignment[workload][0]

    def device_ids(self, workload: str | None = None) -> tuple:
        devs = self.devices if workload is None else self.assignment[workload]
        return tuple(str(d) for d in devs)

    def engine_for(self, workload: str, d: int):
        key = (workload, d)
        if key not in self._engines:
            mode = self.reduction_for(workload)
            # κ belongs to the lazy classes only.
            self._engines[key] = WK.make_engine(
                workload, d, accum=self.accum, reduction=mode,
                kappa=self.kappa if mode == "lazy" else None,
                d_tile=self.d_tile, device=str(self.device_for(workload)))
        return self._engines[key]

    def device_planes_for(self, workload: str, d: int):
        """The engine's twiddle planes on the group's device.  The engine is
        built on that device and uploads them once, so unlike the JAX
        co-scheduler there is nothing to re-home here."""
        return self.engine_for(workload, d).device_planes()

    def launch_rows(self, n_rows: int) -> int:
        """Launched operand height for ``n_rows`` live rows: the smallest
        ladder rung ≥ n_rows, or n_rows itself without a ladder (or beyond
        the top rung)."""
        if self.row_ladder is not None:
            for rung in self.row_ladder:
                if rung >= n_rows:
                    return rung
        return n_rows

    def operand_shape(self, workload: str, d: int, n_c: int) -> tuple:
        """Device operand shape of one ``n_c``-live-row launch (ladder-padded
        when a row ladder is configured), in the class's request form (the
        engine's ``operand_shape``)."""
        return self.engine_for(workload, d).operand_shape(
            self.launch_rows(n_c))

    def capture(self, workload: str, d: int, shape: tuple) -> E2EProgram:
        """A new program of ``(workload, d)`` at operand ``shape`` on the
        group's device, outside the program cache."""
        return E2EProgram(self.engine_for(workload, d), shape,
                          planes=self.device_planes_for(workload, d))

    def jitted_for(self, workload: str, d: int) -> dict:
        """The program cache of ``(workload, d_bucket)``: operand shape ->
        :class:`E2EProgram`, filled by :meth:`program_for`."""
        return self._programs.setdefault((workload, d), {})

    def program_for(self, workload: str, d: int, shape: tuple) -> E2EProgram:
        """The cached program of ``(workload, d)`` at ``shape``, captured
        (and counted in ``trace_counts``) at first use."""
        programs = self.jitted_for(workload, d)
        prog = programs.get(shape)
        if prog is None:
            prog = programs[shape] = self.capture(workload, d, shape)
            self.trace_counts[(workload, d)] = len(programs)
        return prog

    def precompile(self, programs, n_c: int) -> int:
        """Capture every ``(workload, d_bucket)``'s program at every rung
        (or at ``n_c`` without a ladder): builds engines, uploads planes and
        captures each shape once.  Returns the number of new captures."""
        rungs = list(self.row_ladder) if self.row_ladder else [n_c]
        n_new = 0
        for workload, d in programs:
            key = (workload, d)
            before = self.trace_counts.get(key, 0)
            for rung in rungs:
                self.program_for(workload, d,
                                 self.operand_shape(workload, d, rung))
            n_new += self.trace_counts.get(key, 0) - before
        return n_new

    def program_stats(self) -> dict:
        """Captures, their host seconds, the launch slots the programs hold
        (``slots``) and those added after each program's first
        (``slot_grows``), the memory of each CUDA device's graph pool
        (:meth:`CapturePool.bytes`; the pool is the process's, shared with
        other co-schedulers on the device), and ``stage_ops``: per
        ``"<workload>/d<bucket>"``, the ATen ops a run of its program makes
        by stage (:attr:`E2EProgram.stage_ops`; the same at every launch
        height)."""
        progs = [p for cache in self._programs.values()
                 for p in cache.values()]
        stage_ops = {}
        for (workload, d), cache in self._programs.items():
            for prog in cache.values():
                stage_ops.setdefault(f"{workload}/d{d}", prog.stage_ops)
        return {"captures": len(progs),
                "capture_s": sum(p.capture_s for p in progs),
                "slots": sum(len(p.slots) for p in progs),
                "slot_grows": sum(p.slot_grows for p in progs),
                "pool_bytes": {str(dev): capture_pool(dev).bytes()
                               for dev in self.devices
                               if dev.type == "cuda"},
                "stage_ops": stage_ops}

    # --- group planning + launch ----------------------------------------------

    def _plan_groups(self, batches: list[StackedBatch]) -> list[_LaunchGroup]:
        """Cut a dispatch set into launch groups: same-(workload, d_bucket,
        reduction) batches coalesce along M (``merge``) up to the top ladder
        rung / ``merge_rows_max``; groups keep first-appearance launch order
        and members remember their input index for order-preserving gather."""
        groups: list[_LaunchGroup] = []
        open_group: dict[tuple, _LaunchGroup] = {}
        for i, b in enumerate(batches):
            rows = b.operand.shape[0] if b.operand is not None else b.n_c
            key = (b.workload, b.d_bucket, self.reduction_for(b.workload))
            g = open_group.get(key) if self.merge else None
            if g is None or g.operand_rows + rows > self.merge_rows_max:
                g = _LaunchGroup(workload=b.workload, d_bucket=b.d_bucket,
                                 members=[])
                groups.append(g)
                if self.merge:
                    open_group[key] = g
            g.members.append((i, b, g.operand_rows, g.operand_rows + rows))
            g.operand_rows += rows
            g.live_rows += b.n_c
        return groups

    def _launch(self, group: _LaunchGroup):
        """Enqueue one launch group on its workload's device through a
        launch slot of its program, without waiting for it."""
        tr = self.tracer
        if tr is not None:
            group.lid = tr.next_id()
            tr.host_begin("sched.launch", group.lid)
        shape = self.operand_shape(group.workload, group.d_bucket,
                                   group.operand_rows)
        prog = self.jitted_for(group.workload, group.d_bucket).get(shape)
        if prog is None:
            if tr is not None:
                tr.host_begin("sched.capture", group.lid)
            prog = self.program_for(group.workload, group.d_bucket, shape)
            if tr is not None:
                tr.host_end("sched.capture", group.lid)
        if tr is not None:
            tr.host_begin("sched.stage", group.lid)
        slot = prog.acquire(group)
        merge_operands([prog.eng.launch_operand(b.operand)
                        for _, b, _, _ in group.members], out=slot.in_view)
        if tr is not None:
            tr.host_end("sched.stage", group.lid)
            tr.host_begin("sched.replay", group.lid)
        prog.launch(slot)
        if tr is not None:
            tr.host_end("sched.replay", group.lid)
            tr.begin("launch", group.lid,
                     f"launch:{group.workload}/d{group.d_bucket}", clock(),
                     track="device",
                     args={"live_rows": group.live_rows,
                           "launched_rows": shape[0],
                           "n_batches": len(group.members)})
        self.dispatch_log.append({
            "workload": group.workload, "d_bucket": group.d_bucket,
            "n_batches": len(group.members), "live_rows": group.live_rows,
            "launched_rows": shape[0],
            "donated": self.donate, "lid": group.lid,
            "devices": self.device_ids(group.workload)})
        if tr is not None:
            tr.host_end("sched.launch", group.lid)
        return group, prog, slot

    def _materialise(self, group: _LaunchGroup, prog: E2EProgram, slot):
        """Wait for one group's result, copy it out of the group's launch
        slot and free the slot, then split the rows into one
        :class:`DispatchResult` per member batch (ladder-pad rows
        dropped)."""
        if not slot.held_by(group):
            raise RuntimeError(
                f"launch of {group.workload}/d{group.d_bucket} was gathered "
                f"already: its slot may hold another launch's rows")
        tr = self.tracer
        if tr is not None:
            tr.host_begin("sched.gather", group.lid)
            tr.host_begin("sched.wait", group.lid)
        slot.wait()
        if tr is not None:
            tr.host_end("sched.wait", group.lid)
            tr.host_begin("sched.unpack", group.lid)
        res = slot.out_view.copy()
        slot.holder = None
        if tr is not None and group.lid:
            # lid 0: launched before this tracer was attached
            tr.end("launch", group.lid,
                   f"launch:{group.workload}/d{group.d_bucket}", clock(),
                   track="device")
        eng = prog.eng
        stats = dict(getattr(eng, "last_stats", {}) or {})
        stats.update(eng.fold_profile)
        results = []
        for idx, batch, lo, hi in group.members:
            rows = res[lo:hi]
            outputs = {r.tenant_id: rows[i]
                       for i, r in enumerate(batch.requests)}
            results.append((idx, DispatchResult(
                batch=batch, outputs=outputs, stats=dict(stats), rows=rows)))
        if tr is not None:
            tr.host_end("sched.unpack", group.lid)
            tr.host_end("sched.gather", group.lid)
        return results

    # --- public dispatch surface ----------------------------------------------

    def launch_mixed(self, batches: list[StackedBatch]) -> InflightDispatch:
        """Phase 1+2: enqueue every launch group, each with the
        asynchronous copy of its result into its launch slot's pinned
        output."""
        inflight = [self._launch(g) for g in self._plan_groups(batches)]
        return InflightDispatch(groups=inflight, n_batches=len(batches))

    def gather(self, flight: InflightDispatch) -> list[DispatchResult]:
        """Phase 3: materialise an in-flight dispatch, input batch order."""
        results: list = [None] * flight.n_batches
        for f in flight.groups:
            for idx, dr in self._materialise(*f):
                results[idx] = dr
        return results

    def dispatch(self, batch: StackedBatch) -> DispatchResult:
        """Execute one stacked batch on its workload's device."""
        return self.dispatch_mixed([batch])[0]

    def dispatch_mixed(self, batches: list[StackedBatch]) -> list[DispatchResult]:
        """Heterogeneous dispatch: per-class launches back-to-back, same-class
        batches coalesced into tall super-batches (``merge``)."""
        return self.gather(self.launch_mixed(batches))

    def drain_dispatch_log(self) -> list[dict]:
        """Hand the accumulated per-launch records to the caller and reset
        the log."""
        log = list(self.dispatch_log)
        self.dispatch_log.clear()
        return log

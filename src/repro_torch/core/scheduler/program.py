"""Captured e2e programs: the port's counterpart of the JAX co-scheduler's
compiled ``jax.jit(eng.e2e)``.

An :class:`E2EProgram` is one engine's whole served e2e (``eng.serve``:
every staging pass's K1 GEMM and K2 fold on every channel, and for BN254 the
reduction to F_p, the ``rns_redc`` kernel; for ``bn254_full`` also the words
of its field elements turned into residues before, and the kernel writes
the result's words) at one operand shape (``eng.operand_shape``).  It owns
a static int32 input on the engine's device, the engine's twiddle planes
(uploaded once, by the engine) and a static int32 output.  Both hold uint32
bits: residues below 2**31, or the full 32-bit words of a field element.

A program is its launch slots (:class:`LaunchSlot`), made with the program
and kept for its life: a pinned host input and output and one event each,
and on CUDA one graph each that copies the slot's input into the static
input, runs the e2e and copies the static output into the slot's output.
A launch is one replay of that graph and the record of the slot's event on
the program's stream.  On CUDA the e2e runs once on the pool's side stream
first (the warm-up, which also yields the output's shape); a failed
capture, or a kernel that fails to launch inside it, raises, and there is
no eager path on the card.  On the CPU (the tests) the slot's copies run
around an eager e2e on the same static buffers.  A caller acquires a slot
(:meth:`E2EProgram.acquire`), writes its operand into the slot's
``in_view``, launches (:meth:`E2EProgram.launch`), waits on the slot and
reads ``out_view``.  A slot is held until its holder sets it free, so no
later launch writes a slot whose rows are still wanted; a program adds a
slot (one more capture) only when every slot it has is held.

The warm-up (CUDA) or the first run (CPU) also runs under a
:class:`StageOps` census: the ATen ops of one run by stage, kept as
:attr:`E2EProgram.stage_ops`.

Kernel counters (``KernelCounter.calls``/``launches``) keep meaning "kernel
executions enqueued".  The warm-up (CUDA) or the first run (CPU) counts as
it runs.  The capture's wrapper calls enqueue nothing, so the counters are
put back after it and its counts kept as :attr:`E2EProgram.calls` and
:attr:`E2EProgram.launches` (kernel name -> count); each replay adds
them.  Those recorded counts are what the launch census checks against the
engine's ``fold_profile``.

The structural validator (:mod:`repro_torch.core.validator`) captures its
probe with :class:`GraphProbe`: any function, captured under a launch log
(:func:`repro_torch.core.zones.launch_log`) with the graph kept
(``CUDAGraph(keep_graph=True)``, instantiated at its first replay) and read
node by node (:mod:`repro_torch.kernels.graph_census`).  The cache's
programs are captured without either.

Every program of one device, whichever co-scheduler made it, shares the
process's one graph memory pool and one side stream for that device
(:func:`capture_pool`); each program owns its slots' graphs, which go with
it.  The programs replay on one stream in dispatch order, so the pool's
intermediates are never live in two replays at once; the same holds for a
program's several slots.  The static input and output and the slots' host
buffers lie outside the pool, so another program's replay never writes
them.  One side stream per device also keeps the warm-ups' cached blocks in
one place: a stream per co-scheduler would strand its cache when the
co-scheduler goes.
"""
from __future__ import annotations

import contextlib
import time
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import zones
from repro_torch.kernels import graph_census
from repro_torch.kernels.fused_ntt_tile.kernel import COUNTER as K3
from repro_torch.kernels.limb_matmul.kernel import COUNTER as K1
from repro_torch.kernels.mont_fold.kernel import COUNTER as K2
from repro_torch.kernels.rns_redc.kernel import COUNTER as REDC

# kernel name -> its wrapper's counter
COUNTERS = {"limb_matmul": K1, "mont_fold": K2, "fused_ntt_tile": K3,
            "rns_redc": REDC}


def _counts() -> dict:
    return {name: (c.calls, c.launches) for name, c in COUNTERS.items()}


def _since(before: dict) -> tuple[dict, dict]:
    """(calls, launches) per kernel name since ``before``."""
    now = _counts()
    return ({k: now[k][0] - before[k][0] for k in COUNTERS},
            {k: now[k][1] - before[k][1] for k in COUNTERS})


def _restore(counts: dict):
    for name, (calls, launches) in counts.items():
        COUNTERS[name].calls, COUNTERS[name].launches = calls, launches


# the scopes that mark the stages of a served e2e other than the channels'
# transforms, and each stage's name
STAGE_SCOPES = (("bn254_ingest", "ingest"), ("vpu_montgomery", "reduce"))
STAGES = ("ingest", "channels", "reduce")


class StageOps(TorchDispatchMode):
    """The non-view ATen ops run inside the block, outside the kernel
    wrappers (whose work is the kernels), counted by stage: ``ingest``
    and ``reduce`` by the scope path (:data:`STAGE_SCOPES`), every
    other op (the channels' limb splits, recombinations and stacking) in
    ``channels``.  Each is one device kernel or copy of a run on the card,
    or an allocation."""

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(STAGES, 0)

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # False keeps PyTorch from wrapping __torch_dispatch__ in
        # torch._disable_dynamo, whose first call imports torch._dynamo
        # (seconds, inside the server's set-up); nothing here compiles
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.namespace == "aten" and not func.is_view
                and not zones.in_kernel_call()):
            path = zones.current_path()
            stage = next((name for scope, name in STAGE_SCOPES
                          if scope in path), "channels")
            self.counts[stage] += 1
        return out


class CapturePool:
    """One CUDA device's graph memory pool and side stream, shared by every
    program captured on that device (warm-ups and captures run on the
    stream; each capture allocates from the pool).

    PyTorch's allocator counts the graphs captured into a private pool,
    releases the pool when the count drops to 0 and then refuses a capture
    into it.  So the pool first captures a sentinel, a one-element fill,
    and keeps it for the life of the process: the count stays above 0 while
    the programs' graphs come and go with their programs (a census probe,
    a dropped co-scheduler's cache)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(torch.cuda.current_stream(device))
        torch.cuda.synchronize(device)
        self._sentinel = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            self._sentinel.capture_begin(pool=self.handle)
            try:
                self._sentinel_out = torch.zeros(1, dtype=torch.int32,
                                                 device=device)
            finally:
                self._sentinel.capture_end()

    def bytes(self) -> dict:
        """Device memory the pool holds: reserved segments and the bytes
        allocated in them, from the allocator's snapshot."""
        reserved = allocated = 0
        for seg in torch.cuda.memory_snapshot():
            if (seg["device"] == self.device.index
                    and tuple(seg["segment_pool_id"]) == tuple(self.handle)):
                reserved += seg["total_size"]
                allocated += seg["allocated_size"]
        return {"reserved": reserved, "allocated": allocated}


_POOLS: dict = {}      # CUDA device -> CapturePool, one per device


def capture_pool(device: torch.device) -> CapturePool:
    """The process's :class:`CapturePool` of a CUDA device, made at first
    use."""
    pool = _POOLS.get(device)
    if pool is None:
        pool = _POOLS[device] = CapturePool(device)
    return pool


def record_graph(fn, pool: CapturePool, *, keep_graph: bool = False):
    """Capture ``fn()`` as one CUDA graph on the pool's stream into its
    memory, with ``CUDAGraph.capture_begin``/``capture_end``: what
    ``torch.cuda.graph`` does, without the emptying of the device and
    pinned-host caches that the context manager adds to every capture.  The
    caller has warmed ``fn`` up and left the device idle.  The capture's
    wrapper calls enqueue nothing, so the counters are put back after it.

    Returns ``(graph, calls, launches, log)``: the counts the capture
    recorded (kernel name -> count) and, with ``keep_graph``, the launch log
    of the capture (the graph is then kept for the reader and instantiated
    at its first replay); without it ``log`` is None."""
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    before = _counts()
    try:
        with contextlib.ExitStack() as stack:
            log = stack.enter_context(zones.launch_log()) if keep_graph \
                else None
            stack.enter_context(torch.cuda.stream(pool.stream))
            graph.capture_begin(pool=pool.handle)
            try:
                fn()
            finally:
                graph.capture_end()
        calls, launches = _since(before)
    finally:
        _restore(before)        # the capture enqueued nothing
    return graph, calls, launches, log


def read_graph(graph, device: torch.device) -> tuple:
    """The graph reader's census of a graph captured with
    ``keep_graph=True``, and the host seconds the reading took."""
    t0 = time.perf_counter()
    census = graph_census.read(graph.raw_cuda_graph(), device.index)
    return census, time.perf_counter() - t0


class GraphProbe:
    """``fn()`` captured once for the structural validator on a CUDA
    ``device``: warmed up on the pool's stream (counted as it runs), then
    captured into the pool under a launch log with the graph kept and read.
    ``log`` holds the capture's launch log, ``census`` the graph's nodes
    and edges, ``read_s`` the reader's host seconds and ``out`` what the
    captured ``fn()`` returned, which :meth:`replay` overwrites.  The graph
    and ``out`` go back to the pool with the probe.  ``warmup_mode``, a
    context manager kept as the attribute of that name, is entered around
    the warm-up call alone (the cost model's op census,
    :class:`repro_torch.launch.graph_cost.OpCensus`)."""

    def __init__(self, fn, device: torch.device, *, warmup_mode=None):
        pool = capture_pool(device)
        current = torch.cuda.current_stream(device)
        pool.stream.wait_stream(current)
        self.warmup_mode = warmup_mode
        with torch.cuda.stream(pool.stream), \
                (warmup_mode or contextlib.nullcontext()):
            fn()                                # warm-up, counted as it runs
        current.wait_stream(pool.stream)
        torch.cuda.synchronize(device)
        out = []
        self.graph, self.calls, self.launches, self.log = record_graph(
            lambda: out.append(fn()), pool, keep_graph=True)
        self.out = out[0]
        self.census, self.read_s = read_graph(self.graph, device)

    def replay(self):
        """Run the validated graph once on the current stream, on whatever
        its inputs now hold; returns :attr:`out`."""
        self.graph.replay()
        for name, c in COUNTERS.items():
            c.calls += self.calls[name]
            c.launches += self.launches[name]
        return self.out


class LaunchSlot:
    """The host side of one launch of an :class:`E2EProgram`, kept for the
    next: an int32 input of the program's shape and an int32 output of its
    static output's shape (pinned on CUDA), each with its uint32 numpy view
    made once (the buffers hold uint32 bits), and on CUDA the
    event that marks the output on the host and the graph that copies the
    input in, runs the e2e and copies the output back (``graph`` and
    ``event`` are None on the CPU).

    ``holder`` is a weak reference to what holds the slot (the
    co-scheduler's launch group), None while it is free: a slot whose
    holder is gone was dropped without a gather and is free again.  ``pending`` is True from a launch until the
    host has waited on its event."""

    __slots__ = ("host_in", "in_view", "host_out", "out_view", "event",
                 "graph", "holder", "pending")

    def __init__(self, in_shape: tuple, out_shape: tuple, cuda: bool):
        self.host_in = torch.zeros(in_shape, dtype=torch.int32,
                                   pin_memory=cuda)
        self.in_view = self.host_in.numpy().view(np.uint32)
        self.host_out = torch.zeros(out_shape, dtype=torch.int32,
                                    pin_memory=cuda)
        self.out_view = self.host_out.numpy().view(np.uint32)
        self.event = torch.cuda.Event() if cuda else None
        self.holder = self.graph = None
        self.pending = False

    def held_by(self, holder) -> bool:
        return self.holder is not None and self.holder() is holder

    def wait(self):
        """Block until the slot's last launch has left its output on the
        host (at once when it has, or on the CPU)."""
        if self.pending:
            self.event.synchronize()
            self.pending = False


class E2EProgram:
    """``eng.serve`` at one operand shape, with static input and output.

    ``shape`` is the launched operand's (``eng.operand_shape``);
    ``planes`` the engine's device planes.  ``capture_s`` is
    the host time the construction took (on CUDA the warm-up and the first
    slot's capture) and each added slot's capture.  ``slots`` holds the
    launch slots, ``slot_grows`` the number added after the first.
    ``stage_ops`` is the :class:`StageOps` count of the warm-up (CUDA) or
    the first run (CPU).  On CUDA a launch runs on ``stream``, the device's
    current stream when the program was made."""

    def __init__(self, eng, shape: tuple, *, planes):
        t0 = time.perf_counter()
        self.eng = eng
        self.planes = planes
        self.shape = tuple(shape)
        self.device = eng.device
        self.cuda = self.device.type == "cuda"
        self.static_in = torch.zeros(self.shape, dtype=torch.int32,
                                     device=self.device)
        self.slot_grows = 0
        if self.cuda:
            self.stream = torch.cuda.current_stream(self.device)
            self._warm_up(capture_pool(self.device))
        else:
            self.stream = None
            before = _counts()
            with StageOps() as census:
                out = self._e2e()
            self.stage_ops = census.counts
            self.static_out = out.to(torch.int32)
            self.calls, self.launches = _since(before)
        self.slots = [self._new_slot()]
        self.capture_s = time.perf_counter() - t0

    def _e2e(self) -> torch.Tensor:
        return self.eng.serve(self.static_in, planes=self.planes)

    def _warm_up(self, pool: CapturePool):
        """Run the e2e on the pool's stream (counted as it runs, its ATen
        ops by stage), which also gives the static output's shape, and
        leave the device idle."""
        current = torch.cuda.current_stream(self.device)
        pool.stream.wait_stream(current)
        with torch.cuda.stream(pool.stream), StageOps() as census:
            shape = self._e2e().shape
        self.stage_ops = census.counts
        self.static_out = torch.empty(shape, dtype=torch.int32,
                                      device=self.device)
        current.wait_stream(pool.stream)
        torch.cuda.synchronize(self.device)

    def _record(self, fn):
        """:func:`record_graph` of ``fn`` into the device's pool, on an idle
        device as ``torch.cuda.graph`` starts a capture; keeps the counts
        it recorded as :attr:`calls` and :attr:`launches`."""
        torch.cuda.synchronize(self.device)
        graph, self.calls, self.launches, _ = record_graph(
            fn, capture_pool(self.device))
        return graph

    def _new_slot(self) -> LaunchSlot:
        slot = LaunchSlot(self.shape, tuple(self.static_out.shape), self.cuda)
        if self.cuda:
            def launch():
                self.static_in.copy_(slot.host_in, non_blocking=True)
                self.static_out.copy_(self._e2e())
                slot.host_out.copy_(self.static_out, non_blocking=True)
            slot.graph = self._record(launch)
        return slot

    def acquire(self, holder) -> LaunchSlot:
        """A free slot, held for ``holder`` (by weak reference) until the
        caller sets its ``holder`` back to None; a new slot, with one more
        capture on CUDA, when every slot is held.  Waits for the slot's
        last launch if it was dropped without a gather."""
        for slot in self.slots:
            if slot.holder is None or slot.holder() is None:
                break
        else:
            t0 = time.perf_counter()
            slot = self._new_slot()
            self.slots.append(slot)
            self.slot_grows += 1
            self.capture_s += time.perf_counter() - t0
        slot.wait()
        slot.holder = weakref.ref(holder)
        return slot

    def launch(self, slot: LaunchSlot):
        """Run the program on ``slot``'s input into its output without
        waiting: on CUDA one replay of the slot's graph and the record of
        its event, on :attr:`stream`; on the CPU the same copies around an
        eager e2e."""
        if slot.graph is None:
            self.static_in.copy_(slot.host_in)
            self.static_out.copy_(self._e2e())
            slot.host_out.copy_(self.static_out)
            return
        slot.graph.replay()
        slot.event.record(self.stream)
        slot.pending = True
        self._count_replay()

    def _count_replay(self):
        """Add the counts the capture recorded: a replay calls no wrapper."""
        for name, c in COUNTERS.items():
            c.calls += self.calls[name]
            c.launches += self.launches[name]

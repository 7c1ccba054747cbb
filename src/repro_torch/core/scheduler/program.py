"""Captured e2e programs: the port's counterpart of the JAX co-scheduler's
compiled ``jax.jit(eng.e2e)``.

An :class:`E2EProgram` is one engine's whole ``e2e`` (every staging pass's
K1 GEMM and K2 fold on every channel, and for BN254 the ``rns_to_field``
reduction) at one operand shape.  It owns a static int32 input on the
engine's device, the engine's twiddle planes (uploaded once, by the engine)
and a static int32 output.

* On CUDA the e2e runs once on the pool's side stream (the warm-up, which
  also yields the output's shape) and is then captured once as a CUDA graph
  into the pool's memory.  :meth:`E2EProgram.run` copies the operand into
  the static input on the current stream and replays the graph there: one
  graph launch in place of the thousands of launches the e2e makes op by
  op.  A failed capture, or a kernel that fails to launch inside it, raises;
  there is no eager path on the card.
* On the CPU (the tests) the same object runs ``e2e`` eagerly on the same
  static buffers, so the buffer discipline is the same on both devices: the
  static output is overwritten by the program's next run, and a caller that
  keeps it instead of copying it out sees the next flight's rows.

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
(:func:`capture_pool`); each program owns its graph, which goes with it.
The programs replay on one stream in dispatch order, so the pool's
intermediates are never live in two replays at once;
the static input and output lie outside the pool, so another program's
replay never writes them.  One side stream per device also keeps the
warm-ups' cached blocks in one place: a stream per co-scheduler would
strand its cache when the co-scheduler goes.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.core import zones
from repro_torch.kernels import graph_census
from repro_torch.kernels.fused_ntt_tile.kernel import COUNTER as K3
from repro_torch.kernels.limb_matmul.kernel import COUNTER as K1
from repro_torch.kernels.mont_fold.kernel import COUNTER as K2

# kernel name -> its wrapper's counter
COUNTERS = {"limb_matmul": K1, "mont_fold": K2, "fused_ntt_tile": K3}


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


class E2EProgram:
    """``eng.e2e`` at one operand shape, with static input and output.

    ``shape`` is the launched operand's, ``(rows, d)`` for Dilithium and
    ``(rows, d, channels)`` for BN254; ``planes`` the engine's device
    planes.  ``capture_s`` is the host time the construction took (on CUDA
    the warm-up and the capture)."""

    def __init__(self, eng, shape: tuple, *, planes):
        t0 = time.perf_counter()
        self.eng = eng
        self.planes = planes
        self.shape = tuple(shape)
        self.device = eng.device
        self.static_in = torch.zeros(self.shape, dtype=torch.int32,
                                     device=self.device)
        self.graph = None
        if self.device.type == "cuda":
            self._capture(capture_pool(self.device))
        else:
            before = _counts()
            self.static_out = self._e2e().to(torch.int32)
            self.calls, self.launches = _since(before)
        self.capture_s = time.perf_counter() - t0

    def _e2e(self) -> torch.Tensor:
        return self.eng.e2e(self.static_in, planes=self.planes)

    def _capture(self, pool: CapturePool):
        """Warm up on the pool's stream (which also gives the output's
        shape), then :func:`record_graph` the e2e into the static output."""
        current = torch.cuda.current_stream(self.device)
        pool.stream.wait_stream(current)
        with torch.cuda.stream(pool.stream):
            shape = self._e2e().shape           # warm-up, counted as it runs
        self.static_out = torch.empty(shape, dtype=torch.int32,
                                      device=self.device)
        current.wait_stream(pool.stream)
        # as torch.cuda.graph does: the capture starts on an idle device,
        # with the warm-up done
        torch.cuda.synchronize(self.device)
        self.graph, self.calls, self.launches, _ = record_graph(
            lambda: self.static_out.copy_(self._e2e()), pool)

    def load(self, host_operand: torch.Tensor):
        """Copy ``host_operand`` (int32, the program's shape; pinned on
        CUDA) into the static input on the current stream."""
        if tuple(host_operand.shape) != self.shape:
            raise ValueError(f"operand of shape {tuple(host_operand.shape)} "
                             f"for a program of shape {self.shape}")
        self.static_in.copy_(host_operand, non_blocking=True)

    def replay(self) -> torch.Tensor:
        """Run the program on the static input: one graph launch on the
        current stream (CUDA), or ``e2e`` (CPU).  Returns the static
        output, which the next run overwrites."""
        if self.graph is None:
            self.static_out.copy_(self._e2e())
        else:
            self.graph.replay()
            for name, c in COUNTERS.items():
                c.calls += self.calls[name]
                c.launches += self.launches[name]
        return self.static_out

    def run(self, host_operand: torch.Tensor) -> torch.Tensor:
        """:meth:`load` then :meth:`replay`."""
        self.load(host_operand)
        return self.replay()

    def copy_out(self):
        """Start the copy of the static output to a fresh host buffer and
        return ``(host tensor, event)``.  On CUDA the copy is enqueued on
        the current stream, so before any later replay there, into pinned
        memory; the event marks it done.  On the CPU the copy is made at
        once and the event is None."""
        if self.graph is None:
            return self.static_out.clone(), None
        host = torch.empty(self.static_out.shape, dtype=torch.int32,
                           pin_memory=True)
        host.copy_(self.static_out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event


def host_operand(shape: tuple, device: torch.device) -> tuple:
    """A fresh int32 host buffer for one launch's operand (pinned when the
    program runs on CUDA) and its uint32 numpy view to write residues into
    (residues < 2**31: the bits are the same)."""
    t = torch.empty(shape, dtype=torch.int32,
                    pin_memory=device.type == "cuda")
    return t, t.numpy().view(np.uint32)

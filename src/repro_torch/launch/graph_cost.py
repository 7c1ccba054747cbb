"""Cost model of the port's programs against the card's data-sheet rates.

The counterpart of the JAX package's ``launch/hlo_analysis.py`` (roofline
terms) and ``launch/hlo_cost.py`` (FLOPs and bytes from the optimized HLO).
The port's programs are CUDA graphs, not HLO, so this module prices what a
program launches:

* the K1/K2/K3 kernels, by :func:`node_cost` from the static arguments that
  the launch log (:func:`repro_torch.core.zones.launch_log`, on the CPU too)
  and the graph reader (:mod:`repro_torch.kernels.graph_census`) both give,
  with the formulas behind ``PERF.md``'s bound column;
* every other op, by :func:`op_census`: each ATen op a function runs, under
  a ``TorchDispatchMode``, priced by ``hlo_cost``'s rule (bytes are operand
  bytes plus result bytes; operations are the result's elements for an
  elementwise op, the input's for a reduction, 2·|result|·K for a matrix
  product; views and allocations cost nothing).  The K wrappers launch
  through ctypes, not ATen, and on the CPU run their plain versions as ATen
  ops, so the walk leaves out whatever runs inside a wrapper
  (:data:`repro_torch.core.zones.KERNEL_CALL`): the kernels come from the
  launch log alone.

There are no trip counts to multiply, as ``hlo_cost`` multiplies a while
loop's body: the port runs every staging pass unrolled
(``limb_gemm._staged_passes``), its scan form included, so each pass's ops
are walked once per pass.

:func:`roofline_terms` gives the compute term (the int8 and bf16
tensor-core terms plus the CUDA-core term), the memory term and the
collective term of a cost, with the JAX key names; a one-card program's
collective term is 0.  :class:`ShardedOpCensus` is the census of a program
over a mesh of DTensors (the dry run's LM cells): it prices each op on one
device's shards, as XLA's post-partition ``cost_analysis()`` counts one
device's work, and counts the collectives DTensor issues, whose bytes
:func:`collective_bytes` sums by JAX's kinds.  :func:`model_flops` is
copied from ``hlo_analysis``.  :func:`program_cost` prices a captured
program (a :class:`~repro_torch.core.scheduler.program.GraphProbe` whose
warm-up ran under an :class:`OpCensus`) node by node; :func:`log_cost`
prices an eager run on the CPU from its launch log and op census.  A predicted device time is the
sum over the program's kernels of max(bytes / bandwidth, operations /
rate): the least time the card could take for each, launched one after
another.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import zones

# Device rates of the published data sheets (dense, no sparsity): device
# memory bandwidth per card name, int8 and bf16 tensor-core operations, and
# the non-tensor-core float32 rate as the rate of the CUDA cores' integer
# work (and of float32 products: the port runs them with TF32 off).
BANDWIDTH = {"H200": 4.8e12, "H100": 3.35e12}
INT8_OPS = 1.979e15
BF16_OPS = 989e12
CUDA_CORE_OPS = 67e12
# One H100 SXM's NVLink 4 rate in one direction: 18 links of 25 GB/s each
# way (the data sheet's 900 GB/s counts both directions).  A device sends
# its collective bytes at this rate.
NVLINK_BW = 450e9
# Integer operations of the fold (csrc/fold.cuh) per diagonal: its term
# (sign flip, multiply-high, two multiplies, subtract, and the conditional
# subtract as a subtract and a min), then one add-mod of the tree (add,
# subtract, min).
FOLD_OPS_PER_DIAG = 7 + 3

K1, K2, K3 = "limb_matmul", "mont_fold", "fused_ntt_tile"


def bandwidth(card: str) -> float:
    """Device memory bytes per second of a card, by its name."""
    for key, bw in BANDWIDTH.items():
        if key in card:
            return bw
    raise ValueError(f"no bandwidth figure for card {card!r}")


def cost(bytes_: int = 0, tensor_ops: int = 0, cuda_core_ops: int = 0,
         bf16_ops: int = 0) -> dict:
    """A cost: bytes moved, operations on the int8 tensor cores, on the CUDA
    cores and on the bf16 (or fp16) tensor cores."""
    return {"bytes": bytes_, "tensor_ops": tensor_ops,
            "cuda_core_ops": cuda_core_ops, "bf16_ops": bf16_ops}


def add(*costs: dict) -> dict:
    return cost(*(sum(c[k] for c in costs)
                  for k in ("bytes", "tensor_ops", "cuda_core_ops",
                            "bf16_ops")))


def node_cost(kernel: str, args: dict) -> dict:
    """Bytes and operations of one K1, K2 or K3 call from its static
    arguments (the launch log's and the graph reader's names): each input
    read once and the output written once.

    K1 (n, k, m): n·k + k·m + 4·n·m bytes and 2·n·k·m operations.  K2
    (n_out, n_diag): 4·n_out·n_diag + 4·n_out bytes and n_out·n_diag·
    FOLD_OPS_PER_DIAG operations.  K3 (n, k, d, n_diag): K1's product into
    d·n_diag columns with K2's fold of them as its epilogue.  A GEMM's
    multiply-adds go to the int8 tensor cores, or, where the node's
    ``fp32`` flag says it runs the fp32_mantissa model, to the CUDA cores as
    FFMA; the fold's integer operations to the CUDA cores."""
    if kernel == K1:
        n, k, m = args["n"], args["k"], args["m"]
        gemm = 2 * n * k * m
        return cost(n * k + k * m + 4 * n * m,
                    *((0, gemm) if args["fp32"] else (gemm, 0)))
    if kernel == K2:
        n, nd = args["n_out"], args["n_diag"]
        return cost(4 * n * nd + 4 * n, 0, n * nd * FOLD_OPS_PER_DIAG)
    if kernel == K3:
        n, k, d, nd = args["n"], args["k"], args["d"], args["n_diag"]
        gemm, fold = 2 * n * k * d * nd, n * d * nd * FOLD_OPS_PER_DIAG
        return cost(n * k + k * d * nd + 4 * n * d,
                    *((0, gemm + fold) if args["fp32"] else (gemm, fold)))
    raise ValueError(f"no cost model for kernel {kernel!r}")


def times_s(c: dict, card: str) -> tuple[float, float]:
    """(memory seconds, compute seconds) of a cost on ``card``: bytes over
    the bandwidth; each kind of operation over its rate, summed."""
    return (c["bytes"] / bandwidth(card),
            c["tensor_ops"] / INT8_OPS + c["cuda_core_ops"] / CUDA_CORE_OPS
            + c["bf16_ops"] / BF16_OPS)


def bound_s(c: dict, card: str) -> tuple[float, str]:
    """The least time the card could take for a cost, and what bounds it
    (``"bytes"`` or ``"operations"``)."""
    t_bytes, t_ops = times_s(c, card)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def roofline_terms(c: dict, *, card: str, coll_bytes: int = 0,
                   n_chips: int = 1) -> dict:
    """The JAX package's roofline terms of one device's cost:
    ``flops_per_chip`` counts every operation (integer ones included, as
    XLA's ``flops`` does), ``bytes_per_chip`` the bytes, ``t_compute_s`` the
    tensor-core terms plus the CUDA-core term; ``coll_bytes`` is the
    collective bytes of all ``n_chips`` devices (JAX's
    ``collective_bytes_total``), so ``t_collective_s`` is one device's share
    over :data:`NVLINK_BW`.  A one-card program has none (0)."""
    t_memory, t_compute = times_s(c, card)
    t_collective = coll_bytes / n_chips / NVLINK_BW
    dominant = "compute" if t_compute > t_memory else "memory"
    if t_collective > max(t_compute, t_memory):
        dominant = "collective"
    return {
        "flops_per_chip": c["tensor_ops"] + c["cuda_core_ops"]
        + c["bf16_ops"],
        "bytes_per_chip": c["bytes"],
        "collective_bytes_total": coll_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "t_tensor_core_s": c["tensor_ops"] / INT8_OPS
        + c["bf16_ops"] / BF16_OPS,
        "t_cuda_core_s": c["cuda_core_ops"] / CUDA_CORE_OPS,
        "card": card,
        "bandwidth": bandwidth(card),
        "link_bandwidth": NVLINK_BW,
    }


def model_flops(n_params: int, n_tokens: int, *, active_params: int | None = None,
                train: bool = True) -> float:
    """6·N·D (dense train) / 2·N·D (inference); MoE uses active params."""
    n = active_params if active_params is not None else n_params
    return (6.0 if train else 2.0) * n * n_tokens


# --- the ATen op walk --------------------------------------------------------

# hlo_cost's _ELEMENTWISE, by ATen name (an in-place form drops its "_").
ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "floor_divide",
    "neg", "abs", "sign", "pow", "minimum", "maximum", "clamp", "clamp_min",
    "clamp_max", "where", "eq", "ne", "lt", "le", "gt", "ge", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "__and__", "__or__",
    "__xor__", "__lshift__", "__rshift__", "bitwise_left_shift",
    "bitwise_right_shift", "logical_and", "logical_or", "logical_not",
    "logical_xor"})
# The LM path's float elementwise ops (XLA's elementwise opcodes), one
# operation per result element.
FLOAT_ELEMENTWISE = frozenset({
    "exp", "log", "sqrt", "rsqrt", "tanh", "sigmoid", "silu", "gelu", "sin",
    "cos", "square", "reciprocal", "erf", "masked_fill"})
REDUCTIONS = frozenset({"sum", "prod", "amax", "amin", "max", "min", "mean",
                        "any", "all", "cumsum", "cumprod", "var", "_softmax",
                        "_log_softmax", "sort", "topk"})
MATMULS = frozenset({"mm", "bmm", "matmul", "addmm", "baddbmm", "_int_mm"})
# Ops that write their result and read no operand data.
WRITE_ONLY = frozenset({"zeros", "zeros_like", "ones", "ones_like", "full",
                        "full_like", "arange", "scalar_tensor", "fill",
                        "zero"})
ALLOCATIONS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided"})


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


def storage_key(t) -> int:
    """The identity of ``t``'s storage, shared by its views (a fake
    tensor's too)."""
    return t.untyped_storage()._cdata


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def aten_cost(func, args, kwargs, out) -> dict | None:
    """The cost of one ATen op by ``hlo_cost``'s rule, or None for an op
    that moves no data: a view, an allocation, an op of another namespace
    (the profiler's ranges)."""
    if func.namespace != "aten" or func.is_view:
        return None
    name = func.overloadpacket.__name__
    base = name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name
    if base in ALLOCATIONS:
        return None
    written = _nbytes(out)
    if base in WRITE_ONLY:
        return cost(written)
    if base == "copy":                      # dst is written, not read
        return cost(_nbytes(args[1]) + written)
    read = _nbytes(args) + _nbytes(list(kwargs.values()))
    elems = sum(t.numel() for t in _tensors(out))
    if (base in ELEMENTWISE or base in FLOAT_ELEMENTWISE
            or base.endswith(("_backward", "_backward_data"))):
        ops = elems
    elif base == "_to_copy":                # hlo's convert is elementwise
        dtype = kwargs.get("dtype")
        ops = elems if dtype is not None and dtype != args[0].dtype else 0
    elif base in REDUCTIONS:
        ops = next(_tensors(args)).numel()
    elif base in MATMULS:
        lhs = args[1] if base in ("addmm", "baddbmm") else args[0]
        ops = 2 * elems * lhs.shape[-1]
        if lhs.dtype in (torch.bfloat16, torch.float16):
            return cost(read + written, bf16_ops=ops)
    else:                                   # data movement: copies, cat, pad
        ops = 0
    return cost(read + written, 0, ops)


class OpCensus(TorchDispatchMode):
    """Every ATen op run inside the block, outside the K1/K2/K3 wrappers,
    with its cost (``ops``: (name, cost) in call order), and the launch log
    of the block (``log``), whose records are the kernels.  Use as a
    context manager, or through :func:`op_census`."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self.log = None
        self._log_cm = None

    def __enter__(self):
        self._log_cm = zones.launch_log()
        self.log = self._log_cm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._log_cm.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not zones.in_kernel_call():
            c = aten_cost(func, args, kwargs, out)
            if c is not None:
                self.ops.append((str(func), c))
        return out

    def aten(self) -> dict:
        """The summed cost of the ATen ops."""
        return add(cost(), *(c for _, c in self.ops))

    def by_op(self) -> dict:
        """Calls and summed cost per ATen op name."""
        out = {}
        for name, c in self.ops:
            entry = out.setdefault(name, {"calls": 0, **cost()})
            entry["calls"] += 1
            for k, v in c.items():
                entry[k] += v
        return out

    def kernel_args(self) -> list:
        """(kernel, static arguments) of every K1/K2/K3 call of the block."""
        return [(r.kernel, r.args) for r in self.log.records]


def op_census(fn, *args, **kwargs) -> OpCensus:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCensus`; the census
    keeps the result as ``out``."""
    census = OpCensus()
    with census:
        census.out = fn(*args, **kwargs)
    return census


def _summary(kernels: list, ops: OpCensus, card: str,
             other_kernel_nodes: int | None) -> dict:
    per_kernel = {}
    predicted = 0.0
    for kernel, args in kernels:
        c = node_cost(kernel, args)
        per_kernel[kernel] = add(per_kernel.get(kernel, cost()), c)
        predicted += bound_s(c, card)[0]
    aten = [c for _, c in ops.ops]
    predicted += sum(bound_s(c, card)[0] for c in aten)
    total = add(cost(), *per_kernel.values(), *aten)
    counts = {k: sum(kernel == k for kernel, _ in kernels)
              for k in (K1, K2, K3)}
    top = sorted(ops.by_op().items(), key=lambda kv: -kv[1]["bytes"])[:6]
    return {"kernel_nodes": dict(counts, other=other_kernel_nodes),
            "aten_ops": len(aten), "aten_top": dict(top), "cost": total,
            "cost_by_kernel": dict(per_kernel, aten=ops.aten()),
            "predicted_device_s": predicted,
            "roofline": roofline_terms(total, card=card)}


def program_cost(probe, *, card: str) -> dict:
    """The cost of a captured program, node by node: its graph's K1/K2/K3
    nodes priced by :func:`node_cost`, the count of its other kernel nodes
    (PyTorch's), and the op census of the probe's warm-up call (the same
    ops, run eagerly) priced by ``hlo_cost``'s rule: the probe is made as
    ``GraphProbe(fn, device, warmup_mode=OpCensus())``.
    ``predicted_device_s`` sums each kernel's least time; ``roofline``
    holds the terms of the whole."""
    census = probe.warmup_mode
    if not isinstance(census, OpCensus):
        raise ValueError("program_cost needs a probe whose warm-up ran "
                         "under an OpCensus (warmup_mode=OpCensus())")
    kernels = [(n.kernel, n.args) for n in probe.census.nodes
               if n.kernel is not None]
    return _summary(kernels, census, card,
                    probe.census.stats["kernel_nodes"]["other"])


def log_cost(census: OpCensus, *, card: str) -> dict:
    """The cost of an eager run from its op census alone: the launch log's
    K1/K2/K3 records in place of the graph's nodes.  With no graph there is
    no count of other kernel nodes (None)."""
    return _summary(census.kernel_args(), census, card, None)


# --- collectives and the census over a mesh ------------------------------------

# JAX's collective kinds (hlo_analysis._COLLECTIVES), and the functional
# collectives that DTensor issues, by the kind each is.
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute", "send": "collective-permute",
    "recv": "collective-permute"}
COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def collective_kind(func) -> str | None:
    """JAX's kind of a functional collective op, ``"wait"`` for its
    ``wait_tensor``, None for any other op.  A collective of no known kind
    raises: the census never drops a collective."""
    if func.namespace not in COLLECTIVE_NAMESPACES:
        return None
    name = func.overloadpacket.__name__
    if name == "wait_tensor":
        return "wait"
    if name not in COLLECTIVE_OPS:
        raise ValueError(f"collective {func} has no kind in the census")
    return COLLECTIVE_OPS[name]


def collective_bytes(census) -> dict:
    """Per-collective-kind byte totals of one device, as JAX's
    ``hlo_analysis.collective_bytes`` sums them from the HLO: each
    collective's result bytes (the gathered tensor of an all-gather, the
    scattered one of a reduce-scatter), with ``count`` and ``total``."""
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = 0
    for kind, nbytes in census.collectives:
        out[kind] += nbytes
        out["count"] += 1
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


@contextlib.contextmanager
def _quiet_propagation(census):
    """While DTensor's sharding propagation runs an op on global fake
    tensors to learn its output's metadata (once per new op signature),
    ``census.propagating`` is set: that run is no device's work.  The hook
    is an instance attribute over ``ShardingPropagator.
    _propagate_tensor_meta_non_cached``, removed on exit."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    name = "_propagate_tensor_meta_non_cached"
    inner = getattr(prop, name, None)
    if inner is None:
        raise RuntimeError(f"this torch's DTensor has no {name}: the census "
                           f"cannot tell its metadata runs from the work")

    def hooked(op_schema):
        census.propagating += 1
        try:
            return inner(op_schema)
        finally:
            census.propagating -= 1

    setattr(prop, name, hooked)
    try:
        yield
    finally:
        delattr(prop, name)


class ShardedOpCensus(OpCensus):
    """The census of a program over a mesh of DTensors, per device.

    An op on DTensors comes to the census first; it declines it, so DTensor
    redistributes the inputs and runs the op on the local shards, and those
    local ops (and the functional collectives of the redistribution) come
    back to it.  So each op is priced on one device's shards (the rank-0
    shards), as XLA's post-partition ``cost_analysis()`` prices one device's
    program, and ``collectives`` holds (kind, result bytes) of every
    collective.  Ops on plain tensors (positions, masks) are priced as they
    are.  ``read`` holds the storages (:func:`storage_key`) of the tensors
    that some op took as an argument, so a caller can tell which of its
    inputs the program read, through a view or not (JAX's jit drops the
    arguments it never reads).  Memory: every tensor an op creates (not a view, not an input
    returned in place, not on ``meta``, which holds no data) counts as
    live until it is freed; ``peak`` is the most live at once, beyond
    whatever existed before the census.  Inside
    a K1/K2/K3 wrapper (a per-device region's kernels, run on fake shards)
    nothing is priced or counted live but the wrapper's output: the kernel
    is priced from the launch log, as :class:`OpCensus` leaves it, and its
    plain version's temporaries are no device's memory."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self.collectives: list = []
        self.read: set = set()
        self.propagating = 0
        self.live = self.peak = 0
        self._quiet = None

    def __enter__(self):
        self._quiet = _quiet_propagation(self)
        self._quiet.__enter__()
        try:
            entered = super().__enter__()
        except BaseException:
            self._quiet.__exit__(None, None, None)
            raise
        self.log.on_record = self._track_output
        return entered

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._quiet.__exit__(*exc)

    def _release(self, nbytes: int):
        self.live -= nbytes

    def _track_output(self, t):
        nbytes = t.numel() * t.element_size()
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._release, nbytes)

    def _track(self, func, args, out):
        if func.is_view:
            return
        inputs = {id(t) for t in _tensors(args)}
        for t in _tensors(out):
            if id(t) not in inputs and t.device.type != "meta":
                self._track_output(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.propagating:
            return out
        self.read.update(storage_key(t) for t in _tensors(
            [args, list(kwargs.values())]))
        if zones.in_kernel_call():
            return out
        kind = collective_kind(func)
        if kind is None:
            c = aten_cost(func, args, kwargs, out)
            if c is not None:
                self.ops.append((str(func), c))
        elif kind != "wait":
            self.collectives.append((kind, _nbytes(out)))
        self._track(func, args, out)
        return out

"""Dry run of the JAX package's cells (``launch/dryrun.py``): the crypto
cells run for real on one card and are planned on the production meshes,
the LM cells are planned on the host over the production meshes.

**Crypto cells** (``aegis_*``: ``_crypto_cell`` and the ``aegis_`` branch
of JAX's ``run_cell``).  The JAX cell lowers the Aegis sequencer op for a
pod slice's stacked batch, ``rows_per_core`` × its devices rows, from
``ShapeDtypeStruct``s, rows sharded over the data axes and the twiddle
planes over ``"model"`` on their output columns, and reads one device's
compiled program.  The port has two forms of a cell:

* *one device* (``--mesh`` not given, records ``__1``,
  :func:`run_crypto_cell`): ``rows_per_core`` × 1 rows against the whole
  planes, run for real on seeded data (``a`` uniform in [0, m), the planes
  random balanced int8 digits of the JAX shapes);
* *on a mesh* (``--mesh single|multi|both``, :func:`plan_crypto_cell`
  through :func:`run_cell`): JAX's rows and JAX's specs, planned as the LM
  cells are (below), the step a per-device region on rank 0's shards, and
  the record JAX's; then rank 0's block of that program run for real
  (:func:`run_share`, the record's ``share``: 128 rows against d ÷ 16
  output columns on both production meshes).  ``--mesh one`` plans the
  cell on 1 × 1 (its rows, the whole planes) for ``--redundancy``.

The step is JAX's, zones included (``wzone_*``, ``pzone_3limb`` /
``pzone_4limb``, ``channel_i`` per BN254 channel, ``vpu_montgomery`` around
``rns_to_field``), through ``staged_transform_traced`` or
``staged_transform_scan`` on ``accum``, ``reduction``, ``kappa``.

On CUDA a run (a one-device cell, a share) captures the step once as a
graph (a ``GraphProbe`` whose warm-up runs under the cost model's op
census), reads it node by node, validates it (V1–V7), prices it
(:mod:`repro_torch.launch.graph_cost`) and replays it under torch.profiler
for its device time.  On the CPU (``device="cpu"``) it runs once eagerly
under the op census, and the launch log stands in for the graph.  Either
way every output is checked: each channel against the int64 oracle (a @ W)
mod m, BN254's field digits against the plain ``rns_to_field`` of the same
channel outputs on the CPU; and the K1/K2 nodes against the cell's fold
profile.  A failed check raises.

**LM cells** (JAX's ``_lm_cell`` and the LM branch of ``run_cell``): every
(arch × shape × mesh) cell planned without allocation.  A ``"fake"``
process group of the mesh's size (rank 0) and its ``DeviceMesh`` stand in
for the 256 or 512 devices; the parameters, the AdamW state, the batch and
the decode cache are DTensors under ``FakeTensorMode``, each laid out by
:class:`~repro_torch.launch.shardings.ShardingRules` (JAX's specs), each
shard holding a shape and no data.  The step (``make_train_step``,
``make_prefill`` with ``max_len = seq_len + prefix``, or
``make_decode_step`` at the last position of the cache) runs once under
:class:`~repro_torch.launch.graph_cost.ShardedOpCensus`: every op on one
device's shards, priced, and every collective DTensor issues, counted.  The
plan allocates nothing and touches no device, by design, as JAX's dry run
compiles for 512 forced host CPU devices: it runs on the host whatever
``--device`` says, and is no fallback.  An op that DTensor cannot shard
makes the cell ``status: "error"`` with the op named; it is never
replicated to get past it.  Plain tensors the step makes (positions,
masks) are replicated by construction and enter as such
(``implicit_replication``).  No ``cuda_env`` bootstrap is needed: the world
size is the fake group's.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch aegis_dilithium,aegis_bn254 --shape serve_256,serve_8k
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch aegis_dilithium,aegis_bn254 --mesh both --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape serve_256 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
        --shape train_4k --mesh both

Records go to ``build/dryrun/`` (``--out`` elsewhere), one JSON file per
cell, named as JAX names them (``{arch}__{shape}__{single|multi}{_tag}``),
``__one`` for a 1 × 1 plan; a crypto cell run without ``--mesh`` is
``__1``.  A record names a mesh only if it was planned on it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.core import limb_gemm as G
from repro_torch.core import rns as R
from repro_torch.core import validator as V
from repro_torch.core import workloads as WK
from repro_torch.core import zones as Z
from repro_torch.core.field import DILITHIUM_Q
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.launch import graph_cost as GC
from repro_torch.launch import mesh as MESH
from repro_torch.launch import shardings as SH
from repro_torch.launch import specs as SP
from repro_torch.models import model as M
from repro_torch.models.layers import from_local
from repro_torch.models import steps as ST

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

CRYPTO_SHAPES = {
    # stacked-batch crypto serving cells (rows × degree)
    "serve_256": dict(rows_per_core=8, d=256),
    "serve_8k": dict(rows_per_core=8, d=8192),
}
WORKLOADS = {"aegis_bn254": "bn254", "aegis_dilithium": "dilithium"}
LIMBS = {"dilithium": 3, "bn254": 4}
K1, K2 = GC.K1, GC.K2
# The card the CPU's records are priced against (no card to ask).
MODEL_CARD = "H100"


def _check(cond, what: str):
    if not cond:
        raise AssertionError(what)


def moduli(workload: str) -> tuple:
    return ((DILITHIUM_Q,) if workload == "dilithium"
            else tuple(R.make_chain(9).moduli))


def cell_inputs(workload: str, rows: int, d: int, seed: int = 0,
                cols: int | None = None) -> tuple:
    """Seeded numpy inputs of a cell: ``a`` (rows, d) uint32 uniform in
    [0, Q) for Dilithium, (rows, d, 9) with channel c uniform in [0, m_c)
    for BN254; the twiddle planes (d, d, 3) or (9, d, d, 4) int8, random
    balanced digits in [-128, 127].  ``cols`` draws a block of ``cols``
    output columns of the planes, (d, cols, 3) or (9, d, cols, 4), as a
    mesh device holds them (the same generator, no whole planes made)."""
    rng = np.random.default_rng(seed)
    ms = moduli(workload)
    a = np.stack([rng.integers(0, m, (rows, d), dtype=np.uint64)
                  for m in ms], axis=-1).astype(np.uint32)
    shape = (len(ms), d, d if cols is None else cols, LIMBS[workload])
    w = rng.integers(-128, 128, shape, dtype=np.int8)
    if workload == "dilithium":
        return a[..., 0], w[0]
    return a, w


def make_step(workload: str, *, accum="fp32_mantissa", reduction="eager",
              kappa=None, scan_staging=False):
    """The cell's step ``step(a, w)``, JAX's ``_crypto_cell`` step: the
    staged transform (traced or scan form) of every channel in its zones.
    Dilithium returns its (rows, d) residues; BN254 ``(y, digits)``: the
    (rows, d, 9) channel residues and ``rns_to_field`` of them under
    ``vpu_montgomery``."""
    transform = (G.staged_transform_scan if scan_staging
                 else G.staged_transform_traced)
    limbs = LIMBS[workload]
    kw = dict(data_limbs=limbs, accum=accum, reduction=reduction, kappa=kappa)

    if workload == "dilithium":
        def step(a, w):
            with Z.workload_zone("dilithium", a.device), \
                    Z.precision_zone(3, a.device):
                return transform(a, w, modulus=DILITHIUM_Q, **kw)
        return step

    chain = R.make_chain(9)

    def step(a, w):
        dev = a.device
        with Z.workload_zone("bn254", dev), Z.precision_zone(4, dev):
            outs = []
            for ci, m in enumerate(chain.moduli):
                with Z.scope(f"channel_{ci}", dev):
                    outs.append(transform(a[..., ci], w[ci], modulus=m, **kw))
            y = torch.stack(outs, dim=-1)
            with Z.scope("vpu_montgomery", dev):
                return y, R.rns_to_field(y, chain)
    return step


def cell_profile(workload: str, d: int, *, accum="fp32_mantissa",
                 reduction="eager", kappa=None, scan_staging=False) -> dict:
    """The cell's fold profile (``workloads._fold_profile`` of its per-plane
    channel plans) and the K1/K2 calls it makes: passes × La·Lw K1 and one K2
    per fold, per channel; the scan form pads its passes to whole
    κ-windows, as ``staged_transform_scan`` does."""
    limbs = LIMBS[workload]
    plan = G.ChannelPlan(modulus=moduli(workload)[0], d=d, data_limbs=limbs,
                         tw_limbs=limbs, accum=accum, w_planes=None,
                         fused_operand=None)
    channels = len(moduli(workload))
    prof = WK._fold_profile([plan] * channels, reduction, kappa, None)
    passes, windows = prof["n_passes"], prof["windows_per_channel"]
    if scan_staging:
        step = min(plan.d_max, d)
        k_eff = (G.lazy_window_sizes(passes, step, limbs, accum, kappa)[0]
                 if reduction == "lazy" else 1)
        passes = -(-passes // k_eff) * k_eff
        windows = passes // k_eff
    return dict(prof, n_passes=passes, windows_per_channel=windows,
                n_folds=windows * channels,
                launches={K1: passes * limbs * limbs * channels,
                          K2: windows * channels})


def _checks(prof: dict) -> dict:
    """The validator's checks for a cell: eager, V1/V2 over its passes; lazy,
    V6/V7 over its κ-windows, as ``validator.checks_for``."""
    if prof["reduction"] == "eager":
        return {"expected_passes": prof["n_passes"]}
    return {"expect_eager": False, "expected_windows": prof["n_folds"],
            "n_diag": prof["n_diag"]}


def oracle_mod_np(a: np.ndarray, w: np.ndarray, m: int) -> np.ndarray:
    """(a @ W) mod m exactly, for residues a and W in [0, m), m < 2**32
    (numpy arrays or CPU tensors).
    Both are split into 16-bit halves; each of the four half products is a
    float64 matrix product on the CPU whose sums stay below d·2**32 <=
    2**53 (d <= 2**21), so every one is an exact integer; the four are
    reduced mod m and recombined with 2**16 and 2**32 mod m in int64.  The
    work runs as torch's CPU ops (threaded, with the BLAS every build
    carries); the result is an int64 numpy array."""
    a, w = (x.long() if isinstance(x, torch.Tensor)
            else torch.from_numpy(np.asarray(x, dtype=np.int64))
            for x in (a, w))
    if a.shape[-1] > 2**21:
        raise ValueError(f"oracle_mod_np is exact for d <= 2**21, got "
                         f"{a.shape[-1]}")

    def halves(x):
        return (x & 0xFFFF).double(), (x >> 16).double()

    def product(x, y):
        return (x @ y).long() % m

    (a_lo, a_hi), (w_lo, w_hi) = halves(a), halves(w)
    middle = (product(a_lo, w_hi) + product(a_hi, w_lo)) % m
    return ((product(a_lo, w_lo) + middle * ((1 << 16) % m) % m
             + product(a_hi, w_hi) * ((1 << 32) % m) % m) % m).numpy()


def _plane_values(w_planes: np.ndarray, m: int) -> torch.Tensor:
    """The values of balanced signed digit planes (..., L) int8, mod m, in
    int64: ``limbs.signed_digits_value`` as torch's threaded CPU ops."""
    digits = torch.from_numpy(w_planes)
    val = torch.zeros(digits.shape[:-1], dtype=torch.int64)
    for k in range(digits.shape[-1] - 1, -1, -1):
        val = (val << 8) + digits[..., k]
    return val % m


def channel_oracle(a: np.ndarray, w: np.ndarray, workload: str) -> np.ndarray:
    """Every channel of the cell against its int64 oracle: (rows, d) for
    Dilithium, (rows, d, 9) for BN254."""
    if workload == "dilithium":
        return oracle_mod_np(a, _plane_values(w, DILITHIUM_Q), DILITHIUM_Q)
    return np.stack([oracle_mod_np(a[..., c], _plane_values(w[c], m), m)
                     for c, m in enumerate(moduli(workload))], axis=-1)


def _check_outputs(out, a, w, workload: str, label: str) -> dict:
    """The cell's outputs against the oracles; seconds each took."""
    t0 = time.perf_counter()
    want = channel_oracle(a, w, workload)
    oracle_s = time.perf_counter() - t0
    y = out if workload == "dilithium" else out[0]
    _check(np.array_equal(y.cpu().numpy(), want),
           f"{label}: the channel transforms differ from (a @ W) mod m")
    out_s = {"oracle_s": oracle_s}
    if workload == "bn254":
        t0 = time.perf_counter()
        plain = R.rns_to_field(torch.from_numpy(want), R.make_chain(9))
        out_s["rns_plain_s"] = time.perf_counter() - t0
        _check(torch.equal(out[1].cpu(), plain),
               f"{label}: rns_to_field differs from its plain run on the "
               f"CPU")
    return out_s


def _kernel_events(prof):
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            yield ev


def _profiled_replay(probe, dev, want: dict, tries: int = 3) -> dict:
    """One replay of the probe's graph under torch.profiler: its device
    busy time, kernel events and K1/K2 events, which must equal the graph's
    nodes.  A window that starts tracing with the replay can miss the
    graph's first kernels, so each window replays the graph twice and
    records the second (a warm-up step of the profiler's schedule); one
    whose K1/K2 events still fall short is profiled again, up to
    ``tries``.  ``replays`` counts every replay made."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                probe.replay()
                torch.cuda.synchronize(dev)
                prof.step()
        events = list(_kernel_events(prof))
        counts = {name: sum(ev.count for ev in events
                            if f"{name}_kernel" in ev.key)
                  for name in want}
        if counts == want:
            return {"device_ms": sum(ev.self_device_time_total
                                     for ev in events) / 1e3,
                    "events": sum(ev.count for ev in events),
                    "k_events": counts, "profile_tries": attempt,
                    "replays": 2 * attempt}
    raise AssertionError(f"profiled replay: kernel events {counts} != the "
                         f"graph's nodes {want} in {tries} windows")


def empty_kernel_ms(dev, n: int = 50) -> float:
    """Mean device time of the empty kernel (``csrc/empty.cu``), the launch
    floor, over the launches torch.profiler recorded of ``n``."""
    from torch.profiler import ProfilerActivity, profile
    call = build.empty_call(dev)
    call()
    torch.cuda.synchronize(dev)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize(dev)
        empty = [ev for ev in _kernel_events(prof) if "empty_kernel" in ev.key]
        count = sum(ev.count for ev in empty)
        if count:
            return sum(ev.self_device_time_total for ev in empty) / count / 1e3
    raise AssertionError("empty kernel: the profiler showed no device time")


def _replay_ms(probe, dev, runs: int = 5) -> float:
    """Median time of one replay of the probe's graph between CUDA events
    (the graph instantiated first)."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        probe.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _run_block(workload: str, a_np, w_np, prof: dict, step, dev,
               label: str) -> dict:
    """Run the step on one block of inputs on ``dev`` and return what the
    record says of it: on CUDA captured once as a graph (its warm-up under
    the op census), read, validated, priced node by node and replayed
    (once to instantiate, five times timed, twice or more under
    torch.profiler); on the CPU run once eagerly under the op census, the
    launch log standing in for the graph.  The K1/K2 nodes must equal the
    fold profile and every output the oracles; any failed check raises."""
    a = torch.as_tensor(a_np.astype(np.int64), device=dev)
    w = torch.as_tensor(w_np, device=dev)
    out = {"input_bytes": a.numel() * a.element_size() + w.numel()}
    checks = _checks(prof)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else MODEL_CARD
    out["card"] = card
    if dev.type == "cuda":
        from repro_torch.core.scheduler.program import (GraphProbe,
                                                        capture_pool)
        pool = capture_pool(dev)
        pool_before = pool.bytes()
        t0 = time.perf_counter()
        probe = GraphProbe(lambda: step(a, w), dev,
                           warmup_mode=GC.OpCensus())
        out["capture_s"] = time.perf_counter() - t0
        out["read_s"] = probe.read_s
        out["pool_bytes"] = {k: v - pool_before[k]
                             for k, v in pool.bytes().items()}
        rep = V.validate_probe(probe, **checks)
        cost = GC.program_cost(probe, card=card)
        out["edges"] = rep.graph["edges"]
        out["nodes"] = rep.graph["nodes"]
    else:
        t0 = time.perf_counter()
        census = GC.op_census(step, a, w)
        out["capture_s"] = time.perf_counter() - t0
        nodes, edges = V.record_nodes(census.log.records)
        rep = V.check(census.log.records, nodes, edges,
                      scopes=census.log.scopes, **checks)[0]
        cost = GC.log_cost(census, card=card)
        out["edges"] = {"full": len(edges), "programmatic": 0}
        out["nodes"] = None
    out["v_codes"] = sorted({v[0] for v in rep.violations})
    _check(rep.ok, f"{label}: the validator flags {rep.violations[:4]}")
    kernel_nodes = cost["kernel_nodes"]
    _check({K1: kernel_nodes[K1], K2: kernel_nodes[K2]} == prof["launches"]
           and (rep.n_dots, rep.n_folds) == (kernel_nodes[K1],
                                              kernel_nodes[K2])
           and kernel_nodes[GC.K3] == 0,
           f"{label}: K1/K2 nodes {kernel_nodes}, the fold profile "
           f"{prof['launches']}")
    out.update(kernel_nodes=kernel_nodes, aten_ops=cost["aten_ops"],
               aten_top=cost["aten_top"],
               n_barriers=rep.n_barriers, cost=cost["cost"],
               cost_by_kernel=cost["cost_by_kernel"],
               roofline=cost["roofline"],
               predicted_device_ms=cost["predicted_device_s"] * 1e3)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        probe.replay()                          # instantiates the graph
        torch.cuda.synchronize(dev)
        out["instantiate_s"] = time.perf_counter() - t0
        out["replay_ms"] = _replay_ms(probe, dev)
        profiled = _profiled_replay(probe, dev, prof["launches"])
        out.update(profiled, replays=1 + 5 + profiled["replays"])
        out["empty_kernel_ms"] = empty_kernel_ms(dev)
        k_total = sum(v for v in kernel_nodes.values() if v)
        out["launch_floor_ms"] = k_total * out["empty_kernel_ms"]
        out["profiled_over_predicted"] = (out["device_ms"]
                                          / out["predicted_device_ms"])
        result = probe.out
    else:
        result = census.out
        out.update(device_ms=None, replay_ms=None, launch_floor_ms=None)
    out.update(_check_outputs(result, a_np, w_np, workload, label))
    out["exact"] = True
    return out


def run_crypto_cell(arch: str, shape: str, *, accum: str = "fp32_mantissa",
                    reduction: str = "eager", kappa: int | None = None,
                    scan_staging: bool = False, tag: str = "",
                    device=None) -> dict:
    """Run one crypto cell on ``device`` (CUDA unless ``"cpu"``) and return
    its record: the JAX record's keys where they mean something here
    (``arch``, ``shape``, ``status``, ``rows``, ``d``, ``workload``,
    ``accum``, ``reduction``, ``kappa``, ``scan_staging``, ``roofline``),
    ``mesh`` "1", the nodes by kernel and the edges (the launch log's
    records on the CPU), the input and graph-pool bytes in place of
    ``memory_analysis``, ``capture_s`` in place of ``compile_s``, the
    predicted device time (the sum of each kernel's least time) beside the
    launch floor (kernel nodes × the empty kernel's device time) and the
    profiled device time (None on the CPU: not measured), and the V codes.
    Any failed check raises."""
    t_start = time.perf_counter()
    dev = resolve_device(device)
    workload = WORKLOADS[arch]
    spec = CRYPTO_SHAPES[shape]
    rows, d = spec["rows_per_core"] * 1, spec["d"]      # one device
    prof = cell_profile(workload, d, accum=accum, reduction=reduction,
                        kappa=kappa, scan_staging=scan_staging)
    record = {"arch": arch, "shape": shape, "mesh": "1", "status": "ok",
              "tag": tag, "device": str(dev), "rows": rows, "d": d,
              "workload": workload, "accum": accum, "reduction": reduction,
              "kappa": kappa, "scan_staging": scan_staging,
              "fold_profile": prof}
    a_np, w_np = cell_inputs(workload, rows, d)
    step = make_step(workload, accum=accum, reduction=reduction, kappa=kappa,
                     scan_staging=scan_staging)
    record.update(_run_block(workload, a_np, w_np, prof, step, dev,
                             f"{arch} {shape}"))
    record["wall_s"] = time.perf_counter() - t_start
    return record


# --- the LM cells ---------------------------------------------------------------

# The card the LM plans are priced against: they run on no device.
LM_NOTE = ("planned on the host over a fake process group: no allocation, "
           "no device")
GENERATED_CODE_NOTE = ("0: the port runs eager ATen ops, it generates no "
                       "code")


def lm_config(arch: str, overrides: dict | None = None):
    """``get_config(arch)`` with ``overrides`` applied, keys starting with
    ``_`` (``_moe_replicate``) left to the rules, as JAX's ``_lm_cell``."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **{
            k: v for k, v in overrides.items() if not k.startswith("_")})
    return cfg


@contextlib.contextmanager
def fake_world(mesh: MESH.Mesh):
    """A ``"fake"`` process group of the mesh's size, as rank 0, and its
    ``DeviceMesh`` (device type ``cpu``: the plan touches no card).  The
    group is torn down on exit, so no later cell sees it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry run's LM cells make their own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield MESH.device_mesh(mesh, "cpu")
    finally:
        dist.destroy_process_group()


class _Placer:
    """Makes the cell's inputs DTensors of one mesh: each meta stand-in
    becomes a DTensor of the same global shape whose local shard (a fake
    tensor, under the cell's ``FakeTensorMode``) is rank 0's under the
    spec.  :meth:`read_bytes` sums the local shards that the step read, as
    JAX's jit counts only the arguments it keeps (``kept_var_idx``), plus
    ``scalar_bytes`` for inputs that are Python numbers here (the decode
    index, an int32 argument in JAX).  Those always count: no census sees
    a Python number read, where JAX drops an index its step does not read
    (mamba2_370m's decode, 4 bytes)."""

    def __init__(self, mesh: MESH.Mesh, dmesh):
        self.mesh, self.dmesh = mesh, dmesh
        self.locals: list = []
        self.scalar_bytes = 0

    def read_bytes(self, census) -> int:
        """The bytes of the local shards some op of ``census`` read."""
        return self.scalar_bytes + sum(
            t.numel() * t.element_size() for t in self.locals
            if GC.storage_key(t) in census.read)

    def tensor(self, t, spec):
        from torch.distributed.tensor import DTensor
        local = torch.empty(SH.local_shape(t.shape, spec, self.mesh),
                            dtype=t.dtype)
        self.locals.append(local)
        return DTensor.from_local(local, self.dmesh,
                                  SH.placements(spec, self.dmesh),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    def tree(self, named: dict, specs: dict) -> dict:
        return {k: self.tensor(v, specs[k]) for k, v in named.items()}

    def module(self, model, specs: dict):
        """The model's parameters swapped for DTensor parameters, in place."""
        for prefix, mod in model.named_modules():
            for name, p in list(mod._parameters.items()):
                full = f"{prefix}.{name}" if prefix else name
                mod._parameters[name] = torch.nn.Parameter(
                    self.tensor(p, specs[full]), requires_grad=p.requires_grad)
        return model

    def cache(self, cache: list, specs: list) -> list:
        return [self.tree(c, s) for c, s in zip(cache, specs)]

    def cache_allocator(self, rules):
        """``init_cache``'s signature, allocating DTensor shards laid out by
        the rules' cache specs, filled as ``init_cache`` fills them (the
        allocation is part of the step, as in JAX's prefill)."""
        from torch.distributed.tensor import full

        def alloc(cfg, batch, max_len, *, enc_len=0, device=None):
            meta = M.init_cache(cfg, batch, max_len, enc_len=enc_len,
                                device="meta")
            specs = rules.tree_cache_specs(meta)
            return [{k: full(t.shape, -1 if k == "pos" else 0,
                             dtype=t.dtype, device_mesh=self.dmesh,
                             placements=SH.placements(s[k], self.dmesh))
                     for k, t in c.items()} for c, s in zip(meta, specs)]
        return alloc


def _local_bytes(tree) -> int:
    """The local shard bytes of every tensor in a nested output."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


# --- the crypto cells on a mesh ------------------------------------------------


def _plan_keys(census, total: dict, arg_bytes: int, out_bytes: int,
               n_chips: int) -> dict:
    """JAX's record keys of one device's plan: ``memory`` (argument and
    output bytes as given, temp the census's peak of live bytes, generated
    code 0), ``bytes_per_device``, ``cost_raw`` and ``cost_corrected`` (the
    same numbers: the census walks every op, so there is no trip count to
    correct) of ``total``, ``collectives_naive`` and ``roofline`` (priced
    against the H100's data sheet, with ``n_chips``)."""
    coll = GC.collective_bytes(census)
    flops = float(total["tensor_ops"] + total["cuda_core_ops"]
                  + total["bf16_ops"])
    return {
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": census.peak,
                   "generated_code_size_in_bytes": 0},
        "memory_note": GENERATED_CODE_NOTE,
        "bytes_per_device": arg_bytes + census.peak,
        "cost_raw": {"flops": flops, "bytes_accessed": float(total["bytes"])},
        "cost_corrected": {"flops": flops, "bytes": float(total["bytes"]),
                           **{k: float(coll[k]) for k in GC.COLLECTIVES},
                           "collective_bytes": float(coll["total"])},
        "collectives_naive": coll,
        "roofline": dict(GC.roofline_terms(
            total, card=MODEL_CARD, coll_bytes=coll["total"] * n_chips,
            n_chips=n_chips), n_chips=n_chips)}



def crypto_specs(workload: str, mesh) -> dict:
    """JAX's specs of a crypto cell on ``mesh`` (``_crypto_cell``): ``a``'s
    rows over the data axes (``("pod", "data")`` on the multi-pod mesh,
    JAX's ``dp_spec``), the twiddle planes over ``model`` on their
    output-column dim (dim 1 of Dilithium's (d, d, 3), dim 2 of BN254's
    (9, d, d, 4)); and the output as a device's region leaves it, rows over
    the data axes and columns over ``model`` (JAX's compiled output
    sharding)."""
    dp = MESH.data_axes(mesh)
    rows = dp if len(dp) > 1 else dp[0]
    if workload == "dilithium":
        return {"a": SH.P(rows, None), "w": SH.P(None, "model", None),
                "out": SH.P(rows, "model")}
    return {"a": SH.P(rows, None, None), "w": SH.P(None, None, "model", None),
            "out": SH.P(rows, "model", None)}


def block_shapes(workload: str, shape: str, mesh) -> dict:
    """The global shapes of a cell on ``mesh`` (``rows_per_core`` × its
    devices rows) and rank 0's block of ``a`` and of the planes."""
    spec = CRYPTO_SHAPES[shape]
    rows, d = spec["rows_per_core"] * mesh.size, spec["d"]
    limbs, c = LIMBS[workload], len(moduli(workload))
    whole = ({"a": (rows, d), "w": (d, d, limbs)} if workload == "dilithium"
             else {"a": (rows, d, c), "w": (c, d, d, limbs)})
    specs = crypto_specs(workload, mesh)
    return {"rows": rows, "d": d, "global": whole,
            "block": {k: SH.local_shape(v, specs[k], mesh)
                      for k, v in whole.items()}}


def plan_crypto_cell(arch: str, shape: str, mesh: MESH.Mesh, *,
                     accum: str = "fp32_mantissa", reduction: str = "eager",
                     kappa: int | None = None, scan_staging: bool = False,
                     tag: str = "") -> dict:
    """Plan one crypto cell on ``mesh`` without allocation, as JAX's
    ``_crypto_cell`` lowers it and its ``run_cell`` reads it.  The cell has
    ``rows_per_core`` × the mesh's devices rows; under a ``"fake"`` process
    group of the mesh's size, ``a`` is a DTensor sharded over the data
    axes on its rows and the twiddle planes one sharded over ``model`` on
    their output columns (:func:`crypto_specs`), each local shard rank 0's,
    a fake tensor.  The step runs as a per-device region on those shards:
    ``to_local``, the staged transform of every channel and (BN254)
    ``rns_to_field``, then ``from_local`` of what JAX's step returns (the
    residues; BN254's field digits), all under the sharded census.  The
    ATen ops are priced on the shards, the K1/K2 calls from the launch log
    by ``graph_cost.node_cost`` (their plain versions are not priced), and
    every collective DTensor issues is counted (the region issues none).

    The record has JAX's keys, as the LM record has (:func:`run_lm_cell`:
    ``memory``, ``bytes_per_device``, ``cost_raw``, ``cost_corrected``,
    ``collectives_naive``, ``roofline`` with ``n_chips``, ``compile_s``),
    with ``rows`` and ``d`` as JAX's, the mesh planned on, the block
    shapes of ``a``, the planes and the output, the fold profile, the K1/K2
    calls a device (``kernel_nodes``, which must equal the profile's) and
    one device's predicted time.  A cell that raises is ``status:
    "error"``.  :func:`run_cell` adds rank 0's block run for real
    (``share``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    workload = WORKLOADS[arch]
    n_chips = mesh.size
    record = {"arch": arch, "shape": shape,
              "mesh": "x".join(map(str, mesh.devices.shape)),
              "multi_pod": "pod" in mesh.axis_names, "status": "ok",
              "tag": tag, "device": LM_NOTE, "workload": workload,
              "accum": accum, "reduction": reduction, "kappa": kappa,
              "scan_staging": scan_staging}
    try:
        shapes = block_shapes(workload, shape, mesh)
        record.update(rows=shapes["rows"], d=shapes["d"])
        prof = cell_profile(workload, shapes["d"], accum=accum,
                            reduction=reduction, kappa=kappa,
                            scan_staging=scan_staging)
        record["fold_profile"] = prof
        specs = crypto_specs(workload, mesh)
        step = make_step(workload, accum=accum, reduction=reduction,
                         kappa=kappa, scan_staging=scan_staging)
        dtypes = {"a": torch.int64, "w": torch.int8}
        with fake_world(mesh) as dmesh, FakeTensorMode():
            placer = _Placer(mesh, dmesh)
            a, w = (placer.tensor(torch.empty(shapes["global"][k],
                                              dtype=dtypes[k],
                                              device="meta"), specs[k])
                    for k in ("a", "w"))
            census = GC.ShardedOpCensus()
            with census:
                local = step(a.to_local(), w.to_local())
                if workload == "bn254":
                    local = local[1]            # JAX's step returns these
                cuts = SH.shard_sizes(specs["out"], mesh) + [1]
                out = from_local(local, dmesh,
                                  SH.placements(specs["out"], dmesh),
                                  [n * c for n, c in zip(local.shape, cuts)])
            record["shapes"] = {"a": list(a.to_local().shape),
                                "w": list(w.to_local().shape),
                                "out": list(local.shape)}
            out_bytes = _local_bytes(out)
            del out, local
            arg_bytes = placer.read_bytes(census)
        cost = GC.log_cost(census, card=MODEL_CARD)
        kernel_nodes = cost["kernel_nodes"]
        _check({K1: kernel_nodes[K1], K2: kernel_nodes[K2]}
               == prof["launches"] and kernel_nodes[GC.K3] == 0,
               f"{arch} {shape} on {record['mesh']}: K1/K2 calls a device "
               f"{kernel_nodes}, the fold profile {prof['launches']}")
        record.update(_plan_keys(census, cost["cost"], arg_bytes, out_bytes,
                                 n_chips))
        record.update(kernel_nodes=kernel_nodes, aten_ops=cost["aten_ops"],
                      aten_top=cost["aten_top"],
                      cost_by_kernel=cost["cost_by_kernel"],
                      predicted_device_ms=cost["predicted_device_s"] * 1e3)
        record["compile_s"] = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 - the cell's record says why
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-2000:])
    return record


def run_share(arch: str, shape: str, mesh: MESH.Mesh, *,
              accum: str = "fp32_mantissa", reduction: str = "eager",
              kappa: int | None = None, scan_staging: bool = False,
              device=None) -> dict:
    """Rank 0's block of the cell's program on ``mesh``, run for real on
    ``device`` (CUDA unless ``"cpu"``): its rows of ``a`` (rows_per_core ×
    devices ÷ data shards: 128 on both production meshes) against its
    block of the planes (d ÷ ``model`` output columns), drawn from the seed
    at the block's shapes (:func:`cell_inputs` with ``cols``), through the
    cell's step, captured, validated, priced, profiled and checked as
    :func:`run_crypto_cell` runs its cell; every output against (a @ W)
    mod m and BN254's digits against the plain ``rns_to_field``.  Returns
    the block's shapes, its configuration and the block run's keys."""
    t_start = time.perf_counter()
    dev = resolve_device(device)
    workload = WORKLOADS[arch]
    shapes = block_shapes(workload, shape, mesh)
    block = shapes["block"]
    rows, d = block["a"][0], shapes["d"]
    cols = block["w"][1] if workload == "dilithium" else block["w"][2]
    prof = cell_profile(workload, d, accum=accum, reduction=reduction,
                        kappa=kappa, scan_staging=scan_staging)
    share = {"mesh": "x".join(map(str, mesh.devices.shape)),
             "device": str(dev), "rows": rows, "cols": cols,
             "shapes": {k: list(v) for k, v in block.items()},
             "config": {"accum": accum, "reduction": reduction,
                        "kappa": kappa, "scan_staging": scan_staging},
             "fold_profile": prof}
    a_np, w_np = cell_inputs(workload, rows, d, cols=cols)
    step = make_step(workload, **share["config"])
    share.update(_run_block(workload, a_np, w_np, prof, step, dev,
                            f"{arch} {shape} share of {share['mesh']}"))
    share["wall_s"] = time.perf_counter() - t_start
    return share


def _lm_cell(arch: str, shape: str, mesh: MESH.Mesh, rules: SH.ShardingRules,
             placer: _Placer, overrides: dict | None = None):
    """The cell's step as ``run()`` over DTensor inputs that ``placer`` made
    (the bytes it read in ``placer.read_bytes``), and the record's extra keys, as
    JAX's ``_lm_cell`` builds its lowered step.  train: the AdamW step on
    the abstract train state, laid out as JAX's ``out_shardings`` say (the
    moments keep their specs' placements through ``adamw_update``, the
    metrics are then replicated); prefill: ``make_prefill`` with ``max_len = seq_len +
    prefix``, its cache allocated as shards; decode: ``make_decode_step``
    on the cache, the token and the last position of the cache (JAX's
    int32 index argument counts 4 bytes)."""
    from torch.distributed.tensor import DTensor, Replicate
    cfg = lm_config(arch, overrides)
    shape_cfg = SHAPES[shape]
    dmesh = placer.dmesh
    if shape_cfg.kind == "train":
        params, opt = SP.abstract_train_state(cfg)
        batch = SP.train_batch_specs(cfg, shape_cfg)
        pspecs = rules.tree_param_specs(params)
        ospecs = rules.tree_opt_specs(opt)
        bspecs = rules.tree_batch_specs(batch)
        model = placer.module(params, pspecs)
        opt = {"m": placer.tree(opt["m"], ospecs["m"]),
               "v": placer.tree(opt["v"], ospecs["v"]),
               "step": placer.tensor(opt["step"], SH.P())}
        batch = placer.tree(batch, bspecs)
        step = ST.make_train_step(cfg)
        replicated = [Replicate()] * dmesh.ndim

        def run():
            model_, opt_, metrics = step(model, opt, batch)
            metrics = {k: v.redistribute(dmesh, replicated)
                       if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
            return model_, opt_, metrics
        extra = {"kind": "train",
                 "tokens": shape_cfg.global_batch * shape_cfg.seq_len}
    elif shape_cfg.kind == "prefill":
        params = SP.abstract_params(cfg)
        model = placer.module(params, rules.tree_param_specs(params))
        batch = SP.train_batch_specs(cfg, shape_cfg)
        batch.pop("labels")
        batch = placer.tree(batch, rules.tree_batch_specs(batch))
        prefix = cfg.frontend_len if cfg.frontend == "vision_stub" else 0
        prefill = ST.make_prefill(cfg, max_len=shape_cfg.seq_len + prefix,
                                  init_cache=placer.cache_allocator(rules))

        def run():
            return prefill(model, batch)
        extra = {"kind": "prefill",
                 "tokens": shape_cfg.global_batch * shape_cfg.seq_len}
    else:  # decode
        params = SP.abstract_params(cfg)
        model = placer.module(params, rules.tree_param_specs(params))
        cache, token = SP.decode_inputs_specs(cfg, shape_cfg)
        cache = placer.cache(cache, rules.tree_cache_specs(cache))
        token = placer.tensor(token, rules.tree_batch_specs(
            {"tokens": token})["tokens"])
        placer.scalar_bytes += 4
        decode = ST.make_decode_step(cfg)
        index = shape_cfg.seq_len - 1

        def run():
            return decode(model, cache, token, index)
        extra = {"kind": "decode", "tokens": shape_cfg.global_batch}
    extra["n_params"] = sum(p.numel() for p in model.parameters())
    extra["model_flops"] = GC.model_flops(
        extra["n_params"], extra["tokens"], train=shape_cfg.kind == "train")
    return run, extra


def run_lm_cell(arch: str, shape: str, *, multi_pod: bool = False,
                overrides: dict | None = None, tag: str = "",
                mesh: MESH.Mesh | None = None) -> dict:
    """Plan one LM cell on a production mesh (or ``mesh``) and return JAX's
    record: ``memory`` (argument bytes = the local shards of every input
    the step reads, as JAX's jit drops the arguments it never reads;
    output = those of the step's results; temp = the peak of live bytes
    the step made beyond its inputs; generated code 0), ``bytes_per_device``,
    ``cost_raw`` and ``cost_corrected`` (the same numbers: the census walks
    every op, so there is no trip count to correct), ``collectives_naive``,
    ``roofline`` (priced against the H100's data sheet, with ``n_chips``),
    ``sharding_fallbacks[:20]`` and ``compile_s`` (seconds to plan).  A
    cell that raises is ``status: "error"`` with ``error`` and ``trace``;
    a cell ``shape_applicable`` refuses is ``skipped`` with its reason."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.perf_counter()
    if mesh is None:
        mesh = MESH.make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    record = {"arch": arch, "shape": shape,
              "mesh": "x".join(map(str, mesh.devices.shape)),
              "multi_pod": multi_pod, "status": "ok", "tag": tag,
              "device": LM_NOTE}
    try:
        ok, reason = shape_applicable(lm_config(arch, overrides), shape)
        if not ok:
            record.update(status="skipped", reason=reason)
            return record
        rules = SH.ShardingRules(mesh, moe_replicate=bool(
            (overrides or {}).get("_moe_replicate", False)))
        with fake_world(mesh) as dmesh, FakeTensorMode():
            placer = _Placer(mesh, dmesh)
            run, extra = _lm_cell(arch, shape, mesh, rules, placer,
                                  overrides)
            record.update(extra)
            census = GC.ShardedOpCensus()
            with implicit_replication(), census:
                out = run()
            out_bytes = _local_bytes(out)
            del out
            arg_bytes = placer.read_bytes(census)
        record.update(_plan_keys(census, census.aten(), arg_bytes,
                                 out_bytes, n_chips))
        record["aten_ops"] = len(census.ops)
        record["aten_top"] = dict(sorted(
            census.by_op().items(), key=lambda kv: -kv[1]["bytes"])[:6])
        record["sharding_fallbacks"] = rules.fallbacks[:20]
        record["compile_s"] = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 - the cell's record says why
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-2000:])
    return record


def run_cell(arch: str, shape: str, *, multi_pod: bool | None = None,
             kappa: int | None = None, accum: str = "fp32_mantissa",
             reduction: str = "eager", scan_staging: bool = False,
             overrides: dict | None = None, tag: str = "",
             device=None, share: dict | None = None) -> dict:
    """JAX's ``run_cell``.  An ``aegis_*`` arch is a crypto cell: with
    ``multi_pod`` None, the one-device cell run on ``device``
    (:func:`run_crypto_cell`, which raises on a failed check); with
    ``multi_pod`` set, the cell planned on that production mesh
    (:func:`plan_crypto_cell`) and rank 0's block of it run for real on
    ``device`` under ``share`` (:func:`run_share`, which raises on a failed
    check).  Both production meshes give a device the same block (128
    rows), so a ``share`` from one may be passed for the other: it is taken
    if its block shapes and configuration are this cell's, and refused
    otherwise.  Any other arch is an LM cell, planned on the host over the
    production mesh (``multi_pod`` None is the single-pod mesh, JAX's
    default); ``device`` does not apply to it."""
    if arch.startswith("aegis_"):
        kw = dict(accum=accum, reduction=reduction, kappa=kappa,
                  scan_staging=scan_staging)
        if multi_pod is None:
            return run_crypto_cell(arch, shape, tag=tag, device=device, **kw)
        mesh = MESH.make_production_mesh(multi_pod=multi_pod)
        rec = plan_crypto_cell(arch, shape, mesh, tag=tag, **kw)
        if rec["status"] == "ok":
            if share is None:
                share = run_share(arch, shape, mesh, device=device, **kw)
            block = {k: rec["shapes"][k] for k in ("a", "w")}
            if ({k: share["shapes"][k] for k in block} != block
                    or share["config"] != kw):
                raise ValueError(f"{arch} {shape} on {rec['mesh']}: the "
                                 f"share given ({share['shapes']}, "
                                 f"{share['config']}) is not this cell's "
                                 f"block ({block}, {kw})")
            rec["share"] = share
        return rec
    return run_lm_cell(arch, shape, multi_pod=bool(multi_pod),
                       overrides=overrides, tag=tag)


# the mesh of a cell's whole work on one device, the census its sharded
# plans are held to
ONE_MESH = MESH.make_mesh((1, 1), ("data", "model"), [torch.device("meta")])


def redundancy(out_dir: Path) -> dict:
    """Per cell with a 1x1 record (``--mesh one``) in ``out_dir``: for each
    production mesh recorded, per-device flops × devices over the 1x1
    plan's flops (1.0 when the devices split the work without repeating
    any of it), with the flops of both.  A crypto cell's rows grow with
    the mesh (``rows_per_core`` × devices), so its flops are taken per
    row."""
    def work(rec):
        return rec["cost_raw"]["flops"] / (
            rec["rows"] if rec["arch"] in WORKLOADS else 1)

    out = {}
    for one in sorted(out_dir.glob("*__one.json")):
        base = json.loads(one.read_text())
        if base["status"] != "ok":
            continue
        cell = {"one_flops": base["cost_raw"]["flops"]}
        for tag in ("single", "multi"):
            path = out_dir / one.name.replace("__one.json", f"__{tag}.json")
            if not path.exists():
                continue
            rec = json.loads(path.read_text())
            if rec["status"] != "ok":
                continue
            flops, n = rec["cost_raw"]["flops"], rec["roofline"]["n_chips"]
            cell[tag] = {"flops_per_device": flops,
                         "ratio": work(rec) * n / work(base)}
        out[f"{base['arch']}/{base['shape']}"] = cell
    return out


def _parse_overrides(items: list) -> dict:
    """``k=v`` pairs as JAX's CLI parses them: true/false, digits, else a
    string."""
    out = {}
    for ov in items:
        k, v = ov.split("=", 1)
        out[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.isdigit() else v)
    return out


def _print_record(rec: dict, mesh_tag: str):
    roof = rec.get("roofline", {})
    coll = rec.get("collectives_naive", {})
    if rec["arch"].startswith("aegis_"):
        run = rec.get("share", rec)     # a plan's block runs under share
        dev_ms = run.get("device_ms")
        measured = "not measured" if dev_ms is None else f"{dev_ms:.4g}ms"
        predicted = run.get("predicted_device_ms", math.nan)
        nodes = rec.get("kernel_nodes", {})
        planned = (f"bytes/dev={rec.get('bytes_per_device', '-')} "
                   f"coll={coll.get('total', '-')} "
                   f"plan={rec.get('compile_s', 0):.1f}s "
                   if "memory" in rec else "")
        print(f"[{rec['status']:7s}] {rec['arch']:16s} {rec['shape']:10s} "
              f"{mesh_tag:6s} rows={rec.get('rows', '-')} "
              f"dom={roof.get('dominant', '-'):8s} "
              f"K1/K2={nodes.get(K1, '-')}/{nodes.get(K2, '-')} {planned}"
              f"predicted={predicted:.4g}ms device={measured} "
              + (f"capture={run['capture_s']:.2f}s " if "capture_s" in run
                 else "")
              + rec.get("error", "")[:120], flush=True)
        return
    print(f"[{rec['status']:7s}] {rec['arch']:22s} {rec['shape']:12s} "
          f"{mesh_tag:6s} dom={roof.get('dominant', '-'):10s} "
          f"bytes/dev={rec.get('bytes_per_device', '-')} "
          f"coll={coll.get('total', '-')} "
          f"plan={rec.get('compile_s', 0):.1f}s "
          f"{(rec.get('error') or rec.get('reason', ''))[:120]}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help="an LM arch, aegis_dilithium, aegis_bn254, a comma "
                         "list, or 'all' (every LM arch and both crypto "
                         "archs)")
    ap.add_argument("--shape", default="all",
                    help=f"{', '.join([*SHAPES, *CRYPTO_SHAPES])}, a comma "
                         f"list or 'all' (each arch takes the shapes of its "
                         f"kind)")
    ap.add_argument("--mesh", default=None,
                    choices=["single", "multi", "both", "one"],
                    help="production mesh: 16x16 (single), 2x16x16 (multi) "
                         "or both, each cell planned on it (a crypto cell "
                         "also runs one device's block on --device); "
                         "default single for the LM cells, the one-device "
                         "run for the crypto cells; 'one' plans a cell on "
                         "a 1x1 mesh, the whole work on one device (records "
                         "__one, read by --redundancy)")
    ap.add_argument("--redundancy", default=None, metavar="DIR",
                    help="print, from the records in DIR, each cell's "
                         "per-device flops x devices over its 1x1 plan's "
                         "flops (per row for the crypto cells), and run no "
                         "cell")
    ap.add_argument("--accum", default="fp32_mantissa",
                    choices=["fp32_mantissa", "int32_native"])
    ap.add_argument("--reduction", default="eager", choices=["eager", "lazy"])
    ap.add_argument("--kappa", type=int, default=None,
                    help="lazy deferral window depth (passes per fold)")
    ap.add_argument("--scan-staging", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="ArchConfig overrides of the LM cells, e.g. "
                         "n_layers=2 or _moe_replicate=true")
    ap.add_argument("--device", default="cuda",
                    help="the device of the crypto cells' runs (the "
                         "one-device cell, a mesh cell's block): 'cuda' "
                         "(default), 'cuda:N' or 'cpu'; every plan runs on "
                         "the host")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {OUT_DIR})")
    args = ap.parse_args(argv)
    if args.redundancy:
        print(json.dumps(redundancy(Path(args.redundancy))), flush=True)
        return

    archs = (sorted(ARCHS) + sorted(WORKLOADS) if args.arch == "all"
             else args.arch.split(","))
    unknown = [a for a in archs if a not in ARCHS and a not in WORKLOADS]
    if unknown:
        ap.error(f"unknown arch {unknown}; expected "
                 f"{sorted(ARCHS) + sorted(WORKLOADS)}")
    if args.shape != "all":
        unknown = [s for s in args.shape.split(",")
                   if s not in SHAPES and s not in CRYPTO_SHAPES]
        if unknown:
            ap.error(f"unknown shape {unknown}; expected "
                     f"{[*SHAPES, *CRYPTO_SHAPES]}")
    if any(a in WORKLOADS for a in archs):
        resolve_device(args.device)     # no CUDA and no --device cpu: raise
    overrides = _parse_overrides(args.override) or None
    meshes = {None: [None], "single": [False], "multi": [True],
              "both": [False, True], "one": ["one"]}[args.mesh]
    out_dir = Path(args.out) if args.out else OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    failed = 0
    for arch in archs:
        valid = list(CRYPTO_SHAPES) if arch in WORKLOADS else list(SHAPES)
        shapes = valid if args.shape == "all" else [
            s for s in args.shape.split(",") if s in valid]
        for shape in shapes:
            share = None        # one device's block, the same on both meshes
            for multi in meshes:
                mesh_tag = {None: "1", False: "single", True: "multi",
                            "one": "one"}[multi]
                if arch in WORKLOADS:
                    kw = dict(accum=args.accum, reduction=args.reduction,
                              kappa=args.kappa,
                              scan_staging=args.scan_staging, tag=args.tag)
                    try:
                        if multi == "one":
                            rec = plan_crypto_cell(arch, shape, ONE_MESH,
                                                   **kw)
                        else:
                            rec = run_cell(arch, shape, multi_pod=multi,
                                           device=args.device, share=share,
                                           **kw)
                            share = rec.get("share")
                    except Exception as e:  # noqa: BLE001 - its record
                        rec = {"arch": arch, "shape": shape,
                               "mesh": mesh_tag, "status": "error",
                               "tag": args.tag,
                               "error": f"{type(e).__name__}: {e}",
                               "trace": traceback.format_exc()[-2000:]}
                elif multi == "one":
                    rec = run_lm_cell(arch, shape, overrides=overrides,
                                      tag=args.tag, mesh=ONE_MESH)
                else:
                    rec = run_cell(arch, shape, multi_pod=bool(multi),
                                   overrides=overrides, tag=args.tag)
                failed += rec["status"] == "error"
                suffix = f"_{args.tag}" if args.tag else ""
                path = out_dir / f"{arch}__{shape}__{mesh_tag}{suffix}.json"
                path.write_text(json.dumps(rec, indent=1))
                _print_record(rec, mesh_tag)
    if failed:
        raise SystemExit(f"{failed} cell(s) failed")


if __name__ == "__main__":
    main()

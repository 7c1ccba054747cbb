"""Dry run of the JAX package's cells (``launch/dryrun.py``): the crypto
cells run for real on one card, the LM cells are planned on the host over
the production meshes.

**Crypto cells** (``aegis_*``: ``_crypto_cell`` and the ``aegis_`` branch
of JAX's ``run_cell``).  The JAX cell lowers the Aegis sequencer op for a
pod slice's stacked batch from ``ShapeDtypeStruct``s and reads the compiled
module's cost.  Here the cell runs for real, on seeded data: ``a`` uniform
in [0, m), the twiddle planes random balanced int8 digits of the JAX
shapes, whole on the one card (the JAX cell shards them over the 16×16
mesh's ``"model"`` axis, so a cell here reads 16× a mesh device's plane
bytes for the same multiply-adds).  ``rows`` is ``rows_per_core`` × 1
device, as the JAX cell's are ``rows_per_core`` × its devices: under
``--mesh`` a crypto record names the mesh and keeps one device's rows.
The step is JAX's, zones included (``wzone_*``, ``pzone_3limb`` /
``pzone_4limb``, ``channel_i`` per BN254 channel, ``vpu_montgomery`` around
``rns_to_field``), through ``staged_transform_traced`` or
``staged_transform_scan`` on ``accum``, ``reduction``, ``kappa``.

On CUDA the step is captured once as a graph (a ``GraphProbe`` whose warm-up
runs under the cost model's op census), read node by node, validated
(V1–V7), priced (:mod:`repro_torch.launch.graph_cost`) and replayed under
torch.profiler for its device time.  On the CPU (``device="cpu"``) it runs
once eagerly under the op census, and the launch log stands in for the
graph.  Either way every output is checked: each channel against the int64
oracle (a @ W) mod m, BN254's field digits against the plain
``rns_to_field`` of the same channel outputs on the CPU; and the K1/K2
nodes against the cell's fold profile.  A failed check raises.

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
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape serve_256 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
        --shape train_4k --mesh both

Records go to ``build/dryrun/`` (``--out`` elsewhere), one JSON file per
cell, named as JAX names them (``{arch}__{shape}__{single|multi}{_tag}``);
a crypto cell run without ``--mesh`` is ``__1``.
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
from repro_torch.core import limbs as L
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


def cell_inputs(workload: str, rows: int, d: int, seed: int = 0) -> tuple:
    """Seeded numpy inputs of a cell: ``a`` (rows, d) uint32 uniform in
    [0, Q) for Dilithium, (rows, d, 9) with channel c uniform in [0, m_c)
    for BN254; the twiddle planes (d, d, 3) or (9, d, d, 4) int8, random
    balanced digits in [-128, 127]."""
    rng = np.random.default_rng(seed)
    ms = moduli(workload)
    a = np.stack([rng.integers(0, m, (rows, d), dtype=np.uint64)
                  for m in ms], axis=-1).astype(np.uint32)
    shape = (len(ms), d, d, LIMBS[workload])
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
    """(a @ W) mod m exactly in int64 numpy, for residues a and W in
    [0, m).  Where d·(m-1)² could leave int64, a is split into 16-bit
    halves, so each partial sum stays below d·2**47.  W is laid out by
    columns first, so numpy's integer product (no BLAS) reads both operands
    in order."""
    w = np.asfortranarray(w, dtype=np.int64)
    a = a.astype(np.int64)
    if a.shape[-1] * (m - 1) ** 2 < 2**63:
        return (a @ w) % m
    lo = (a & 0xFFFF) @ w % m
    hi = (a >> 16) @ w % m
    return (hi * 65536 + lo) % m


def channel_oracle(a: np.ndarray, w: np.ndarray, workload: str) -> np.ndarray:
    """Every channel of the cell against its int64 oracle: (rows, d) for
    Dilithium, (rows, d, 9) for BN254."""
    if workload == "dilithium":
        return oracle_mod_np(a, L.signed_digits_value(w) % DILITHIUM_Q,
                             DILITHIUM_Q)
    return np.stack([oracle_mod_np(a[..., c], L.signed_digits_value(w[c]) % m,
                                   m)
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
    label = f"{arch} {shape}"
    a_np, w_np = cell_inputs(workload, rows, d)
    a = torch.as_tensor(a_np.astype(np.int64), device=dev)
    w = torch.as_tensor(w_np, device=dev)
    record["input_bytes"] = a.numel() * a.element_size() + w.numel()
    step = make_step(workload, accum=accum, reduction=reduction, kappa=kappa,
                     scan_staging=scan_staging)
    checks = _checks(prof)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else MODEL_CARD
    record["card"] = card
    if dev.type == "cuda":
        from repro_torch.core.scheduler.program import (GraphProbe,
                                                        capture_pool)
        pool = capture_pool(dev)
        pool_before = pool.bytes()
        t0 = time.perf_counter()
        probe = GraphProbe(lambda: step(a, w), dev,
                           warmup_mode=GC.OpCensus())
        record["capture_s"] = time.perf_counter() - t0
        record["read_s"] = probe.read_s
        record["pool_bytes"] = {k: v - pool_before[k]
                                for k, v in pool.bytes().items()}
        rep = V.validate_probe(probe, **checks)
        cost = GC.program_cost(probe, card=card)
        record["edges"] = rep.graph["edges"]
        record["nodes"] = rep.graph["nodes"]
    else:
        t0 = time.perf_counter()
        census = GC.op_census(step, a, w)
        record["capture_s"] = time.perf_counter() - t0
        nodes, edges = V.record_nodes(census.log.records)
        rep = V.check(census.log.records, nodes, edges,
                      scopes=census.log.scopes, **checks)[0]
        cost = GC.log_cost(census, card=card)
        record["edges"] = {"full": len(edges), "programmatic": 0}
        record["nodes"] = None
    record["v_codes"] = sorted({v[0] for v in rep.violations})
    _check(rep.ok, f"{label}: the validator flags {rep.violations[:4]}")
    kernel_nodes = cost["kernel_nodes"]
    _check({K1: kernel_nodes[K1], K2: kernel_nodes[K2]} == prof["launches"]
           and (rep.n_dots, rep.n_folds) == (kernel_nodes[K1],
                                              kernel_nodes[K2])
           and kernel_nodes[GC.K3] == 0,
           f"{label}: K1/K2 nodes {kernel_nodes}, the fold profile "
           f"{prof['launches']}")
    record.update(kernel_nodes=kernel_nodes, aten_ops=cost["aten_ops"],
                  aten_top=cost["aten_top"],
                  n_barriers=rep.n_barriers, cost=cost["cost"],
                  cost_by_kernel=cost["cost_by_kernel"],
                  roofline=cost["roofline"],
                  predicted_device_ms=cost["predicted_device_s"] * 1e3)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        probe.replay()                          # instantiates the graph
        torch.cuda.synchronize(dev)
        record["instantiate_s"] = time.perf_counter() - t0
        record["replay_ms"] = _replay_ms(probe, dev)
        profiled = _profiled_replay(probe, dev, prof["launches"])
        record.update(profiled, replays=1 + 5 + profiled["replays"])
        record["empty_kernel_ms"] = empty_kernel_ms(dev)
        k_total = sum(v for v in kernel_nodes.values() if v)
        record["launch_floor_ms"] = k_total * record["empty_kernel_ms"]
        record["profiled_over_predicted"] = (record["device_ms"]
                                             / record["predicted_device_ms"])
        out = probe.out
    else:
        out = census.out
        record.update(device_ms=None, replay_ms=None, launch_floor_ms=None)
    record.update(_check_outputs(out, a_np, w_np, workload, label))
    record["exact"] = True
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
        total = census.aten()
        coll = GC.collective_bytes(census)
        record["memory"] = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": census.peak,
            "generated_code_size_in_bytes": 0}
        record["memory_note"] = GENERATED_CODE_NOTE
        record["bytes_per_device"] = arg_bytes + census.peak
        flops = total["tensor_ops"] + total["cuda_core_ops"] + \
            total["bf16_ops"]
        record["cost_raw"] = {"flops": float(flops),
                              "bytes_accessed": float(total["bytes"])}
        record["cost_corrected"] = {
            "flops": float(flops), "bytes": float(total["bytes"]),
            **{k: float(coll[k]) for k in GC.COLLECTIVES},
            "collective_bytes": float(coll["total"])}
        record["collectives_naive"] = coll
        record["roofline"] = dict(GC.roofline_terms(
            total, card=MODEL_CARD, coll_bytes=coll["total"] * n_chips,
            n_chips=n_chips), n_chips=n_chips)
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
             device=None) -> dict:
    """JAX's ``run_cell``: an ``aegis_*`` arch is a crypto cell, run on
    ``device`` (:func:`run_crypto_cell`, which raises on a failed check);
    with ``multi_pod`` set its record names that production mesh and keeps
    one device's rows.  Any other arch is an LM cell, planned on the host
    over the production mesh (``multi_pod`` None is the single-pod mesh,
    JAX's default); ``device`` does not apply to it."""
    if arch.startswith("aegis_"):
        rec = run_crypto_cell(arch, shape, accum=accum, reduction=reduction,
                              kappa=kappa, scan_staging=scan_staging,
                              tag=tag, device=device)
        if multi_pod is not None:
            mesh = MESH.make_production_mesh(multi_pod=multi_pod)
            rec.update(mesh="x".join(map(str, mesh.devices.shape)),
                       multi_pod=multi_pod,
                       mesh_rows="one device's rows (rows_per_core × 1)")
        return rec
    return run_lm_cell(arch, shape, multi_pod=bool(multi_pod),
                       overrides=overrides, tag=tag)


# the mesh of a cell's whole work on one device, the census its sharded
# plans are held to
ONE_MESH = MESH.make_mesh((1, 1), ("data", "model"), [torch.device("meta")])


def redundancy(out_dir: Path) -> dict:
    """Per LM cell with a 1x1 record (``--mesh one``) in ``out_dir``: for
    each production mesh recorded, per-device flops × devices over the 1x1
    plan's flops (1.0 when the devices split the work without repeating
    any of it), with the flops of both."""
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
                         "ratio": flops * n / cell["one_flops"]}
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
    if rec["arch"].startswith("aegis_"):
        dev_ms = rec.get("device_ms")
        measured = "not measured" if dev_ms is None else f"{dev_ms:.4g}ms"
        predicted = rec.get("predicted_device_ms", math.nan)
        nodes = rec.get("kernel_nodes", {})
        print(f"[{rec['status']:7s}] {rec['arch']:16s} {rec['shape']:10s} "
              f"{mesh_tag:6s} dom={roof.get('dominant', '-'):8s} "
              f"K1/K2={nodes.get(K1, '-')}/{nodes.get(K2, '-')} "
              f"predicted={predicted:.4g}ms device={measured} "
              f"capture={rec.get('capture_s', 0):.2f}s "
              f"{rec.get('error', '')[:120]}", flush=True)
        return
    coll = rec.get("collectives_naive", {})
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
                         "or both; default single for the LM cells, the "
                         "card alone for the crypto cells; 'one' plans the "
                         "LM cells on a 1x1 mesh, the whole work on one "
                         "device (records __one, read by --redundancy)")
    ap.add_argument("--redundancy", default=None, metavar="DIR",
                    help="print, from the records in DIR, each LM cell's "
                         "per-device flops x devices over its 1x1 plan's "
                         "flops, and run no cell")
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
                    help="the crypto cells' device: 'cuda' (default), "
                         "'cuda:N' or 'cpu'; the LM cells run on the host")
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
            for multi in meshes:
                if arch in WORKLOADS:
                    try:
                        rec = run_cell(arch, shape, multi_pod=multi,
                                       accum=args.accum,
                                       reduction=args.reduction,
                                       kappa=args.kappa,
                                       scan_staging=args.scan_staging,
                                       tag=args.tag, device=args.device)
                    except Exception as e:  # noqa: BLE001 - its record
                        rec = {"arch": arch, "shape": shape, "mesh": "1",
                               "status": "error", "tag": args.tag,
                               "error": f"{type(e).__name__}: {e}",
                               "trace": traceback.format_exc()[-2000:]}
                    mesh_tag = {None: "1", False: "single",
                                True: "multi"}[multi]
                elif multi == "one":
                    rec = run_lm_cell(arch, shape, overrides=overrides,
                                      tag=args.tag, mesh=ONE_MESH)
                    mesh_tag = "one"
                else:
                    rec = run_cell(arch, shape, multi_pod=bool(multi),
                                   overrides=overrides, tag=args.tag)
                    mesh_tag = "multi" if multi else "single"
                failed += rec["status"] == "error"
                suffix = f"_{args.tag}" if args.tag else ""
                path = out_dir / f"{arch}__{shape}__{mesh_tag}{suffix}.json"
                path.write_text(json.dumps(rec, indent=1))
                _print_record(rec, mesh_tag)
    if failed:
        raise SystemExit(f"{failed} cell(s) failed")


if __name__ == "__main__":
    main()

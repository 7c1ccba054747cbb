"""The dry run's LM cells (``repro_torch.launch.dryrun``) on the CPU, against
the JAX package's rules and record.

Each cell is planned as the port plans it (a ``"fake"`` process group of
the mesh's size, DTensors under ``FakeTensorMode``, the step run once under
the sharded census) at the smoke width of its arch — its smoke config's
fields through ``overrides``, with the full config's attention block sizes,
so the cells stay small — on a (4, 2) and a (2, 2, 2) mesh.  The record has
JAX's keys; its argument bytes equal the sum, over JAX's ``eval_shape``
leaves, of each leaf's shard under JAX's own specs on the same mesh; its
collectives are counted where the ``model`` axis is larger than 1, and
none on a 1 × 1 mesh.  The skip rule and ``model_flops`` are JAX's; the CLI
writes one record per cell.  Nothing here is timed.
"""
import dataclasses
import functools
import json
import math
import types

import numpy as np
import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.launch import hlo_analysis as JHA
from repro.launch import specs as JSP
from repro.launch.shardings import ShardingRules as JaxRules
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import graph_cost as GC
from repro_torch.launch import mesh as MESH

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
CELLS = [("olmo_1b", "train_4k"), ("mamba2_370m", "long_500k")]
# the JAX record's keys (src/repro/launch/dryrun.py:166-216)
RECORD_KEYS = ("arch", "shape", "mesh", "multi_pod", "status", "tag", "kind",
               "tokens", "memory", "bytes_per_device", "cost_raw",
               "cost_corrected", "collectives_naive", "roofline",
               "sharding_fallbacks", "compile_s")
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes")


def smoke_overrides(arch) -> dict:
    """The smoke config's fields that differ from the full config, but the
    attention block sizes (the full ones keep a 4k sequence at 4 blocks)."""
    full, smoke = get_config(arch), smoke_config(arch)
    return {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
            if f.name not in ("name", "attn_block_size",
                              "blockwise_attn_threshold")
            and getattr(smoke, f.name) != getattr(full, f.name)}


def _mesh(name):
    shape, axes = MESHES[name]
    return MESH.make_mesh(shape, axes, ["cpu"])


def _jax_cell_inputs(arch, shape, overrides):
    """JAX's cell (``_lm_cell``) as its step, its abstract arguments, and
    per argument the rule of its leaves' specs, ``spec(rules, path,
    leaf)``: params, optimizer state and batch for train; params and the
    batch without labels for prefill; params, cache, token and the int32
    index for decode."""
    import jax
    import jax.numpy as jnp
    from repro.models import steps as JST
    cfg = dataclasses.replace(jax_get_config(arch), **overrides)
    shape_cfg = JAX_SHAPES[shape]

    def param(rules, path, leaf):
        return rules.param_spec(path, leaf.shape)

    def batch_(rules, path, leaf):
        return rules.batch_spec(leaf.shape)

    def scalar(rules, path, leaf):
        return ()

    def moment(rules, path, leaf):
        return () if leaf.ndim == 0 else rules.param_spec(path[2:],
                                                          leaf.shape)

    def cache_(rules, path, leaf):
        return rules.cache_spec(path, leaf.shape)

    if shape_cfg.kind == "train":
        params, opt = JSP.abstract_train_state(cfg)
        batch = JSP.train_batch_specs(cfg, shape_cfg)
        return (JST.make_train_step(cfg), (params, opt, batch),
                (param, moment, batch_))
    params = JSP.abstract_params(cfg)
    if shape_cfg.kind == "prefill":
        batch = JSP.train_batch_specs(cfg, shape_cfg)
        batch.pop("labels")
        prefix = cfg.frontend_len if cfg.frontend == "vision_stub" else 0
        return (JST.make_prefill(cfg, max_len=shape_cfg.seq_len + prefix),
                (params, batch), (param, batch_))
    cache, token = JSP.decode_inputs_specs(cfg, shape_cfg)
    return (JST.make_decode_step(cfg),
            (params, cache, token, jax.ShapeDtypeStruct((), jnp.int32)),
            (param, cache_, batch_, scalar))


@functools.lru_cache(maxsize=None)
def _jax_kept(arch, shape, overrides_items) -> frozenset:
    """The flat indices of the arguments JAX's jitted cell keeps
    (``kept_var_idx``: it drops an argument the step never reads); the
    mesh does not change which."""
    import jax
    step, args, _ = _jax_cell_inputs(arch, shape, dict(overrides_items))
    lowered = jax.jit(step).lower(*args)
    return frozenset(lowered._lowering.compile_args["kept_var_idx"])


def _jax_argument_bytes(arch, shape, mesh_name, overrides) -> int:
    """The local shard bytes, under JAX's own specs, of the input arrays of
    JAX's cell that its jitted step keeps, and 4 bytes for the decode
    index whether JAX keeps it or not: the port's index is a Python
    number, which no census sees read (JAX drops it from mamba2_370m's
    decode, which reads no position)."""
    import jax
    _, args, specs = _jax_cell_inputs(arch, shape, overrides)
    kept = _jax_kept(arch, shape, tuple(sorted(overrides.items())))
    dims, axes = MESHES[mesh_name]
    rules = JaxRules(types.SimpleNamespace(
        axis_names=axes, devices=np.empty(dims, dtype=object)))
    sizes = dict(zip(axes, dims))

    def shard_bytes(leaf, spec):
        n = 1
        for i, d in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            cut = math.prod(sizes[a] for a in names)
            assert d % cut == 0
            n *= d // cut
        return n * np.dtype(leaf.dtype).itemsize

    def key(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)

    total, flat = 0, 0
    for arg, (tree, spec) in enumerate(zip(args, specs)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            index = JAX_SHAPES[shape].kind == "decode" and arg == 3
            if flat in kept or index:
                total += shard_bytes(leaf, spec(rules, key(path), leaf))
            flat += 1
    return total


@pytest.mark.parametrize("mesh_name", ["4x2", "2x2x2"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_lm_cell_plans_with_jax_record(arch, shape, mesh_name):
    overrides = smoke_overrides(arch)
    rec = D.run_lm_cell(arch, shape, overrides=overrides,
                        mesh=_mesh(mesh_name))
    assert rec["status"] == "ok", rec.get("error")
    for k in RECORD_KEYS:
        assert k in rec, k
    assert set(rec["memory"]) == set(MEMORY_KEYS)
    assert rec["mesh"] == mesh_name
    assert rec["memory"]["argument_size_in_bytes"] == _jax_argument_bytes(
        arch, shape, mesh_name, overrides)
    assert rec["memory"]["generated_code_size_in_bytes"] == 0
    assert rec["bytes_per_device"] == (rec["memory"]["argument_size_in_bytes"]
                                       + rec["memory"]["temp_size_in_bytes"])
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["cost_raw"]["flops"] == rec["cost_corrected"]["flops"] > 0
    coll = rec["collectives_naive"]
    assert set(coll) == set(GC.COLLECTIVES) | {"count", "total"}
    assert coll["count"] > 0 and coll["total"] == sum(
        coll[k] for k in GC.COLLECTIVES)
    roof = rec["roofline"]
    assert roof["n_chips"] == math.prod(MESHES[mesh_name][0])
    assert roof["collective_bytes_total"] == coll["total"] * roof["n_chips"]
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert set(JHA.roofline_terms({"flops": 1.0, "bytes accessed": 1.0}, 0,
                                  n_chips=1)) <= set(roof)
    json.dumps(rec)                              # the record is JSON


def test_one_device_mesh_has_no_collectives():
    rec = D.run_lm_cell("mamba2_370m", "long_500k",
                        overrides=smoke_overrides("mamba2_370m"),
                        mesh=_mesh("1x1"))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["collectives_naive"]["count"] == 0
    assert rec["roofline"]["t_collective_s"] == 0


def test_skip_rule_is_jax():
    for multi in (False, True):
        rec = D.run_cell("llama3_405b", "long_500k", multi_pod=multi)
        ok, reason = jax_shape_applicable(jax_get_config("llama3_405b"),
                                          "long_500k")
        assert not ok
        assert (rec["status"], rec["reason"]) == ("skipped", reason)
        assert rec["mesh"] == ("2x16x16" if multi else "16x16")


def test_model_flops_is_jax():
    for args, kw in (((1_176_764_416, 1_048_576), {}),
                     ((10**9, 128), {"train": False}),
                     ((3 * 10**9, 4096), {"active_params": 8 * 10**8})):
        assert GC.model_flops(*args, **kw) == JHA.model_flops(*args, **kw)


def test_cli_writes_one_record_per_cell(tmp_path, capsys):
    # the CLI parses integers and strings, as JAX's does; the one float the
    # smoke config changes (the MoE capacity factor) has no MoE to act on
    overrides = [f"{k}={v}" for k, v in smoke_overrides("mamba2_370m").items()
                 if k != "moe_capacity_factor"]
    D.main(["--arch", "mamba2_370m", "--shape", "long_500k", "--mesh", "both",
            "--tag", "t", "--out", str(tmp_path),
            *[a for ov in overrides for a in ("--override", ov)]])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["mamba2_370m__long_500k__multi_t.json",
                     "mamba2_370m__long_500k__single_t.json"]
    for name, mesh in zip(files, ("2x16x16", "16x16")):
        rec = json.loads((tmp_path / name).read_text())
        assert (rec["status"], rec["mesh"], rec["tag"]) == ("ok", mesh, "t")
    out = capsys.readouterr().out
    assert out.count("[ok     ]") == 2

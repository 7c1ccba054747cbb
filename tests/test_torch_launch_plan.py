"""The port's planning modules (``repro_torch.launch.{cuda_env,mesh,
shardings,specs}``) against the JAX package's on the CPU.

``cuda_env`` is held to ``xla_env``'s tests (``tests/test_device_parallel.py``)
with ``torch.cuda.is_initialized`` patched; the rules to JAX's own
fallback test (``tests/test_launch.py::test_sharding_rules_fallbacks``).
Then spec for spec, with no tolerance: for every arch at full width, on both
production meshes and on a (4, 2) and a (2, 2, 2) mesh, the port's
parameter, optimizer, batch and decode-cache specs equal JAX's (each
per-layer leaf JAX's stacked spec without its layer entry), and so do the
fallback lists.  JAX's ``ShardingRules`` reads only ``mesh.axis_names`` and
``mesh.devices.shape``, so it runs here on a stand-in over
``jax.eval_shape`` leaves, with no devices.  Last, the stand-ins: every
shape and dtype of the port's meta tensors equals JAX's ``eval_shape``
leaf under the converter's name map.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import specs as JSP
from repro.launch.shardings import ShardingRules as JaxRules
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import cuda_env as CE
from repro_torch.launch import mesh as MESH
from repro_torch.launch import shardings as SH
from repro_torch.launch import specs as SP

ALL_ARCHS = sorted(ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
DECODE_SHAPES = [s for s, c in SHAPES.items() if c.kind == "decode"]


# --- cuda_env ------------------------------------------------------------------


def test_with_visible_devices_pure_edit():
    assert CE.with_visible_devices(None, 3) == "0,1,2"
    # the operator's ids survive, the first n of them
    assert CE.with_visible_devices("4, 6,7", 2) == "4,6"
    assert CE.with_visible_devices("GPU-a,GPU-b", 2) == "GPU-a,GPU-b"
    with pytest.raises(ValueError):
        CE.with_visible_devices("", 1)          # every card hidden
    with pytest.raises(ValueError):
        CE.with_visible_devices("0,1", 3)
    with pytest.raises(ValueError):
        CE.with_visible_devices(None, 0)


def test_force_visible_device_count_before_cuda_init(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    env = {"CUDA_VISIBLE_DEVICES": "3,5,7"}
    assert CE.force_visible_device_count(2, env=env) == "3,5"
    assert env == {"CUDA_VISIBLE_DEVICES": "3,5"}
    env = {}
    assert CE.maybe_force_visible_device_count(4, env=env) is True
    assert env == {"CUDA_VISIBLE_DEVICES": "0,1,2,3"}


def test_force_visible_device_count_after_cuda_init(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert CE.cuda_initialised()
    env = {"CUDA_VISIBLE_DEVICES": "0,1"}
    # matching count: a no-op that must NOT clobber the caller's env
    CE.force_visible_device_count(2, env=env)
    assert env == {"CUDA_VISIBLE_DEVICES": "0,1"}
    with pytest.raises(RuntimeError):
        CE.force_visible_device_count(3, env=env)
    # best-effort variant degrades to False instead of raising
    assert CE.maybe_force_visible_device_count(3, env=env) is False
    assert env == {"CUDA_VISIBLE_DEVICES": "0,1"}


# --- meshes --------------------------------------------------------------------


def test_meshes():
    single = MESH.make_production_mesh()
    multi = MESH.make_production_mesh(multi_pod=True)
    assert (single.axis_names, tuple(single.devices.shape)) == (
        ("data", "model"), (16, 16))
    assert (multi.axis_names, list(multi.shape.items())) == (
        ("pod", "data", "model"), [("pod", 2), ("data", 16), ("model", 16)])
    assert {d.type for d in multi.devices.flat} == {"meta"}
    assert MESH.data_axes(single) == ("data",)
    assert MESH.data_axes(multi) == ("pod", "data")
    local = MESH.make_local_mesh("cpu")
    assert local.shape == {"pod": 1, "data": 1, "model": 1}
    # positions map to devices round-robin
    m = MESH.make_mesh((4, 2), ("pod", "data"), ["cpu", "meta"])
    assert [d.type for d in m.axis_devices("pod")] == ["cpu"] * 4
    assert [d.type for d in m.axis_devices("data")] == ["cpu", "meta"]
    with pytest.raises(RuntimeError):
        MESH.device_mesh(m)                     # no process group


# --- the rules -----------------------------------------------------------------


def test_sharding_rules_fallbacks():
    """``tests/test_launch.py::test_sharding_rules_fallbacks``, on the
    port's rules."""
    mesh = MESH.make_mesh((2, 4), ("data", "model"), ["meta"])
    rules = SH.ShardingRules(mesh)
    P = SH.P
    # divisible head dim -> model-sharded
    assert rules.param_spec("layers/attn/wq", (32, 1024, 512)) == P(
        None, None, "model")
    # non-divisible vocab (49155 % 4 != 0) -> fallback replicate
    assert rules.param_spec("embed", (49155, 64)) == P(None, None)
    assert rules.fallbacks
    # MoE expert axis divisible -> EP
    assert rules.param_spec("layers/moe/wi_gate", (8, 64, 128)) == P(
        "model", None, None)
    # MoE expert axis NOT divisible -> d_ff fallback
    assert rules.param_spec("layers/moe/wo", (6, 128, 64)) == P(
        None, "model", None)
    assert rules.param_spec("layers/moe/wi_up", (6, 64, 128)) == P(
        None, None, "model")
    # batch spec
    assert rules.batch_spec((16, 128)) == P("data", None)
    # long-context cache: B=1 -> sequence sharding over data (+ heads)
    assert rules.cache_spec("k", (4, 1, 1024, 8, 64)) == P(
        None, None, "data", "model", None)


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESH.make_mesh((2, 4, 2), ("pod", "data", "model"), ["meta"])
    spec = SH.P(("pod", "data"), None, "model")
    assert SH.placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert SH.placements(SH.P(), mesh) == (Replicate(),) * 3
    assert SH.local_shape((16, 3, 8), spec, mesh) == (2, 3, 4)
    with pytest.raises(ValueError):
        SH.local_shape((12, 3, 8), spec, mesh)
    assert SH.jax_path("layers.11.attn.wq") == "layers/attn/wq"
    assert SH.jax_path("enc_layers.0.mlp.wo") == "enc_layers/mlp/wo"
    assert SH.jax_path("ln_final.scale") == "ln_final/scale"


# --- parity with the JAX package ---------------------------------------------


def _jax_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def _key(path) -> str:
    """JAX's tree-path key (``shardings.py``'s ``by_path``)."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _leaves(tree) -> list:
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@functools.cache
def _jax_trees(arch):
    """JAX's stand-ins of one arch: abstract params and optimizer state,
    the train batch, and each decode shape's (cache, token)."""
    cfg = jax_get_config(arch)
    params, opt = JSP.abstract_train_state(cfg)
    batch = JSP.train_batch_specs(cfg, JAX_SHAPES["train_4k"])
    decode = {s: JSP.decode_inputs_specs(cfg, JAX_SHAPES[s])
              for s in DECODE_SHAPES}
    return params, opt, batch, decode


@functools.cache
def _port_trees(arch):
    cfg = get_config(arch)
    params, opt = SP.abstract_train_state(cfg)
    batch = SP.train_batch_specs(cfg, SHAPES["train_4k"])
    decode = {s: SP.decode_inputs_specs(cfg, SHAPES[s]) for s in DECODE_SHAPES}
    return params, opt, batch, decode


def _jax_param_specs(rules, tree, prefix_strip=False) -> dict:
    """JAX's ``tree_param_specs`` / ``tree_opt_specs`` leaf by leaf (their
    ``NamedSharding`` needs a real mesh; the specs do not)."""
    out = {}
    for path, leaf in _leaves(tree):
        key = _key(path)
        if prefix_strip and key.startswith(("m/", "v/")):
            key = key[2:]
        out[_key(path)] = (SH.P() if prefix_strip and leaf.ndim == 0
                           else rules.param_spec(key, leaf.shape))
    return out


def _unstacked(spec, stacked: bool):
    spec = tuple(spec)
    return spec[1:] if stacked and spec else spec


def _is_stacked(name: str) -> bool:
    return name.split(".")[0] in SH.STACKED


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_equal_jax(arch, mesh_name):
    jparams, jopt, jbatch, jdecode = _jax_trees(arch)
    params, opt, batch, decode = _port_trees(arch)
    jrules = JaxRules(_jax_mesh(mesh_name))
    shape, axes = MESHES[mesh_name]
    rules = SH.ShardingRules(MESH.make_mesh(shape, axes, ["meta"]))

    # parameters, then the optimizer state, in the dry run's order
    want = _jax_param_specs(jrules, jparams)
    got = rules.tree_param_specs(params)
    assert set(got) == {n for n, _ in params.named_parameters()}
    for name, spec in got.items():
        assert tuple(spec) == _unstacked(want[SH.jax_path(name)],
                                         _is_stacked(name)), name
    want_opt = _jax_param_specs(jrules, jopt, prefix_strip=True)
    got_opt = rules.tree_opt_specs(opt)
    assert tuple(got_opt["step"]) == tuple(want_opt["step"]) == ()
    for key in ("m", "v"):
        for name, spec in got_opt[key].items():
            assert tuple(spec) == _unstacked(
                want_opt[f"{key}/{SH.jax_path(name)}"], _is_stacked(name))
    # the train batch
    got_b = rules.tree_batch_specs(batch)
    for path, leaf in _leaves(jbatch):
        assert tuple(got_b[_key(path)]) == tuple(jrules.batch_spec(
            leaf.shape))
    # every decode shape's cache and token
    for s in DECODE_SHAPES:
        jcache, jtoken = jdecode[s]
        cache, token = decode[s]
        got_c = rules.tree_cache_specs(cache)
        assert len(got_c) == len(cache)
        for path, leaf in _leaves(jcache):
            want_c = _unstacked(jrules.cache_spec(_key(path), leaf.shape),
                                True)
            assert all(tuple(layer[_key(path)]) == want_c for layer in got_c)
        assert tuple(rules.tree_batch_specs({"tokens": token})["tokens"]) \
            == tuple(jrules.batch_spec(jtoken.shape))
    assert rules.fallbacks == jrules.fallbacks
    if arch == "whisper_large_v3" and "16" in mesh_name:
        # 51,866 rows do not divide by 16
        assert rules.fallbacks[:2] == [
            "embed: dim 51866 !% ('model',)",
            "lm_head: dim 51866 !% ('model',)"]


# --- the stand-ins -------------------------------------------------------------


def _dtype(leaf) -> str:
    return str(jnp.dtype(leaf.dtype))


def _torch_dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_stand_ins_equal_jax_eval_shape(arch):
    jparams, jopt, jbatch, jdecode = _jax_trees(arch)
    params, opt, batch, decode = _port_trees(arch)
    named = dict(params.named_parameters())
    assert {t.device.type for t in named.values()} == {"meta"}
    by_path = {}
    for name in named:
        by_path.setdefault(SH.jax_path(name), []).append(name)
    leaves = {_key(p): leaf for p, leaf in _leaves(jparams)}
    assert set(by_path) == set(leaves)
    for path, leaf in leaves.items():
        names = by_path[path]
        stacked = _is_stacked(names[0])
        assert len(names) == (leaf.shape[0] if stacked else 1), path
        for n in names:
            assert tuple(named[n].shape) == (leaf.shape[1:] if stacked
                                             else leaf.shape), n
            assert _torch_dtype(named[n]) == _dtype(leaf), n
    for path, leaf in _leaves(jopt):
        key = _key(path)
        if key == "step":
            assert (tuple(opt["step"].shape), _torch_dtype(opt["step"])) \
                == ((), _dtype(leaf))
            continue
        moment, _, rest = key.partition("/")
        for n in by_path[rest]:
            t = opt[moment][n]
            assert tuple(t.shape) == tuple(named[n].shape)
            assert _torch_dtype(t) == _dtype(leaf) == "float32"
    for path, leaf in _leaves(jbatch):
        t = batch[_key(path)]
        assert (tuple(t.shape), _torch_dtype(t)) == (leaf.shape, _dtype(leaf))
    for s in DECODE_SHAPES:
        jcache, jtoken = jdecode[s]
        cache, token = decode[s]
        assert (tuple(token.shape), _torch_dtype(token)) == (
            jtoken.shape, _dtype(jtoken))
        for path, leaf in _leaves(jcache):
            assert len(cache) == leaf.shape[0]
            for layer in cache:
                t = layer[_key(path)]
                assert t.device.type == "meta"
                assert (tuple(t.shape), _torch_dtype(t)) == (
                    leaf.shape[1:], _dtype(leaf))

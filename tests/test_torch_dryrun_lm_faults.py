"""The dry run's LM cells against four faults the port once had, on the CPU.

* ``grad_accum`` = 2 on a sharded batch: the cell plans ``ok`` on a (4, 2)
  and a (2, 2, 2) mesh with JAX's argument bytes (JAX's microbatches, the
  float32 buffers at the parameters' placements).
* Redundant work on the ``model`` axis: olmo_1b ``train_4k`` at full width
  with 2 layers does, summed over the devices, at most 1.10× the work of
  its own plan on a 1 × 1 mesh, on 1 × 16 and on 2 × 4 (the gradient of a
  norm's output is reduced, so no device gathers a ``wo`` weight to run its
  input gradient whole).
* Argument bytes of the inputs the step never reads: whisper_large_v3's
  decode reads neither its encoder nor its cross ``wk``/``wv``; the record
  counts what JAX's jit keeps (``kept_var_idx``).
* ``gqa_repeat_kv``: the port's attention repeats the KV heads as JAX's
  does, with JAX's output at 1e-5, the grouped form's output and
  gradients, and a dry-run record that prices the repeat.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.models import layers as L
from test_torch_dryrun_lm import (_jax_argument_bytes, _jax_cell_inputs,
                                  _jax_kept, _mesh, smoke_overrides)
from test_torch_lm_layers import _init, _load, _np, _x
from repro_torch.launch import mesh as MESH

TOL = dict(rtol=1e-5, atol=1e-5)
REDUNDANCY_BOUND = 1.10


@pytest.mark.parametrize("mesh_name", ["4x2", "2x2x2"])
def test_grad_accum_cell_plans_with_jax_bytes(mesh_name):
    overrides = smoke_overrides("olmo_1b") | {"grad_accum": 2}
    rec = D.run_lm_cell("olmo_1b", "train_4k", overrides=overrides,
                        mesh=_mesh(mesh_name))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["argument_size_in_bytes"] == _jax_argument_bytes(
        "olmo_1b", "train_4k", mesh_name, overrides)
    # the microbatches are gathered over the data axes and sharded again
    assert rec["collectives_naive"]["all-gather"] > 0


@pytest.fixture(scope="module")
def olmo_two_layers():
    """Per-device flops of olmo_1b ``train_4k`` at full width, 2 layers."""
    out = {}
    for name, shape in (("1x1", (1, 1)), ("1x16", (1, 16)),
                        ("2x4", (2, 4))):
        mesh = MESH.make_mesh(shape, ("data", "model"), ["cpu"])
        rec = D.run_lm_cell("olmo_1b", "train_4k", overrides={"n_layers": 2},
                            mesh=mesh)
        assert rec["status"] == "ok", rec.get("error")
        out[name] = (rec["cost_raw"]["flops"], mesh.size)
    return out


@pytest.mark.parametrize("mesh_name", ["1x16", "2x4"])
def test_sharded_plan_does_not_repeat_work(mesh_name, olmo_two_layers):
    whole, _ = olmo_two_layers["1x1"]
    flops, devices = olmo_two_layers[mesh_name]
    assert flops * devices <= REDUNDANCY_BOUND * whole, (
        f"{mesh_name}: {flops * devices / whole:.3f}x the 1x1 census")


@pytest.mark.parametrize("mesh_name", ["4x2", "2x2x2"])
def test_unread_inputs_are_not_argument_bytes(mesh_name):
    arch, shape = "whisper_large_v3", "decode_32k"
    overrides = smoke_overrides(arch)
    rec = D.run_lm_cell(arch, shape, overrides=overrides,
                        mesh=_mesh(mesh_name))
    assert rec["status"] == "ok", rec.get("error")
    _, args, _ = _jax_cell_inputs(arch, shape, overrides)
    kept = _jax_kept(arch, shape, tuple(sorted(overrides.items())))
    assert len(kept) < len(jax.tree_util.tree_leaves(args))  # JAX drops some
    assert rec["memory"]["argument_size_in_bytes"] == _jax_argument_bytes(
        arch, shape, mesh_name, overrides)


# (s, cache_len, cache_index): naive, blockwise, a decode step
GQA = {"naive": (12, None, None), "blockwise": (80, None, None),
       "decode": (1, 20, 12)}


def _gqa_cfgs(repeat: bool):
    """internlm2_20b's smoke config with 4 query heads over 2 KV heads."""
    kw = dict(n_kv_heads=2, gqa_repeat_kv=repeat)
    return (dataclasses.replace(smoke_config("internlm2_20b"), **kw),
            dataclasses.replace(jax_smoke_config("internlm2_20b"), **kw))


def _port_attention(cfg, jp, x, positions, cache_kv, index):
    """(out, d out·w / dx, d out·w / dwq, / dwk) of the port's module."""
    attn = _load(L.Attention(cfg, _init()), jp)
    xt = torch.from_numpy(x).requires_grad_(True)
    kw = {}
    if cache_kv is not None:
        kw = dict(cache={"k": torch.from_numpy(cache_kv[0].copy()),
                         "v": torch.from_numpy(cache_kv[1].copy())},
                  cache_index=index)
    out, _ = attn(xt, positions=torch.from_numpy(positions), **kw)
    w = torch.from_numpy(np.random.default_rng(9).normal(
        size=out.shape).astype(np.float32))
    grads = torch.autograd.grad((out * w).sum(), [xt, attn.wq, attn.wk])
    return [out.detach()] + list(grads)


@pytest.mark.parametrize("case", sorted(GQA))
def test_gqa_repeat_kv_is_jax_and_the_grouped_form(case):
    s, cache_len, index = GQA[case]
    cfg, jcfg = _gqa_cfgs(True)
    grouped, _ = _gqa_cfgs(False)
    assert cfg.n_heads // cfg.n_kv_heads == 2
    jp = JL.attention_params(jcfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(4)
    x = _x(rng, 2, s, cfg.d_model)
    base = 0 if index is None else index
    positions = np.broadcast_to(np.arange(s) + base, (2, s)).astype(np.int32)
    cache_kv, jkw = None, {}
    if cache_len:
        cache_kv = _x(rng, 2, 2, cache_len, cfg.n_kv_heads, cfg.d_head)
        jkw = dict(cache={"k": jnp.asarray(cache_kv[0]),
                          "v": jnp.asarray(cache_kv[1])}, cache_index=index)
    got = _port_attention(cfg, jp, x, positions, cache_kv, index)
    jout, _ = JL.attention_forward(jcfg, jp, jnp.asarray(x),
                                   positions=jnp.asarray(positions), **jkw)
    np.testing.assert_allclose(got[0].numpy(), _np(jout), **TOL)
    want = _port_attention(grouped, jp, x, positions, cache_kv, index)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_gqa_repeat_kv_is_priced():
    """internvl2_1b's smoke config has 4 query and 2 KV heads: with the
    repeat its decode reads the cache's KV heads twice over."""
    arch = "internvl2_1b"
    recs = [D.run_lm_cell(arch, "decode_32k", mesh=_mesh("4x2"),
                          overrides=smoke_overrides(arch)
                          | {"gqa_repeat_kv": repeat})
            for repeat in (False, True)]
    assert all(r["status"] == "ok" for r in recs), [r.get("error")
                                                   for r in recs]
    grouped, repeated = (r["cost_raw"]["bytes_accessed"] for r in recs)
    assert repeated > grouped
    assert (recs[0]["memory"]["argument_size_in_bytes"]
            == recs[1]["memory"]["argument_size_in_bytes"])

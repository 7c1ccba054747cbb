"""The port's LM (``repro_torch.models.model`` and ``steps``) against the JAX
package's on the CPU, for each of the ten archs at ``smoke_config``.

The JAX package's ``init_params`` draws the weights; ``params_from_jax``
carries them into an ``LMModel``.  The same numpy batch then goes through
both: train-mode logits, prefill logits and cache, one decode step (token,
logits, cache), in float32 at rtol = atol = 1e-4 (twenty-odd layers of
float32 sums taken in other orders).  Then the port's own counterparts of
``tests/test_models_smoke.py``'s decode, parameter-count and ring-cache
tests.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.models import steps as JST
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models import convert as C
from repro_torch.models import model as M
from repro_torch.models import steps as ST

ALL_ARCHS = sorted(ARCHS)
TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x, np.float32)


@functools.cache
def _pair(arch):
    """(JAX config, JAX params, port config, port model) for one smoke arch."""
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = C.params_from_jax(cfg, jax.tree.map(_np, params), device=CPU)
    return jcfg, params, cfg, model


def _batch(cfg, rng, b=2, s=16):
    """The JAX smoke tests' batch, as JAX and as torch arrays."""
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    arrays = {"tokens": tokens, "labels": tokens}
    if cfg.frontend:
        arrays["embeds"] = rng.normal(
            size=(b, max(cfg.frontend_len, 4), cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _caches_close(got, want):
    want = jax.tree.map(_np, want)
    got = C.cache_to_numpy(got)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **TOL, err_msg=name)


def test_configs_equal_the_jax_registry():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name in ARCHS:
        assert (ARCHS[name].__dict__ == JAX_ARCHS[name].__dict__
                and smoke_config(name).__dict__
                == jax_smoke_config(name).__dict__), name


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_logits_match_jax(arch):
    jcfg, params, cfg, model = _pair(arch)
    jb, tb = _batch(cfg, np.random.default_rng(0), s=32)
    with torch.no_grad():
        logits, aux, cache = model(tb, mode="train")
    jlogits, jaux, _ = JM.forward(jcfg, params, jb, mode="train")
    assert cache is None and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, params, cfg, model = _pair(arch)
    rng = np.random.default_rng(1)
    jb, tb = _batch(cfg, rng)
    logits, cache = ST.make_prefill(cfg, max_len=24)(model, tb)
    jlogits, jcache = jax.jit(JST.make_prefill(jcfg, max_len=24))(params, jb)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    _caches_close(cache, jcache)

    tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    nxt, logits, cache = ST.make_decode_step(cfg)(model, cache,
                                                  torch.from_numpy(tok), 16)
    jnxt, jlogits, jcache = jax.jit(JST.make_decode_step(jcfg))(
        params, jcache, jnp.asarray(tok), jnp.int32(16))
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    _caches_close(cache, jcache)


@pytest.mark.parametrize("arch", ["olmo_1b", "granite_moe_3b_a800m",
                                  "internvl2_1b"])
def test_eval_step_matches_jax(arch):
    """Forward-only loss: CE over the token tail (a VLM's prefix dropped)
    plus the MoE aux term."""
    jcfg, params, cfg, model = _pair(arch)
    jb, tb = _batch(cfg, np.random.default_rng(2))
    got = ST.make_eval_step(cfg)(model, tb)
    want = JST.make_eval_step(jcfg)(params, jb)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), **TOL,
                                   err_msg=key)


def test_cache_round_trips_through_the_jax_layout():
    """A JAX cache converted in, then decoded from, gives JAX's decode."""
    jcfg, params, cfg, model = _pair("hymba_1_5b")
    rng = np.random.default_rng(3)
    jb, _ = _batch(cfg, rng)
    _, jcache = jax.jit(JST.make_prefill(jcfg, max_len=24))(params, jb)
    cache = C.cache_from_jax(cfg, jax.tree.map(np.asarray, jcache), CPU)
    assert cache[0]["pos"].dtype == torch.int32
    assert cache[0]["state"].dtype == torch.float32
    _caches_close(cache, jcache)
    tok = np.array([[5], [7]], np.int32)
    _, logits, _ = ST.make_decode_step(cfg)(model, cache,
                                            torch.from_numpy(tok), 16)
    _, jlogits, _ = jax.jit(JST.make_decode_step(jcfg))(
        params, jcache, jnp.asarray(tok), jnp.int32(16))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)


def test_sliding_window_ring_wraps_like_jax():
    """Hymba's ring cache shorter than the prompt (max_len 12 < 16 < the
    window of 64): the prefill keeps the last 12 positions, position p at
    slot p % 12, and decode wraps to slot index % 12, overwriting the
    oldest entry, step for step as in JAX."""
    jcfg, params, cfg, model = _pair("hymba_1_5b")
    jb, tb = _batch(cfg, np.random.default_rng(4))
    _, cache = ST.make_prefill(cfg, max_len=12)(model, tb)
    _, jcache = jax.jit(JST.make_prefill(jcfg, max_len=12))(params, jb)
    _caches_close(cache, jcache)
    decode, jdecode = ST.make_decode_step(cfg), jax.jit(
        JST.make_decode_step(jcfg))
    tok, jtok = torch.tensor([[3], [4]], dtype=torch.int32), \
        jnp.asarray([[3], [4]], jnp.int32)
    for i in range(16, 24):
        tok, logits, cache = decode(model, cache, tok, i)
        jtok, jlogits, jcache = jdecode(params, jcache, jtok, jnp.int32(i))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    _caches_close(cache, jcache)
    assert sorted(C.cache_to_numpy(cache)["pos"][0, 0]) == list(range(12, 24))


def test_params_from_jax_rejects_a_tree_that_does_not_fit():
    _, params, _, _ = _pair("olmo_1b")
    with pytest.raises(ValueError, match="does not fit"):
        C.params_from_jax(smoke_config("starcoder2_7b"),
                          jax.tree.map(_np, params), device=CPU)
    _, params, cfg, _ = _pair("llama3_405b")
    bad = dict(jax.tree.map(_np, params), embed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="embed"):
        C.params_from_jax(cfg, bad, device=CPU)


def test_params_from_jax_keeps_float32_leaves_in_a_bf16_model():
    _, params, cfg, _ = _pair("granite_moe_3b_a800m")
    model = C.params_from_jax(cfg, jax.tree.map(_np, params), device=CPU,
                              dtype="bfloat16")
    assert model.cfg.dtype == "bfloat16"
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[0].moe.router.dtype == torch.float32
    np.testing.assert_array_equal(
        model.layers[1].moe.router.detach().numpy(),
        _np(params["layers"]["moe"]["router"][1]))


# --- the port's own counterparts of tests/test_models_smoke.py ------------------


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_370m", "hymba_1_5b",
                                  "whisper_large_v3", "granite_moe_3b_a800m"])
def test_decode_matches_prefill(arch):
    """Greedy decode against the cache reproduces full-context logits."""
    cfg = smoke_config(arch)
    model = M.LMModel(cfg, device=CPU, seed=2)
    rng = np.random.default_rng(1)
    b, s = 2, 16
    _, batch = _batch(cfg, rng, b=b, s=s)
    _, cache = ST.make_prefill(cfg, max_len=s + 8)(model, batch)
    tok_next = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32))
    _, logits_d, cache = ST.make_decode_step(cfg)(model, cache, tok_next, s)
    full = {"tokens": torch.cat([batch["tokens"], tok_next], dim=1)}
    if "embeds" in batch:
        full["embeds"] = batch["embeds"]
    with torch.no_grad():
        logits_full, _, _ = model(full, mode="train")
    np.testing.assert_allclose(logits_d[:, -1].numpy(),
                               logits_full[:, -1].numpy(), rtol=2e-2,
                               atol=2e-2)


def test_param_counts_plausible():
    """Full configs land in the advertised parameter-count ballpark."""
    assert 15e9 < get_config("internlm2_20b").params_count() < 25e9
    assert 350e9 < get_config("llama3_405b").params_count() < 480e9
    assert 0.8e9 < get_config("olmo_1b").params_count() < 1.6e9
    assert 5e9 < get_config("starcoder2_7b").params_count() < 9e9
    assert 10e9 < get_config("moonshot_v1_16b_a3b").params_count() < 30e9
    assert 0.25e9 < get_config("mamba2_370m").params_count() < 0.6e9


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_370m"])
def test_model_holds_the_counted_parameters(arch):
    """An LMModel holds the parameters that the JAX tree holds (a smoke
    config: ``params_count`` approximates the full ones)."""
    jcfg, params, cfg, model = _pair(arch)
    jax_n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == jax_n


def test_sliding_window_ring_cache():
    """Hymba: decode far past the window keeps only in-window history."""
    cfg = smoke_config("hymba_1_5b")
    assert cfg.attn_window and cfg.attn_window < 128
    model = M.LMModel(cfg, device=CPU, seed=4)
    b, s = 1, 32
    _, batch = _batch(cfg, np.random.default_rng(3), b=b, s=s)
    _, cache = ST.make_prefill(cfg, max_len=cfg.attn_window)(model, batch)
    decode = ST.make_decode_step(cfg)
    tok = torch.tensor([[1]], dtype=torch.int32)
    for i in range(s, s + 4):
        tok, logits, cache = decode(model, cache, tok, i)
    assert torch.isfinite(logits).all()
    pos = cache[0]["pos"][0]
    assert sorted(pos[pos >= 0].tolist()) == list(range(s + 4))

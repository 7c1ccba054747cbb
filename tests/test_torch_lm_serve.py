"""The port's LM serving entry point (``repro_torch.launch.serve.serve_lm``
and ``--mode lm``) against the JAX package's ``serve_lm`` on the CPU.

With the JAX package's weights carried across (``params_from_jax``), the
port's greedy tokens equal JAX's for each of the ten archs at
``smoke_config``, seed for seed.  One bf16 run per dense, GELU and hybrid
family holds the logits to the JAX decode test's 2e-2.  Both packages
refuse a VLM prefix that overflows the cache; the port raises without CUDA
unless asked for the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.serve import serve_lm as jax_serve_lm
from repro.models import model as JM
from repro.models import steps as JST
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import serve as SERVE
from repro_torch.launch.serve import serve_lm
from repro_torch.models import convert as C
from repro_torch.models import model as M
from repro_torch.models import steps as ST

CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x, np.float32)


def _converted(jcfg, cfg, seed=0):
    """JAX's serve_lm weights (``init_params(cfg, PRNGKey(seed))``) and the
    port's model holding them."""
    params = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return params, C.params_from_jax(cfg, jax.tree.map(_np, params),
                                     device=CPU)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_lm_tokens_match_jax(arch):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    _, model = _converted(jcfg, cfg)
    want, _ = jax_serve_lm(jcfg)
    got, seconds, stats = serve_lm(cfg, model=model, device="cpu")
    assert got.dtype == np.int32 and got.shape == (2, 8) == want.shape
    np.testing.assert_array_equal(got, want)
    assert seconds > 0 and stats["device"] == "cpu"
    assert stats["prefill_ms"] > 0 and stats["decode_ms_per_token"] > 0
    assert stats["peak_allocated_bytes"] is None


@pytest.mark.parametrize("arch", ["olmo_1b", "starcoder2_7b", "hymba_1_5b"])
def test_bf16_matches_jax(arch):
    """bf16 weights and activations in both packages: train-mode logits,
    prefill logits and one decode step's logits within 2e-2 (bf16 rounds
    at other places in the two frameworks); the decoded token where JAX's
    top two logits are further apart than that."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="bfloat16")
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    params, model = _converted(jcfg, cfg)
    assert model.embed.dtype == torch.bfloat16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tol = dict(rtol=2e-2, atol=2e-2)
    with torch.no_grad():
        logits, _, _ = model({"tokens": torch.from_numpy(tokens)},
                             mode="train")
    jlogits, _, _ = JM.forward(jcfg, params, {"tokens": jnp.asarray(tokens)},
                               mode="train")
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **tol)
    logits, cache = ST.make_prefill(cfg, 24)(model,
                                             {"tokens": torch.from_numpy(tokens)})
    jlogits, jcache = jax.jit(JST.make_prefill(jcfg, 24))(
        params, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **tol)
    tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    nxt, logits, _ = ST.make_decode_step(cfg)(model, cache,
                                              torch.from_numpy(tok), 16)
    jnxt, jlogits, _ = jax.jit(JST.make_decode_step(jcfg))(
        params, jcache, jnp.asarray(tok), jnp.int32(16))
    jl = _np(jlogits)[:, -1]
    np.testing.assert_allclose(logits[:, -1].numpy(), jl, **tol)
    top2 = np.sort(jl, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol["atol"]
    np.testing.assert_array_equal(nxt.numpy()[clear], np.asarray(jnxt)[clear])


def test_vlm_prefix_that_overflows_the_cache_raises_in_both():
    """The vision prefix plus the prompt must fit ``prompt_len +
    decode_steps`` (the JAX package's cache): 32 + 16 > 24.  JAX raises a
    TypeError from dynamic_update_slice; the port a ValueError naming the
    same shapes.  The smoke prefix of 8 fits exactly (served above)."""
    jcfg = dataclasses.replace(jax_smoke_config("internvl2_1b"),
                               frontend_len=32)
    cfg = dataclasses.replace(smoke_config("internvl2_1b"), frontend_len=32)
    shapes = r"update shape \(2, 48, 2, 32\).*operand shape \(2, 24, 2, 32\)"
    with pytest.raises(TypeError, match=shapes):
        jax_serve_lm(jcfg)
    with pytest.raises(ValueError, match=shapes):
        serve_lm(cfg, device="cpu")


def test_serve_lm_draws_its_model_from_the_seed():
    cfg = smoke_config("mamba2_370m")
    a, _, _ = serve_lm(cfg, device="cpu", seed=3)
    b, _, _ = serve_lm(cfg, device="cpu", seed=3,
                       model=M.LMModel(cfg, device="cpu", seed=3))
    np.testing.assert_array_equal(a, b)
    w3 = M.LMModel(cfg, device="cpu", seed=3).embed.detach()
    w4 = M.LMModel(cfg, device="cpu", seed=4).embed.detach()
    assert not torch.equal(w3, w4)
    assert abs(float(w3.std()) - 0.02) < 2e-3


def test_serve_lm_refuses_a_model_of_another_config():
    cfg = smoke_config("olmo_1b")
    model = M.LMModel(smoke_config("starcoder2_7b"), device="cpu")
    with pytest.raises(ValueError, match="starcoder2_7b_smoke"):
        serve_lm(cfg, model=model, device="cpu")


def test_no_cpu_fallback_without_cuda():
    """``serve_lm``, ``LMModel`` and the CLI default to CUDA and raise
    without it: nothing silently runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = smoke_config("olmo_1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.LMModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SERVE.main(["--mode", "lm", "--smoke"])


def test_cli_lm_mode_on_the_cpu(capsys):
    SERVE.main(["--mode", "lm", "--arch", "whisper_large_v3", "--smoke",
                "--decode-steps", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("decoded (2, 4) tokens in ")
    assert out[1].startswith("whisper_large_v3_smoke (float32) on cpu: "
                             "prefill ")
    assert "ms/token" in out[1] and "not measured" in out[1]

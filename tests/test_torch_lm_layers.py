"""The port's LM layers (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the CPU.

The same numpy inputs (and the JAX package's initial weights, carried
across by ``models.convert``) go through both; float32 throughout, compared
at rtol = atol = 1e-5 (the two frameworks sum in other orders, and XLA's
and torch's exp, rsqrt, sin and cos differ in the last bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro_torch.configs import smoke_config
from repro_torch.models import layers as L
from repro_torch.models.convert import state_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _load(module, jax_params):
    """Copy a JAX parameter dict into a port module, leaf by leaf."""
    state = {k: torch.from_numpy(v) for k, v in state_from_jax(
        jax.tree.map(_np, jax_params)).items()}
    module.load_state_dict(state, strict=True)
    return module


def _init():
    return L.ParamInit(torch.device("cpu"), 0)


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# --- norms, RoPE --------------------------------------------------------------


@pytest.mark.parametrize("arch,norm", [("llama3_405b", "rmsnorm"),
                                       ("starcoder2_7b", "layernorm"),
                                       ("olmo_1b", "layernorm_np")])
def test_norm_matches_jax(arch, norm):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    assert cfg.norm == norm
    rng = np.random.default_rng(0)
    x = _x(rng, 2, 5, cfg.d_model) * 3.0 + 0.5
    w, b = _x(rng, cfg.d_model), _x(rng, cfg.d_model)
    jp = {"ln": {}}
    if norm != "layernorm_np":
        jp["ln"]["scale"] = jnp.asarray(w)
    if norm == "layernorm":
        jp["ln"]["bias"] = jnp.asarray(b)
    owner = torch.nn.Module()
    owner.ln = _load(L.Norm(cfg, cfg.d_model, _init()), jp["ln"])
    with torch.no_grad():
        got = L.apply_norm(cfg, owner, torch.from_numpy(x), "ln")
    want = JL.apply_norm(jcfg, jp, jnp.asarray(x), "ln")
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    fn = {"rmsnorm": (L.rmsnorm, JL.rmsnorm, (w,)),
          "layernorm": (L.layernorm, JL.layernorm, (w, b)),
          "layernorm_np": (L.layernorm_np, JL.layernorm_np, ())}[norm]
    got = fn[0](torch.from_numpy(x), *map(torch.from_numpy, fn[2]))
    want = fn[1](jnp.asarray(x), *map(jnp.asarray, fn[2]))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = _x(rng, 2, 6, 3, 32)
    positions = np.stack([np.arange(6), np.arange(4090, 4096)]).astype(np.int32)
    np.testing.assert_allclose(
        L.rope_frequencies(32, theta).numpy(),
        _np(JL.rope_frequencies(32, theta)), **TOL)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(positions), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# --- attention ----------------------------------------------------------------

# (causal, window, q_offset, hq, hkv, sq, skv)
NAIVE = {
    "causal": (True, 0, 0, 4, 4, 12, 12),
    "noncausal": (False, 0, 0, 4, 4, 7, 12),
    "windowed": (True, 5, 0, 4, 4, 12, 12),
    "q_offset": (True, 0, 9, 4, 4, 3, 12),
    "gqa": (True, 0, 0, 4, 2, 12, 12),
    "mqa_windowed_offset": (True, 4, 7, 4, 1, 5, 12),
}


@pytest.mark.parametrize("case", sorted(NAIVE))
def test_naive_attention_matches_jax(case):
    causal, window, q_offset, hq, hkv, sq, skv = NAIVE[case]
    rng = np.random.default_rng(2)
    q, k, v = _x(rng, 2, sq, hq, 32), _x(rng, 2, skv, hkv, 32), \
        _x(rng, 2, skv, hkv, 32)
    got = L.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal, window=window,
                            q_offset=q_offset)
    want = JL.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# (causal, window, hq, hkv, s): s above the smoke threshold of 64; 80 is no
# multiple of the 32-row block, so the last block is padded and masked
BLOCKWISE = {
    "causal": (True, 0, 4, 4, 96),
    "noncausal_ragged": (False, 0, 4, 2, 80),
    "windowed_gqa": (True, 40, 4, 1, 96),
}


@pytest.mark.parametrize("case", sorted(BLOCKWISE))
def test_blockwise_attention_matches_jax(case):
    causal, window, hq, hkv, s = BLOCKWISE[case]
    cfg = smoke_config("llama3_405b")
    assert s > cfg.blockwise_attn_threshold
    rng = np.random.default_rng(3)
    q, k, v = _x(rng, 2, s, hq, 32), _x(rng, 2, s, hkv, 32), \
        _x(rng, 2, s, hkv, 32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = L.blockwise_attention(tq, tk, tv, causal=causal,
                                block=cfg.attn_block_size, window=window)
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block=cfg.attn_block_size, window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    naive = L.naive_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), **TOL)


# (s, cache_len, cache_index): no cache (naive, and blockwise above the
# threshold); a prefill into the cache; a decode step; a decode step past
# the end, whose insert XLA clamps to the last slot
ATTN = {"naive": (12, None, None), "blockwise": (80, None, None),
        "prefill": (12, 20, 0), "decode": (1, 20, 12),
        "decode_clamped": (1, 20, 23)}


@pytest.mark.parametrize("case", sorted(ATTN))
def test_attention_module_matches_jax(case):
    s, cache_len, index = ATTN[case]
    cfg, jcfg = smoke_config("internlm2_20b"), jax_smoke_config("internlm2_20b")
    jp = JL.attention_params(jcfg, jax.random.PRNGKey(5))
    attn = _load(L.Attention(cfg, _init()), jp)
    rng = np.random.default_rng(4)
    x = _x(rng, 2, s, cfg.d_model)
    base = 0 if index is None else index
    positions = np.broadcast_to(np.arange(s) + base, (2, s)).astype(np.int32)
    kw, jkw = {}, {}
    if cache_len:
        kv = _x(rng, 2, 2, cache_len, cfg.n_kv_heads, cfg.d_head)
        kw = dict(cache={"k": torch.from_numpy(kv[0].copy()),
                         "v": torch.from_numpy(kv[1].copy())},
                  cache_index=index)
        jkw = dict(cache={"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])},
                   cache_index=index)
    with torch.no_grad():
        out, cache = attn(torch.from_numpy(x),
                          positions=torch.from_numpy(positions), **kw)
    jout, jcache = JL.attention_forward(jcfg, jp, jnp.asarray(x),
                                        positions=jnp.asarray(positions), **jkw)
    np.testing.assert_allclose(out.numpy(), _np(jout), **TOL)
    if cache_len:
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       _np(jcache[name]), **TOL)


def test_overlong_insert_raises_like_jax():
    """An insert longer than the cache: XLA refuses it while tracing, the
    port raises a ValueError that names the shapes."""
    buf = np.zeros((2, 4, 1, 8), np.float32)
    new = np.ones((2, 6, 1, 8), np.float32)
    with pytest.raises(TypeError):
        jax.lax.dynamic_update_slice_in_dim(jnp.asarray(buf), jnp.asarray(new),
                                            0, axis=1)
    with pytest.raises(ValueError, match=r"update shape \(2, 6, 1, 8\)"):
        L.update_slice(torch.from_numpy(buf), torch.from_numpy(new), 0)


# --- MLP, MoE -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3_405b", "starcoder2_7b"])
def test_mlp_matches_jax(arch):
    """SwiGLU (llama) and tanh-GELU (starcoder2)."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    jp = JL.mlp_params(jcfg, jax.random.PRNGKey(6))
    mlp = _load(L.MLP(cfg, _init()), jp)
    # inputs wide enough that the GELU's two forms would differ
    x = _x(np.random.default_rng(5), 2, 7, cfg.d_model) * 20.0
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               _np(JL.mlp_forward(jcfg, jp, jnp.asarray(x))),
                               **TOL)


# capacity factors: the smoke config's drop-free 8.0, and 1.0, which drops
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "moonshot_v1_16b_a3b"])
@pytest.mark.parametrize("capacity_factor", [None, 1.0])
def test_moe_matches_jax(arch, capacity_factor):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    jp = JL.moe_params(jcfg, jax.random.PRNGKey(7))
    moe = _load(L.MoE(cfg, _init()), jp)
    x = _x(np.random.default_rng(6), 2, 9, cfg.d_model)
    with torch.no_grad():
        out, aux = moe(torch.from_numpy(x), capacity_factor=capacity_factor)
    jout, jaux = JL.moe_forward(jcfg, jp, jnp.asarray(x),
                                capacity_factor=capacity_factor)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _np(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_top_k_breaks_ties_to_the_lower_index_like_lax():
    logits = np.array([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 1.0]],
                      np.float32)
    vals, idx = L._top_k(torch.from_numpy(logits), 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(logits), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_bf16_products_accumulate_in_float32():
    """The scores of bf16 operands are not rounded to bf16 (JAX's
    ``preferred_element_type=float32``): the port's bf16 attention equals
    JAX's within half a bf16 step of its output, where scores rounded to
    bf16 (a plain bf16 einsum) miss it by several steps."""
    rng = np.random.default_rng(8)
    q, k, v = (_x(rng, 1, 8, 2, 32) * s for s in (4.0, 4.0, 1.0))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    jbf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = _np(JL.naive_attention(*jbf, causal=True))
    got = L.naive_attention(*bf, causal=True).float().numpy()
    half_step = 2.0 ** -8 * np.abs(want).max()
    assert np.abs(got - want).max() <= half_step
    scores = torch.einsum("bqhd,bkhd->bhqk", bf[0], bf[1]) * 32 ** -0.5
    causal = torch.tril(torch.ones(8, 8, dtype=torch.bool))
    probs = torch.softmax(torch.where(causal, scores.float(), L.NEG_INF), -1)
    rounded = torch.einsum("bhqk,bkhd->bqhd", probs.to(torch.bfloat16).float(),
                           bf[2].float()).to(torch.bfloat16).float().numpy()
    assert np.abs(rounded - want).max() > 2 * half_step

"""The port's AdamW (``repro_torch.optim``) against the JAX package's on the
CPU: the same random tree of bf16 and float32 leaves, the same gradients,
several steps from a given step count — through the warmup, the cosine and
its floor, with the global-norm clip active and inactive — at rtol = 1e-6,
atol = 1e-6 × the leaf's largest magnitude (the global norm sums in another
order, so an active clip scales by a factor an ulp away, and ``b1·m +
(1 − b1)·g`` cancels to values far below the leaf's scale).  Then ``schedule`` and
``global_norm`` alone, the state's layout, and the bf16 behaviour of an
early-warmup step."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro_torch.optim import adamw as A

RTOL = 1e-6
SHAPES = {"a_embed": ((16, 8), "bfloat16"), "b_norm": ((8,), "float32"),
          "c_wq": ((8, 12), "bfloat16"), "d_router": ((8, 4), "float32")}
# (start step, warmup, total, clip_norm): each case runs STEPS steps
CASES = {
    "warmup": (0, 10, 100, 1e3),
    "cosine": (40, 10, 100, 1e3),
    "floor": (120, 10, 100, 1e3),
    "clip_active": (5, 10, 100, 0.05),
    "clip_inactive": (5, 10, 100, 1e6),
}
STEPS = 4


def _tree(rng):
    """{name: (numpy float32 values, dtype)} — bf16 leaves hold values that
    bf16 represents exactly, so both packages start from the same bits."""
    out = {}
    for name, (shape, dt) in SHAPES.items():
        x = rng.normal(0, 0.5, shape).astype(np.float32)
        if dt == "bfloat16":
            x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        out[name] = (x, dt)
    return out


def _jax(tree):
    return {n: jnp.asarray(x, jnp.bfloat16 if dt == "bfloat16" else
                           jnp.float32) for n, (x, dt) in tree.items()}


def _torch(tree):
    return {n: torch.from_numpy(x).to(torch.bfloat16 if dt == "bfloat16"
                                      else torch.float32)
            for n, (x, dt) in tree.items()}


def _close(got, want, what):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_update_matches_jax(case):
    start, warmup, total, clip = CASES[case]
    cfg = dict(lr=3e-3, warmup_steps=warmup, total_steps=total,
               clip_norm=clip)
    jcfg, tcfg = JA.AdamWConfig(**cfg), A.AdamWConfig(**cfg)
    rng = np.random.default_rng(7)
    tree = _tree(rng)
    jp, tp = _jax(tree), _torch(tree)
    jopt, topt = JA.init_opt_state(jp), A.init_opt_state(tp)
    jopt["step"] = jnp.int32(start)
    topt["step"] = torch.tensor(start, dtype=torch.int32)
    for _ in range(STEPS):
        grads = _tree(rng)
        jp, jopt, jstats = JA.adamw_update(jcfg, jp, _jax(grads), jopt)
        tp, topt, tstats = A.adamw_update(tcfg, tp, _torch(grads), topt)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[key]), float(jstats[key]),
                                       rtol=RTOL, err_msg=key)
        for name in SHAPES:
            assert tp[name].dtype == (torch.bfloat16 if SHAPES[name][1]
                                      == "bfloat16" else torch.float32)
            _close(tp[name], jp[name], name)
            for mv in ("m", "v"):
                assert topt[mv][name].dtype == torch.float32
                _close(topt[mv][name], jopt[mv][name], f"{mv} {name}")
        assert int(topt["step"]) == int(jopt["step"])
        assert topt["step"].dtype == torch.int32
    scale = min(1.0, clip / float(jstats["grad_norm"]))
    assert (scale < 1.0) == (case == "clip_active")


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 2), (0, 0),
                                          (100, 1000)])
def test_schedule_matches_jax(warmup, total):
    steps = np.array([0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 999, 1000, 5000],
                     np.int32)
    jcfg = JA.AdamWConfig(warmup_steps=warmup, total_steps=total)
    tcfg = A.AdamWConfig(warmup_steps=warmup, total_steps=total)
    want = np.asarray(JA.schedule(jcfg, jnp.asarray(steps)))
    got = A.schedule(tcfg, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(3))
    want = float(JA.global_norm(_jax(tree)))
    got = A.global_norm(_torch(tree).values())
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


def test_opt_state_layout():
    """JAX's layout: float32 zeros per parameter name, a 0-d int32 step, on
    the parameters' device; a module's named parameters give the names."""
    model = torch.nn.Linear(3, 2).to(torch.bfloat16)
    opt = A.init_opt_state(model)
    assert sorted(opt) == ["m", "step", "v"]
    for key in ("m", "v"):
        assert sorted(opt[key]) == ["bias", "weight"]
        assert all(t.dtype == torch.float32 and not t.any()
                   for t in opt[key].values())
        assert opt[key]["weight"].shape == (2, 3)
    assert opt["step"].dtype == torch.int32 and opt["step"].dim() == 0
    assert opt["m"]["weight"] is not opt["v"]["weight"]


def test_early_warmup_bf16_update_below_half_an_ulp_leaves_weights():
    """lr·warm at the first step is 6e-6 here: below half a bf16 ulp of a
    weight of 0.02, so the bf16 parameter does not move — in both packages
    (``p_new.astype(p.dtype)``)."""
    cfg = dict(lr=3e-4, warmup_steps=100, weight_decay=0.0)
    x = np.full((4, 4), 0.02, np.float32)
    tree = {"w": (x, "bfloat16")}
    g = {"w": (np.ones((4, 4), np.float32), "float32")}
    jp, _, _ = JA.adamw_update(JA.AdamWConfig(**cfg), _jax(tree), _jax(g),
                               JA.init_opt_state(_jax(tree)))
    tp = _torch(tree)
    before = tp["w"].clone()
    A.adamw_update(A.AdamWConfig(**cfg), tp, _torch(g), A.init_opt_state(tp))
    assert torch.equal(tp["w"], before)
    np.testing.assert_array_equal(_np(tp["w"]), _np(jp["w"]))
    # the float32 copy of the same weights does move
    tp32 = {"w": torch.from_numpy(x.copy())}
    A.adamw_update(A.AdamWConfig(**cfg), tp32, _torch(g),
                   A.init_opt_state(tp32))
    assert not torch.equal(tp32["w"], torch.from_numpy(x))


def test_config_equals_jax():
    assert (dataclasses.asdict(A.AdamWConfig())
            == dataclasses.asdict(JA.AdamWConfig()))

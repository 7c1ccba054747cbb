"""Remat and gradient accumulation of the port's train path on the CPU.

Remat (``cfg.remat``, ``cfg.remat_policy``) only decides what the backward
pass recomputes: the gradients with "dots", "nothing" and remat off agree
within 1e-6, the forward without grad is the same bits with or without it,
and "dots" recomputes no GEMM.  ``grad_accum = 4`` matches ``grad_accum =
1`` within the JAX test's 2e-3 (``tests/test_training_substrate.py:149``)
and the JAX package's own ``grad_accum = 4`` step within 1e-4 (the moments
leaf by leaf at that leaf's scale, as in ``test_torch_train_step_a.py``),
adding the microbatches' gradients in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import smoke_config as jax_smoke_config
from repro.models import steps as JST
from repro_torch.configs import smoke_config
from repro_torch.data import batch_to_device
from repro_torch.models import convert as C
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models import steps as ST
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.optim import AdamWConfig
from test_torch_train_step_a import (OPT, carry_state, leaves_close,
                                     port_arrays, steps_close, stream_batch)

# one arch per layer kind: dense, MoE, hybrid (attention + SSD, sliding
# window), SSM only, encoder-decoder (encoder remat), VLM prefix
REMAT_ARCHS = ("olmo_1b", "granite_moe_3b_a800m", "hymba_1_5b", "mamba2_370m",
               "whisper_large_v3", "internvl2_1b")
POLICIES = [(False, "dots"), (True, "dots"), (True, "nothing")]


def _grads(cfg, batch):
    model = M.LMModel(cfg, device="cpu", seed=0)
    params = dict(model.named_parameters())
    loss, _ = ST.loss_fn(cfg, model, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_give_the_same_gradients(arch):
    base = smoke_config(arch)
    # 64 positions: the smoke configs' blockwise attention threshold
    batch = batch_to_device(stream_batch(base, seq_len=64), "cpu")
    runs = [_grads(dataclasses.replace(base, remat=r, remat_policy=p), batch)
            for r, p in POLICIES]
    loss0, want = runs[0]
    for (remat, policy), (loss, got) in zip(POLICIES[1:], runs[1:]):
        assert loss == loss0, (remat, policy)
        for name, g in want.items():
            assert torch.isfinite(got[name]).all(), name
            np.testing.assert_allclose(got[name].numpy(), g.numpy(),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{policy} {name}")


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _backward_mm(cfg, batch) -> int:
    model = M.LMModel(cfg, device="cpu", seed=0)
    loss, _ = ST.loss_fn(cfg, model, batch)
    with _CountMM() as count:
        loss.backward()
    return count.mm


def test_dots_policy_saves_the_gemm_outputs():
    """Backward GEMMs: off and "dots" run the same number (nothing
    recomputed that is a GEMM); "nothing" runs the forward's again."""
    base = smoke_config("olmo_1b")
    batch = batch_to_device(stream_batch(base), "cpu")
    off, dots, nothing = (
        _backward_mm(dataclasses.replace(base, remat=r, remat_policy=p),
                     batch) for r, p in POLICIES)
    assert off == dots
    assert nothing > dots
    with pytest.raises(ValueError, match="remat_policy"):
        _backward_mm(dataclasses.replace(base, remat_policy="everything"),
                     batch)


def test_remat_only_wraps_the_train_branch_with_grad(monkeypatch):
    """Without grad (serving, evaluation) nothing is checkpointed, and the
    train-mode logits are the same bits with remat on and off."""
    cfg = smoke_config("whisper_large_v3")
    batch = batch_to_device(stream_batch(cfg), "cpu")
    model = M.LMModel(cfg, device="cpu", seed=0)
    with torch.no_grad():
        want, _, _ = model(batch, mode="train")

    def refuse(*a, **k):
        raise AssertionError("checkpoint called without grad")

    monkeypatch.setattr(M, "checkpoint", refuse)
    with torch.no_grad():
        got, _, _ = model(batch, mode="train")
    model.cfg = dataclasses.replace(cfg, remat=False)
    with torch.no_grad():
        off, _, _ = model(batch, mode="train")
    assert torch.equal(got, want) and torch.equal(off, want)
    # with grad, both the encoder and the decoder layers are wrapped
    model.cfg = cfg
    with pytest.raises(AssertionError, match="checkpoint called"):
        model(batch, mode="train")


def test_ssd_chunk_mask_has_finite_gradients():
    """A fast decay overflows exp of the chunk mask's upper triangle: the
    port masks the exponent, so the output is unchanged and the gradients
    stay finite (``where(mask, exp(li), 0)`` gives 0·inf = NaN)."""
    cfg = smoke_config("mamba2_370m")
    model = M.LMModel(cfg, device="cpu", seed=0)
    ssd = model.layers[0].ssm
    with torch.no_grad():
        ssd.a_log.fill_(4.0)            # A = -exp(4) ≈ -55
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0), requires_grad=True)
    with torch.no_grad():
        log_a = S._project(cfg, ssd, x)[-1].reshape(2, 2, 16, -1)
        cum = torch.cumsum(log_a, dim=2)
        # this case does overflow: exp(cum_t - cum_u) for u > t
        assert torch.isinf(torch.exp(cum[:, :, None] - cum[:, :, :, None])).any()
    y, _ = S.ssd_forward(cfg, ssd, x)
    ref, _ = S.ssd_reference(cfg, ssd, x)
    np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    y.square().sum().backward()
    assert torch.isfinite(x.grad).all()
    assert all(torch.isfinite(p.grad).all() for p in ssd.parameters())


def test_grad_accum_matches_full_batch():
    """Microbatched accumulation == full-batch gradients (same update), the
    counterpart of ``test_grad_accum_matches_full_batch``: the loss and the
    new parameters within its 2e-3, and ``m`` and ``v`` (the step's clipped
    gradient and its square) leaf by leaf at rtol 2e-3 and an atol of 2e-3 ×
    the leaf's largest magnitude."""
    cfg = smoke_config("olmo_1b")
    batch = batch_to_device(stream_batch(cfg, seq_len=16, global_batch=8),
                            "cpu")
    out = []
    for accum in (1, 4):
        c = dataclasses.replace(cfg, grad_accum=accum)
        model, opt = ST.init_train_state(c, seed=0, device="cpu")
        model, opt, metrics = ST.make_train_step(c)(model, opt, batch)
        out.append((model, opt, metrics))
    (m1, o1, r1), (m4, o4, r4) = out
    assert abs(float(r1["loss"]) - float(r4["loss"])) < 2e-3
    want = m1.state_dict()
    for name, p in m4.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-3,
                                   err_msg=name)
    for key in ("m", "v"):
        leaves_close(port_arrays(o4[key]), port_arrays(o1[key]), key,
                     rtol=2e-3)


def test_grad_accum_matches_jax():
    jcfg = dataclasses.replace(jax_smoke_config("olmo_1b"), grad_accum=4)
    cfg = dataclasses.replace(smoke_config("olmo_1b"), grad_accum=4)
    params, opt = JST.init_train_state(jcfg, jax.random.PRNGKey(0))
    model, topt = carry_state(cfg, params, opt)
    batch = stream_batch(cfg, seq_len=16, global_batch=8)
    jp, jopt, jm = jax.jit(JST.make_train_step(jcfg, JAdamWConfig(**OPT)))(
        params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    model, topt, tm = ST.make_train_step(cfg, AdamWConfig(**OPT))(
        model, topt, batch_to_device(batch, "cpu"))
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    steps_close((model, topt), (jp, jopt))


def test_grad_accum_sums_in_float32(monkeypatch):
    """A bf16 model's microbatch gradients reach AdamW as float32 sums."""
    cfg = dataclasses.replace(smoke_config("olmo_1b"), grad_accum=4,
                              dtype="bfloat16")
    seen = {}
    adamw = ST.adamw_update

    def spy(opt_cfg, params, grads, opt_state):
        seen.update({n: g.dtype for n, g in grads.items()})
        return adamw(opt_cfg, params, grads, opt_state)

    monkeypatch.setattr(ST, "adamw_update", spy)
    model, opt = ST.init_train_state(cfg, seed=0, device="cpu")
    batch = batch_to_device(stream_batch(cfg, seq_len=16, global_batch=8),
                            "cpu")
    _, _, metrics = ST.make_train_step(cfg)(model, opt, batch)
    assert seen and set(seen.values()) == {torch.float32}
    assert model.embed.dtype == torch.bfloat16
    assert np.isfinite(float(metrics["loss"]))

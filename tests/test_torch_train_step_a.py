"""The port's train step (``repro_torch.models.steps.make_train_step``)
against the JAX package's, one step, for the first five of the ten archs at
``smoke_config`` in float32 (``test_torch_train_step_b.py`` holds the other
five, so that ``--dist loadfile`` spreads them).

JAX's ``init_train_state`` draws the weights and the AdamW state;
``params_from_jax`` and ``opt_state_from_jax`` carry them into the port.
The same stream batch then takes one step on both sides (remat "dots", the
configs' default) under ``OPT``.  The loss, ``ce``, ``aux``, ``grad_norm``,
``lr`` and the new parameters agree at rtol = atol = 1e-4.  The moments agree
leaf by leaf, one layer's slice at a time, at rtol 1e-4 and an atol of 1e-4 ×
the leaf's largest magnitude: after one step ``m = (1 − b1)·g`` and ``v =
(1 − b2)·g²`` of the clipped gradient ``g``, so each leaf's gradient is held
to its own scale, however small the leaf.  ``OPT`` starts the learning rate
at 1e-3 (the default schedule's 6e-6 at step 1 moves no parameter by as much
as the 1e-4 bound, so a skipped or sign-flipped update would pass).  The
update itself is not compared at a tolerance scaled to it: the first AdamW
step is ``g / (|g| + eps)``, and for the few elements whose ``|g|`` is near
``eps`` = 1e-8 float32 rounding of ``g`` moves it by up to a few hundredths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.data import DataConfig, SyntheticLMStream
from repro.models import steps as JST
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.data import batch_to_device
from repro_torch.models import convert as C
from repro_torch.models import steps as ST
from repro_torch.optim import AdamWConfig

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS_A = sorted(ARCHS)[:5]
# the learning rate is 1e-3 from step 1 on (no warmup, cosine at its top)
OPT = dict(lr=1e-3, warmup_steps=1)


def _np(x):
    return np.asarray(x, np.float32)


def leaves(tree, prefix=""):
    """{path: float32 array} of a nested dict of arrays."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(leaves(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = _np(value)
    return out


def trees_close(got: dict, want: dict, what: str):
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want), what
    for path in want:
        np.testing.assert_allclose(got[path], want[path], **TOL,
                                   err_msg=f"{what} {path}")


def leaves_close(got: dict, want: dict, what: str, rtol: float = 1e-4):
    """Each parameter's tensor (the port's names, a layer at a time) at
    ``rtol`` and an atol of ``rtol`` × that leaf's largest ``|want|``."""
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        g = np.asarray(got[name], np.float32)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()),
                                   err_msg=f"{what} {name}")


def port_arrays(state: dict) -> dict:
    """{name: float32 numpy} of a dict of tensors (a state dict, m or v)."""
    return {n: t.detach().float().cpu().numpy() for n, t in state.items()}


def steps_close(after, jafter, rtol: float = 1e-4):
    """One step's results, the port's ``(model, opt_state)`` against JAX's
    ``(params, opt_state)``: the new parameters at rtol = atol = ``rtol``,
    ``m`` and ``v`` leaf by leaf at :func:`leaves_close`'s scaled
    tolerance."""
    (model, opt), (jp, jopt) = after, jafter
    got, want = port_arrays(model.state_dict()), C.state_from_jax(jp)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=rtol, err_msg=f"params {name}")
    for key in ("m", "v"):
        leaves_close(port_arrays(opt[key]), C.state_from_jax(jopt[key]), key,
                     rtol)


def stream_batch(cfg, *, seq_len=32, global_batch=4, step=0):
    data = DataConfig(seq_len=seq_len, global_batch=global_batch,
                      vocab_size=cfg.vocab_size, seed=1,
                      frontend_len=cfg.frontend_len if cfg.frontend else 0,
                      d_model=cfg.d_model)
    return SyntheticLMStream(data).batch_at(step)


def carry_state(cfg, params, opt):
    """The JAX state as the port's (model, opt_state) on the CPU."""
    model = C.params_from_jax(cfg, jax.tree.map(_np, params), device="cpu")
    return model, C.opt_state_from_jax(cfg, opt, device="cpu")


def check_train_step(arch: str):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    params, opt = JST.init_train_state(jcfg, jax.random.PRNGKey(0))
    model, topt = carry_state(cfg, params, opt)
    batch = stream_batch(cfg)
    jp, jopt, jm = jax.jit(JST.make_train_step(jcfg, JAdamWConfig(**OPT)))(
        params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    model, topt, tm = ST.make_train_step(cfg, AdamWConfig(**OPT))(
        model, topt, batch_to_device(batch, "cpu"))
    assert sorted(tm) == sorted(jm)
    for key in jm:
        assert tm[key].dim() == 0
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    assert float(tm["lr"]) == pytest.approx(OPT["lr"])
    steps_close((model, topt), (jp, jopt))
    # the tree layout ``state_to_jax`` gives back is JAX's own
    trees_close(C.state_to_jax(model), jax.tree.map(_np, jp), "params")
    assert int(topt["step"]) == int(jopt["step"]) == 1


@pytest.mark.parametrize("arch", ARCHS_A)
def test_train_step_matches_jax(arch):
    check_train_step(arch)

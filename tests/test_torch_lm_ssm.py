"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) on the CPU: the chunked dual form (several
chunks, a ragged single chunk, with and without a carried state), the
``s == 1`` decode step and the sequential oracle, on the same numpy inputs
and the JAX package's initial weights; float32 at rtol = atol = 1e-5.  Then
the port's own counterpart of ``test_ssd_chunked_matches_reference``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import ssm as JS
from repro_torch.configs import smoke_config
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.convert import state_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
# mamba2 (expand 2) and hymba (expand 1, as its hybrid layers run it)
ARCHS = ["mamba2_370m", "hymba_1_5b"]


def _np(x):
    return np.asarray(x, np.float32)


def _block(arch, key=3):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    jp = JS.ssm_params(jcfg, jax.random.PRNGKey(key))
    # a_log 0 and d_skip 1 at init: move them so that A and D are exercised
    jp = dict(jp, a_log=jnp.linspace(-1.0, 1.0, cfg.ssm_heads),
              d_skip=jnp.linspace(0.5, 1.5, cfg.ssm_heads))
    ssd = S.SSD(cfg, L.ParamInit(torch.device("cpu"), 0))
    ssd.load_state_dict({k: torch.from_numpy(v) for k, v in state_from_jax(
        jax.tree.map(_np, jp)).items()}, strict=True)
    return cfg, jcfg, jp, ssd


def _inputs(cfg, s, seed, with_state):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    if not with_state:
        return x, None
    p = cfg.ssm_expand * cfg.d_model // cfg.ssm_heads
    return x, rng.normal(size=(2, cfg.ssm_heads, p, cfg.ssm_state)).astype(
        np.float32)


def _both(fn, jfn, cfg, jcfg, jp, ssd, x, state):
    with torch.no_grad():
        y, st = fn(cfg, ssd, torch.from_numpy(x),
                   state=None if state is None else torch.from_numpy(state))
    jy, jst = jfn(jcfg, jp, jnp.asarray(x),
                  state=None if state is None else jnp.asarray(state))
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), _np(jst), **TOL)
    return y, st


# s: 64 is four chunks of 16; 20 is ragged, so one chunk of 20
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [64, 20])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_forward_chunked_matches_jax(arch, s, with_state):
    cfg, jcfg, jp, ssd = _block(arch)
    x, state = _inputs(cfg, s, 0, with_state)
    _both(S.ssd_forward, JS.ssd_forward, cfg, jcfg, jp, ssd, x, state)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_forward_step_matches_jax(arch):
    """The s == 1 decode branch, from a carried state."""
    cfg, jcfg, jp, ssd = _block(arch)
    x, state = _inputs(cfg, 1, 1, True)
    _both(S.ssd_forward, JS.ssd_forward, cfg, jcfg, jp, ssd, x, state)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_reference_matches_jax(arch):
    cfg, jcfg, jp, ssd = _block(arch)
    x, state = _inputs(cfg, 24, 2, True)
    _both(S.ssd_reference, JS.ssd_reference, cfg, jcfg, jp, ssd, x, state)


def test_init_ssm_state_matches_jax():
    cfg, jcfg = smoke_config("mamba2_370m"), jax_smoke_config("mamba2_370m")
    st = S.init_ssm_state(cfg, 3, device="cpu")
    jst = JS.init_ssm_state(jcfg, 3)
    assert st.dtype == torch.float32 and tuple(st.shape) == jst.shape
    assert not st.any()


def test_ssd_chunked_matches_reference():
    """The port's own counterpart of the JAX package's test: the chunked
    dual form equals the sequential recurrence, output and final state."""
    cfg = smoke_config("mamba2_370m")
    ssd = S.SSD(cfg, L.ParamInit(torch.device("cpu"), 3))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y_chunk, st_chunk = S.ssd_forward(cfg, ssd, x)
        y_ref, st_ref = S.ssd_reference(cfg, ssd, x)
        y_mod, _ = ssd(x)
    np.testing.assert_allclose(y_chunk.numpy(), y_ref.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st_chunk.numpy(), st_ref.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(y_mod.numpy(), y_chunk.numpy())


def test_ssd_steps_chain_to_the_chunked_state():
    """Decoding a sequence token by token (the s == 1 branch) ends in the
    chunked form's state: the step a served SSM layer takes."""
    cfg = smoke_config("mamba2_370m")
    ssd = S.SSD(cfg, L.ParamInit(torch.device("cpu"), 4))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y_all, st_all = ssd(x)
        st, ys = None, []
        for i in range(x.shape[1]):
            y, st = ssd(x[:, i:i + 1], state=st)
            ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_all.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), st_all.numpy(),
                               rtol=1e-4, atol=1e-4)

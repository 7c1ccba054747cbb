"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the
counterparts of ``tests/test_training_substrate.py``'s roundtrip, rotation
and integrity tests, async save from a host copy, and interop with the JAX
package's on-disk layout both ways — a JAX training checkpoint restores
into the port, whose next step equals JAX's within 1e-4."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import smoke_config as jax_smoke_config
from repro.models import steps as JST
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import smoke_config
from repro_torch.data import batch_to_device
from repro_torch.models import convert as C
from repro_torch.models import steps as ST
from repro_torch.optim import AdamWConfig
from test_torch_train_step_a import OPT, steps_close, stream_batch


def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = {"a": torch.ones((3, 4), dtype=torch.bfloat16) * 1.5,
            "b": {"c": torch.arange(5, dtype=torch.int32)},
            "d": [torch.zeros((2,), dtype=torch.float32)],
            "e": np.arange(3, dtype=np.int64)}
    save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    got, extra = restore_checkpoint(str(tmp_path), tree)
    assert extra["note"] == "x"
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.int32
    np.testing.assert_array_equal(got["b"]["c"].numpy(), np.arange(5))
    assert isinstance(got["d"], list) and torch.equal(got["d"][0], tree["d"][0])
    np.testing.assert_array_equal(got["e"], tree["e"])
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 7
    assert manifest["leaves"]["a@bf16"] == {"shape": [3, 4], "dtype": "float32"}
    assert sorted(manifest["leaves"]) == ["a@bf16", "b/c", "d/0", "e"]


def test_checkpoint_rotation_and_integrity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = {"w": torch.ones((4,))}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert mgr.latest_step() == latest_step(str(tmp_path)) == 4
    # corrupt latest payload -> integrity failure
    npz = os.path.join(tmp_path, "step_00000004", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(0)
        f.write(b"XX")
    with pytest.raises(IOError, match="integrity"):
        restore_checkpoint(str(tmp_path), tree, step=4)
    got, _ = restore_checkpoint(str(tmp_path), tree, step=3)
    assert torch.equal(got["w"], tree["w"])
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tree)
    assert latest_step(str(tmp_path / "none")) is None


def test_async_save_writes_the_host_copy(tmp_path):
    """The writer thread sees the host copy taken in ``save``: a tensor
    updated in place right after it changes nothing written."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    w = torch.arange(6, dtype=torch.float32)
    state = {"params": {"w": w}, "opt": {"step": torch.tensor(1)}}
    mgr.save(1, state, extra={"data": {"step": 1}})
    w.add_(100.0)
    mgr.save(2, state)
    got, extra = mgr.restore_latest(state)
    assert torch.equal(got["params"]["w"], w)
    got1, extra1 = restore_checkpoint(str(tmp_path), state, step=1)
    assert torch.equal(got1["params"]["w"], torch.arange(6.0))
    assert extra1 == {"data": {"step": 1}} and extra == {}
    mgr.close()
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000002"]


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port writes JAX's layout: the JAX package restores it into a
    JAX tree of the same paths (bf16 leaves included)."""
    tree = {"params": {"layers.0.attn.wq": torch.full((2, 3), 0.5,
                                                     dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 5, tree, extra={"step": 5})
    like = {"params": {"layers.0.attn.wq": jnp.zeros((2, 3), jnp.bfloat16)},
            "opt": {"step": jnp.zeros((), jnp.int32)}}
    got, extra = jax_restore(str(tmp_path), like)
    assert extra == {"step": 5}
    assert got["params"]["layers.0.attn.wq"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["params"]["layers.0.attn.wq"], np.float32), 0.5)
    assert int(got["opt"]["step"]) == 3


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """JAX trains olmo_1b (smoke) two steps and saves with its own
    ``save_checkpoint``; the port restores that checkpoint into a like tree
    of numpy arrays, converts it and takes step three, equal to JAX's step
    three."""
    jcfg, cfg = jax_smoke_config("olmo_1b"), smoke_config("olmo_1b")
    params, opt = JST.init_train_state(jcfg, jax.random.PRNGKey(0))
    step = jax.jit(JST.make_train_step(jcfg, JAdamWConfig(**OPT)))
    batches = [stream_batch(cfg, step=i) for i in range(3)]
    for batch in batches[:2]:
        params, opt, _ = step(params, opt,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    jax_save(str(tmp_path), 2, {"params": params, "opt": opt},
             extra={"data": {"step": 2}})

    like = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype),
                        {"params": params, "opt": opt})
    tree, extra = restore_checkpoint(str(tmp_path), like)
    assert extra == {"data": {"step": 2}}
    model = C.params_from_jax(cfg, tree["params"], device="cpu")
    topt = C.opt_state_from_jax(cfg, tree["opt"], device="cpu")
    assert int(topt["step"]) == 2

    jp, jopt, jm = step(params, opt,
                        {k: jnp.asarray(v) for k, v in batches[2].items()})
    model, topt, tm = ST.make_train_step(cfg, AdamWConfig(**OPT))(
        model, topt, batch_to_device(batches[2], "cpu"))
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    steps_close((model, topt), (jp, jopt))
    assert int(topt["step"]) == int(jopt["step"]) == 3

"""The port's single-controller runtime (``repro_torch.runtime.compression``
and ``.pipeline``) against the JAX package's ``shard_map`` forms on the CPU.

One JAX subprocess with 8 forced host devices (as
``tests/test_training_substrate.py`` and ``tests/test_pipeline_pp.py`` run
theirs) writes its results for the same numpy inputs: ``quantize_int8``,
``_ef_quantize`` and two steps of ``compressed_grad_sync`` over a
4-position ``"pod"`` mesh (a float32, a bf16 and an all-zero leaf; the
second step starts from the first's error state), which the port must equal
bit for bit on a 4-position mesh over the CPU; and ``pipeline_forward`` on
a (4, 2) ``("pod", "data")`` mesh, which the port must equal within 2e-5
(and its own serial loop exactly).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as MESH
from repro_torch.runtime import (compressed_grad_sync, dequantize_int8,
                                 init_error_state, quantize_int8)
from repro_torch.runtime.compression import _ef_quantize, wire_bytes
from repro_torch.runtime.pipeline import bubble_fraction, pipeline_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, MB, D = 4, 8, 2, 16

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.runtime import compressed_grad_sync, init_error_state, quantize_int8
from repro.runtime.compression import _ef_quantize
from repro.runtime.pipeline import pipeline_forward

inp = np.load(sys.argv[1])
out = {}
pod = Mesh(np.array(jax.devices()[:4]), ("pod",))
g = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"]).astype(jnp.bfloat16),
     "z": jnp.asarray(inp["z"])}
codes, scale = quantize_int8(g["w"])
out["q_codes"], out["q_scale"] = np.asarray(codes), np.asarray(scale)
c, s, r = _ef_quantize(g["w"], jnp.asarray(inp["err"]))
out["ef_codes"], out["ef_scale"], out["ef_res"] = map(np.asarray, (c, s, r))
err = init_error_state(g)
for step in (1, 2):
    synced, err = compressed_grad_sync(g, err, mesh=pod, axis="pod")
    for k in g:
        out[f"s{step}_{k}"] = np.asarray(synced[k].astype(jnp.float32))
        out[f"e{step}_{k}"] = np.asarray(err[k])
    g = {k: v * 0.5 for k, v in g.items()}

mesh = jax.make_mesh((4, 2), ("pod", "data"))
w = jnp.asarray(inp["pw"])
x = jnp.asarray(inp["px"])
def stage(p, h):
    return jnp.tanh(h @ p)
w_sharded = jax.device_put(w, NamedSharding(mesh, P("pod")))
out["pipe"] = np.asarray(pipeline_forward(stage, w_sharded, x, mesh=mesh,
                                          axis="pod"))
np.savez(sys.argv[2], **out)
print("OK")
"""


def _inputs() -> dict:
    rng = np.random.default_rng(1)
    return {"w": rng.normal(size=(64, 32)).astype(np.float32),
            "b": (rng.normal(size=(33,)) * 1e-3).astype(np.float32),
            "z": np.zeros((5, 3), np.float32),
            "err": (rng.normal(size=(64, 32)) * 1e-3).astype(np.float32),
            "pw": (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32),
            "px": rng.normal(size=(M, MB, D)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_runtime")
    np.savez(tmp / "in.npz", **_inputs())
    res = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH="src"), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _grads(inp) -> dict:
    return {"w": torch.from_numpy(inp["w"]),
            "b": torch.from_numpy(inp["b"]).to(torch.bfloat16),
            "z": torch.from_numpy(inp["z"])}


def _eq(got, want):
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_quantize_and_ef_bit_for_bit(jax_out):
    inp = _inputs()
    codes, scale = quantize_int8(torch.from_numpy(inp["w"]))
    assert codes.dtype == torch.int8
    _eq(codes, jax_out["q_codes"])
    _eq(scale, jax_out["q_scale"])
    c, s, r = _ef_quantize(torch.from_numpy(inp["w"]),
                           torch.from_numpy(inp["err"]))
    for got, key in ((c, "ef_codes"), (s, "ef_scale"), (r, "ef_res")):
        _eq(got, jax_out[key])
    # the round trip is within half a step (tests/test_training_substrate.py)
    err = (dequantize_int8(codes, scale) - torch.from_numpy(inp["w"])).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_compressed_grad_sync_bit_for_bit(jax_out):
    mesh = MESH.make_mesh((4,), ("pod",), ["cpu"])
    g = _grads(_inputs())
    err = init_error_state(g)
    for step in (1, 2):
        synced, err = compressed_grad_sync(g, err, mesh=mesh, axis="pod")
        for k in g:
            assert synced[k].dtype == g[k].dtype
            assert err[k].dtype == torch.float32
            _eq(synced[k], jax_out[f"s{step}_{k}"])
            _eq(err[k], jax_out[f"e{step}_{k}"])
        g = {k: v * 0.5 for k, v in g.items()}


def test_compressed_grad_sync_over_a_wider_mesh():
    """The pod axis of a (2, 3) mesh: the sync runs the 2 positions along
    ``pod`` (the other axis at index 0), and the mean of identical replicas
    is the gradient within its quantisation step."""
    mesh = MESH.make_mesh((2, 3), ("pod", "data"), ["cpu"])
    g = {"w": torch.from_numpy(_inputs()["w"])}
    synced, err = compressed_grad_sync(g, init_error_state(g), mesh=mesh)
    scale = float(g["w"].abs().max()) / 127
    assert float((synced["w"] - g["w"]).abs().max()) <= scale * 0.5 + 1e-6
    assert float(err["w"].abs().max()) <= scale
    assert wire_bytes(g, 2) == {"int8": 2048, "int32_psum": 8192}


def test_pipeline_matches_jax_and_serial(jax_out):
    inp = _inputs()
    mesh = MESH.make_mesh((S, 2), ("pod", "data"), ["cpu"])
    w, x = torch.from_numpy(inp["pw"]), torch.from_numpy(inp["px"])

    def stage(p, h):
        return torch.tanh(h @ p)

    calls = []
    out = pipeline_forward(lambda p, h: calls.append(1) or stage(p, h), w, x,
                           mesh=mesh, axis="pod")
    assert len(calls) == S * (M + S - 1)      # bubble ticks compute too
    np.testing.assert_allclose(out.numpy(), jax_out["pipe"], rtol=2e-5,
                               atol=2e-5)
    ref = x
    for i in range(S):
        ref = stage(w[i], ref)
    assert torch.equal(out, ref)
    # the stages as a list give the same
    assert torch.equal(pipeline_forward(stage, list(w), x, mesh=mesh), out)


def test_bubble_fraction():
    assert bubble_fraction(4, 12) == 3 / 15
    assert bubble_fraction(1, 8) == 0.0

"""Training over a mesh (``repro_torch.launch.train.build(mesh=)``) is the
one-device port's training, on real DTensors.

Eight processes on the CPU (a ``gloo`` group, spawned, one spawn per mesh)
build olmo_1b's smoke config in float32 on a (2, 4) ``data`` × ``model``
mesh and on a (2, 2, 2) ``pod`` × ``data`` × ``model`` mesh: the model drawn
from the seed on every rank, each parameter and the AdamW moments at the
sharding rules' placements, each batch placed by the rules.  Three steps,
with ``grad_accum`` 1 and 2, are held against the one-device port's three
steps from the same seed at 1e-5: loss, ``grad_norm``, ``lr`` of each step,
then every parameter, ``m`` and ``v``.  Checkpoints reshard: one saved on
(2, 4) at step 2 is restored on (2, 2, 2) and on one device, and one saved
on one device is restored on (2, 4), each continuing to the same third
step.  A fault injected on every rank at step 2 of the fault-tolerant loop
is restored from the step-2 checkpoint and the run ends equal to the run
without it.  A mesh without a process group raises, and a DTensor that
reaches the checkpoint writer un-gathered raises.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.checkpoint import manager as CM
from repro_torch.configs import smoke_config
from repro_torch.data import batch_to_device
from repro_torch.launch import mesh as MESH
from repro_torch.launch import train as T
from repro_torch.runtime import FaultTolerantLoop

ARCH = "olmo_1b"
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
STEPS, AT = 3, 2              # steps of a run; the checkpoint resumed from
# lr 1e-3, as the one-device step tests take it: over the warmup a step
# moves a weight by 1e-4 to 3e-4, 10-30 times the bound
BUILD = dict(seq_len=16, global_batch=8, lr=1e-3, total_steps=20, seed=0)
TOL = 1e-5
WORKERS_TIMEOUT_S = 300


def _cfg(accum: int):
    return dataclasses.replace(smoke_config(ARCH), grad_accum=accum)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t.detach()


def _state(model, opt) -> dict:
    """Every parameter, ``m`` and ``v``, whole."""
    return {"params": {n: _full(p).clone()
                       for n, p in model.named_parameters()},
            "m": {n: _full(t).clone() for n, t in opt["m"].items()},
            "v": {n: _full(t).clone() for n, t in opt["v"].items()}}


def _steps(model, opt, step, stream, n: int) -> tuple:
    """(the (loss, grad_norm, lr) of ``n`` steps, the model, the state)."""
    metrics = []
    for _ in range(n):
        batch = batch_to_device(next(stream), model.device)
        model, opt, m = step(model, opt, batch)
        metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    return metrics, model, opt


def _tree(model, opt) -> dict:
    return {"params": model.state_dict(), "opt": opt}


def _resume(built, ckpt_dir: str, n: int = STEPS - AT):
    """Restore step AT of ``ckpt_dir`` into ``built`` and run ``n`` more
    steps; returns (their metrics, the final state)."""
    model, opt, step, stream = built
    tree, extra = CM.restore_checkpoint(ckpt_dir, _tree(model, opt), step=AT)
    model.load_state_dict(tree["params"])
    stream.restore(extra["data"])
    metrics, model, opt = _steps(model, tree["opt"], step, stream, n)
    return metrics, _state(model, opt)


def _one_device(accum: int, ckpt_dir=None) -> dict:
    """The one-device port's run (saving step AT to ``ckpt_dir``)."""
    model, opt, step, stream = T.build(_cfg(accum), device="cpu", **BUILD)
    metrics, model, opt = _steps(model, opt, step, stream, AT)
    if ckpt_dir is not None:
        CM.save_checkpoint(ckpt_dir, AT, _tree(model, opt),
                           extra={"data": stream.state(), "step": AT})
    more, model, opt = _steps(model, opt, step, stream, STEPS - AT)
    return {"metrics": metrics + more, "state": _state(model, opt)}


class _FaultOnce:
    """Raises at ``step`` the first time the loop reaches it."""

    def __init__(self, step: int):
        self.step, self.fired = step, False

    def __call__(self, step: int):
        if step == self.step and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected fault at step {step}")


def _worker(rank, world, mesh_name, init, out, tmp, one_device_ckpt):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch import shardings as SH
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = MESH.make_mesh(*MESHES[mesh_name], ["cpu"])
        results = {}
        for accum in (1, 2):
            model, opt, step, stream = T.build(_cfg(accum), mesh=mesh,
                                               device="cpu", **BUILD)
            metrics, model, opt = _steps(model, opt, step, stream, STEPS)
            results[f"accum{accum}"] = {"metrics": metrics,
                                        "state": _state(model, opt)}
        # the placements: moments by tree_opt_specs, step and norm replicated
        rules = SH.ShardingRules(mesh)
        specs = rules.tree_opt_specs(opt)
        dmesh = model.embed.device_mesh
        replicated = tuple([Replicate()] * dmesh.ndim)
        results["placements"] = all(
            tuple(opt[k][n].placements)
            == SH.placements(specs[k][n], dmesh)
            for k in ("m", "v") for n in opt[k]) and (
            tuple(opt["step"].placements) == replicated)
        try:
            CM._host(model.embed.detach())
            results["ungathered_refused"] = False
        except TypeError:
            results["ungathered_refused"] = True
        if mesh_name == "2x4":
            # the fault-tolerant loop, a fault on every rank at step AT
            built = T.build(_cfg(1), mesh=mesh, device="cpu", **BUILD)
            model, opt, step, stream = built
            loop = FaultTolerantLoop(step, stream, model, opt,
                                     ckpt_dir=str(tmp / "ckpt_2x4"),
                                     ckpt_every=AT,
                                     fault_hook=_FaultOnce(AT))
            model, opt = loop.run(STEPS)
            results["fault"] = {
                "restarts": loop.restarts,
                "metrics": [[m["loss"], m["grad_norm"]]
                            for m in loop.metrics_log],
                "state": _state(model, opt)}
            results["from_one_device"] = _resume(
                T.build(_cfg(1), mesh=mesh, device="cpu", **BUILD),
                one_device_ckpt)
        else:
            results["from_2x4"] = _resume(
                T.build(_cfg(1), mesh=mesh, device="cpu", **BUILD),
                str(tmp / "ckpt_2x4"))
        results["dtensor_params"] = all(isinstance(p, DTensor)
                                        for p in model.parameters())
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def _spawn(mesh_name, tmp, one_device_ckpt) -> dict:
    world = int(np.prod(MESHES[mesh_name][0]))
    out = tmp / f"out_{mesh_name}.pt"
    workers = mp.start_processes(
        _worker, args=(world, mesh_name, f"file://{tmp / f'store_{mesh_name}'}",
                       str(out), tmp, one_device_ckpt),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + WORKERS_TIMEOUT_S
    while not workers.join(timeout=1):      # raises if a worker failed
        if time.monotonic() > deadline:
            for p in workers.processes:
                p.kill()
            pytest.fail(f"the {world} gloo workers did not finish in "
                        f"{WORKERS_TIMEOUT_S} s")
    return torch.load(out)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("train_mesh")


@pytest.fixture(scope="module")
def one_device(tmp):
    """The one-device runs, accum 1 (its step-AT checkpoint saved) and 2."""
    return {1: _one_device(1, str(tmp / "ckpt_one")), 2: _one_device(2)}


@pytest.fixture(scope="module")
def on_2x4(tmp, one_device):
    return _spawn("2x4", tmp, str(tmp / "ckpt_one"))


@pytest.fixture(scope="module")
def on_2x2x2(tmp, on_2x4):
    return _spawn("2x2x2", tmp, None)


def _assert_state(got: dict, want: dict):
    for part in ("params", "m", "v"):
        assert set(got[part]) == set(want[part])
        for name, w in want[part].items():
            torch.testing.assert_close(got[part][name], w, rtol=TOL,
                                       atol=TOL,
                                       msg=lambda m: f"{part}/{name}: {m}")


def _assert_run(got: dict, want: dict):
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=TOL,
                               atol=TOL)
    _assert_state(got["state"], want["state"])


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_steps_equal_one_device(mesh_name, accum, one_device, on_2x4,
                                     on_2x2x2):
    got = {"2x4": on_2x4, "2x2x2": on_2x2x2}[mesh_name]
    assert got["dtensor_params"]
    _assert_run(got[f"accum{accum}"], one_device[accum])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_moments_keep_the_rules_placements(mesh_name, on_2x4, on_2x2x2):
    got = {"2x4": on_2x4, "2x2x2": on_2x2x2}[mesh_name]
    assert got["placements"]


def test_checkpoint_from_2x4_restores_on_2x2x2(one_device, on_2x2x2):
    metrics, state = on_2x2x2["from_2x4"]
    np.testing.assert_allclose(metrics, one_device[1]["metrics"][AT:],
                               rtol=TOL, atol=TOL)
    _assert_state(state, one_device[1]["state"])


def test_checkpoint_from_2x4_restores_on_one_device(tmp, one_device, on_2x4):
    metrics, state = _resume(T.build(_cfg(1), device="cpu", **BUILD),
                             str(tmp / "ckpt_2x4"))
    np.testing.assert_allclose(metrics, one_device[1]["metrics"][AT:],
                               rtol=TOL, atol=TOL)
    _assert_state(state, one_device[1]["state"])


def test_one_device_checkpoint_restores_on_2x4(one_device, on_2x4):
    metrics, state = on_2x4["from_one_device"]
    np.testing.assert_allclose(metrics, one_device[1]["metrics"][AT:],
                               rtol=TOL, atol=TOL)
    _assert_state(state, one_device[1]["state"])


def test_fault_on_every_rank_recovers(tmp, one_device, on_2x4):
    got = on_2x4["fault"]
    assert got["restarts"] == 1
    want = one_device[1]
    np.testing.assert_allclose(got["metrics"],
                               [m[:2] for m in want["metrics"]],
                               rtol=TOL, atol=TOL)
    _assert_state(got["state"], want["state"])
    # the mesh's checkpoints have the one-device layout and leaf names
    manifests = [json.loads((tmp / d / f"step_{AT:08d}" / "manifest.json")
                            .read_text()) for d in ("ckpt_2x4", "ckpt_one")]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    assert CM.latest_step(str(tmp / "ckpt_2x4")) == STEPS


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ungathered_dtensor_is_not_written(mesh_name, on_2x4, on_2x2x2):
    got = {"2x4": on_2x4, "2x2x2": on_2x2x2}[mesh_name]
    assert got["ungathered_refused"]


def test_mesh_without_process_group_raises():
    import torch.distributed as dist
    assert not dist.is_initialized()
    mesh = MESH.make_mesh(*MESHES["2x4"], ["cpu"])
    with pytest.raises(RuntimeError, match="process group"):
        T.build(_cfg(1), mesh=mesh, device="cpu", **BUILD)

"""The process-group forms of the port's runtime (``compressed_grad_sync``
and ``pipeline_forward`` given a ``torch.distributed`` ``DeviceMesh``) on
eight ``gloo`` processes on the CPU, one spawn, a (4, 2) ``("pod", "data")``
mesh.

Each rank runs its own position.  Held bit for bit: the sync over ``pod``
of identical replicas (a float32, a bf16 and an all-zero leaf, two steps,
the second from the first's error state) against the single-controller
form on a 4-position mesh and against JAX's ``shard_map`` form (the
fixture of ``tests/test_torch_runtime_dist.py``); the sync of replicas that
differ by rank against the same formula computed plainly over the replicas
in rank order; DTensor leaves (replicated over ``pod``, sharded over
``data``) coming back at their placements, each local shard the
single-controller sync of it; GPipe with 4 stages (a ``Shard(0)`` DTensor
over ``pod`` and a list) against the single-controller form and the serial
run, and JAX's within its 2e-5.  A ``DeviceMesh`` whose group is gone
raises.
"""
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.launch import mesh as MESH
from repro_torch.runtime import compressed_grad_sync, init_error_state
from repro_torch.runtime.compression import _ef_quantize, true_div
from repro_torch.runtime.pipeline import pipeline_forward
from test_torch_runtime_dist import M, S, _grads, _inputs, jax_out  # noqa: F401

SHAPE, AXES = (4, 2), ("pod", "data")
WORLD = 8
WORKERS_TIMEOUT_S = 300


def _stage(p, h):
    return torch.tanh(h @ p)


def _replica(inp: dict, pod: int, data: int) -> dict:
    """Rank (pod, data)'s gradients when the replicas differ: the shared
    ones scaled and shifted by its coordinates."""
    g = _grads(inp)
    return {k: (v.float() * (1 + 0.25 * pod) + 0.01 * (pod - data))
            .to(v.dtype) for k, v in g.items()}


def _two_steps(g: dict, mesh) -> list:
    """Two syncs, the second of the halved gradients from the first's
    error state (as the JAX fixture runs them)."""
    err, steps = init_error_state(g), []
    for _ in range(2):
        synced, err = compressed_grad_sync(g, err, mesh=mesh, axis="pod")
        steps.append(({k: v.clone() for k, v in synced.items()},
                      {k: v.clone() for k, v in err.items()}))
        g = {k: v * 0.5 for k, v in g.items()}
    return steps


def _worker(rank, init, out):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    res = {}
    try:
        dmesh = MESH.device_mesh(MESH.make_mesh(SHAPE, AXES, ["cpu"]))
        pod = dmesh.get_local_rank("pod")
        data = dmesh.get_local_rank("data")
        res["coord"] = (pod, data)
        inp = _inputs()
        res["same"] = _two_steps(_grads(inp), dmesh)
        res["differ"] = _two_steps(_replica(inp, pod, data), dmesh)
        # DTensor leaves: replicated over pod, rows sharded over data
        placements = (Replicate(), Shard(0))
        g = {k: DTensor.from_local(v.chunk(2)[data].contiguous(), dmesh,
                                   placements, run_check=False,
                                   shape=v.shape, stride=v.stride())
             for k, v in _grads(inp).items() if v.shape[0] % 2 == 0}
        synced, err = compressed_grad_sync(g, init_error_state(g),
                                           mesh=dmesh, axis="pod")
        res["dtensor"] = {
            k: (isinstance(synced[k], DTensor)
                and tuple(synced[k].placements) == placements
                and isinstance(err[k], DTensor)
                and tuple(err[k].placements) == placements,
                synced[k].to_local().clone(), err[k].to_local().clone())
            for k in g}
        # GPipe: stage i on pod rank i
        w = torch.from_numpy(inp["pw"])
        x = torch.from_numpy(inp["px"])
        w_dt = DTensor.from_local(w[pod:pod + 1].clone(), dmesh,
                                  (Shard(0), Replicate()), run_check=False,
                                  shape=w.shape, stride=w.stride())
        calls = []
        res["pipe"] = pipeline_forward(
            lambda p, h: calls.append(1) or _stage(p, h), w_dt, x,
            mesh=dmesh, axis="pod")
        res["pipe_calls"] = len(calls)
        res["pipe_list"] = pipeline_forward(_stage, list(w), x, mesh=dmesh,
                                            axis="pod")
    finally:
        dist.destroy_process_group()
    refused = []
    for fn in (lambda: compressed_grad_sync({"w": torch.zeros(2)},
                                            {"w": torch.zeros(2)},
                                            mesh=dmesh),
               lambda: pipeline_forward(_stage, list(w), x, mesh=dmesh)):
        try:
            fn()
            refused.append(False)
        except RuntimeError as e:
            refused.append("initialised process group" in str(e))
    res["refused_without_group"] = refused
    torch.save(res, out / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> list:
    tmp = tmp_path_factory.mktemp("runtime_pg")
    workers = mp.start_processes(_worker, args=(f"file://{tmp / 'store'}",
                                                tmp),
                                 nprocs=WORLD, join=False,
                                 start_method="spawn")
    deadline = time.monotonic() + WORKERS_TIMEOUT_S
    while not workers.join(timeout=1):      # raises if a worker failed
        if time.monotonic() > deadline:
            for p in workers.processes:
                p.kill()
            pytest.fail(f"the {WORLD} gloo workers did not finish in "
                        f"{WORKERS_TIMEOUT_S} s")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


def _equal(got: dict, want: dict, what: str):
    for k, w in want.items():
        assert got[k].dtype == w.dtype, (what, k)
        assert torch.equal(got[k], w), (what, k)


def test_sync_of_same_replicas_equals_single_controller_and_jax(ranks,
                                                                 jax_out):
    cpu = MESH.make_mesh((4,), ("pod",), ["cpu"])
    want = _two_steps(_grads(_inputs()), cpu)
    for res in ranks:
        for step, ((s, e), (ws, we)) in enumerate(zip(res["same"], want), 1):
            _equal(s, ws, f"synced, step {step}, rank {res['coord']}")
            _equal(e, we, f"error state, step {step}, rank {res['coord']}")
            for k in s:
                np.testing.assert_array_equal(s[k].float().numpy(),
                                              jax_out[f"s{step}_{k}"])
                np.testing.assert_array_equal(e[k].numpy(),
                                              jax_out[f"e{step}_{k}"])


def test_sync_of_differing_replicas_is_the_plain_formula(ranks):
    """Each rank's result: its own error-feedback quantisation, the codes
    of the 4 pod ranks of its data column summed as int32 in rank order,
    times the largest scale, over 4 in float32; its own residual."""
    inp = _inputs()
    for data in range(SHAPE[1]):
        g = [_replica(inp, pod, data) for pod in range(SHAPE[0])]
        err = [init_error_state(r) for r in g]
        for step in range(2):
            want_s, want_e = [{} for _ in g], [{} for _ in g]
            for k in g[0]:
                q = [_ef_quantize(r[k], e[k]) for r, e in zip(g, err)]
                total = q[0][0].to(torch.int32)
                for c, _, _ in q[1:]:
                    total = total + c.to(torch.int32)
                scale = torch.stack([sc for _, sc, _ in q]).max()
                synced = true_div(total.float() * scale, 4.0).to(g[0][k].dtype)
                for pod in range(SHAPE[0]):
                    want_s[pod][k] = synced
                    want_e[pod][k] = q[pod][2]
            for res in ranks:
                pod, d = res["coord"]
                if d == data:
                    _equal(res["differ"][step][0], want_s[pod],
                           f"synced, step {step + 1}, rank {res['coord']}")
                    _equal(res["differ"][step][1], want_e[pod],
                           f"error state, step {step + 1}, rank "
                           f"{res['coord']}")
            err = want_e
            g = [{k: v * 0.5 for k, v in r.items()} for r in g]
        assert not torch.equal(want_s[0]["w"], _grads(inp)["w"])


def test_sync_of_dtensor_leaves_keeps_their_placements(ranks):
    cpu = MESH.make_mesh((4,), ("pod",), ["cpu"])
    for res in ranks:
        data = res["coord"][1]
        assert set(res["dtensor"]) == {"w"}       # the leaves that split
        for k, (placed, synced, err) in res["dtensor"].items():
            assert placed
            local = {k: _grads(_inputs())[k].chunk(2)[data].contiguous()}
            ws, we = compressed_grad_sync(local, init_error_state(local),
                                          mesh=cpu, axis="pod")
            assert torch.equal(synced, ws[k]) and torch.equal(err, we[k])


def test_pipeline_equals_single_controller_serial_and_jax(ranks, jax_out):
    inp = _inputs()
    w, x = torch.from_numpy(inp["pw"]), torch.from_numpy(inp["px"])
    cpu = MESH.make_mesh(SHAPE, AXES, ["cpu"])
    want = pipeline_forward(_stage, w, x, mesh=cpu, axis="pod")
    ref = x
    for i in range(S):
        ref = _stage(w[i], ref)
    for res in ranks:
        assert res["pipe_calls"] == M + S - 1   # bubble ticks compute too
        assert torch.equal(res["pipe"], want)
        assert torch.equal(res["pipe_list"], want)
        assert torch.equal(res["pipe"], ref)
        np.testing.assert_allclose(res["pipe"].numpy(), jax_out["pipe"],
                                   rtol=2e-5, atol=2e-5)


def test_a_device_mesh_without_its_group_raises(ranks):
    assert all(res["refused_without_group"] == [True, True]
               for res in ranks)

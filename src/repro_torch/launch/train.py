"""Training launcher of the port — the counterpart of
``repro.launch.train``: the model and its AdamW state, laid out by the
sharding rules over a mesh or on one device, the synthetic stream and the
fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \
        [--smoke] [--steps 100] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch olmo_1b --smoke --device cpu

prints the JAX launcher's summary line (``steps=... wall=...s
first_loss=... last_loss=... median_step=...ms stragglers=[...]``).
Without ``torchrun`` it trains on one device.  Under ``torchrun``
(``WORLD_SIZE`` set) every rank initialises the process group (NCCL, or
``gloo`` with ``--device cpu``) and trains on the ranks' mesh,
(1, world, 1) over ``pod``, ``data``, ``model`` (JAX's ``make_local_mesh``
over the processes' devices); only rank 0 prints.  Without ``--smoke`` it
is the arch's full published width: run that on the card.  Checkpoints go
to ``--ckpt-dir``, which must hold none yet; by default each run makes a
new directory under ``build/repro_torch/ckpt`` in the repository.  (The
JAX launcher's fixed ``/tmp/repro_ckpt`` lets a second run's rotation
delete its own checkpoints and a fault restore the first run's state.)
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.device import process_group, resolve_device
from repro_torch.launch import mesh as MESH
from repro_torch.launch import shardings as SH
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import FaultTolerantLoop

CKPT_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "ckpt"


def mesh_device(mesh: MESH.Mesh, device=None) -> torch.device:
    """This rank's device for training over ``mesh``: ``cuda:<local
    rank>`` under NCCL (``device`` None or ``"cuda"``), or the CPU under
    ``gloo`` when ``device="cpu"``.  Raises without an initialised process
    group whose size is the mesh's: a mesh never falls back to one
    device."""
    dist = process_group()
    if dist is None:
        raise RuntimeError("training over a mesh needs an initialised "
                           "process group (torch.distributed."
                           "init_process_group) of the mesh's size")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, the mesh {mesh.size} positions")
    backend = dist.get_backend()
    if device is not None and torch.device(device).type == "cpu":
        if backend != "gloo":
            raise ValueError(f"CPU training over a mesh needs a gloo group, "
                             f"this one is {backend}")
        return torch.device("cpu")
    if backend != "nccl":
        raise ValueError(f"training over a mesh on CUDA needs an NCCL group, "
                         f"this one is {backend}")
    if device is None or torch.device(device).index is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() % max(count, 1)))
        device = torch.device("cuda", local)
    dev = resolve_device(device)
    torch.cuda.set_device(dev)
    return dev


def shard_whole(t: torch.Tensor, dmesh, spec):
    """The DTensor at ``spec``'s placements of the tensor ``t``, which every
    rank holds whole and equal: each rank keeps its slice, nothing is
    sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, dmesh, SH.placements(spec, dmesh),
                             src_data_rank=None)


def place_model(model, rules: SH.ShardingRules, dmesh):
    """The model's parameters swapped, in place, for DTensor parameters at
    ``rules.tree_param_specs``' placements, each rank keeping its slice."""
    specs = rules.tree_param_specs(model)
    for prefix, mod in model.named_modules():
        for name, p in list(mod._parameters.items()):
            full = f"{prefix}.{name}" if prefix else name
            mod._parameters[name] = torch.nn.Parameter(
                shard_whole(p.detach(), dmesh, specs[full]),
                requires_grad=p.requires_grad)
    return model


def mesh_train_step(step, rules: SH.ShardingRules, dmesh):
    """``step`` over a mesh: each batch entry, the whole global batch on
    every rank, becomes a DTensor at ``rules.tree_batch_specs``' placements
    (each rank keeps its rows, no collective); the step runs with the plain
    tensors it makes (positions, masks) counted as replicated; the metrics
    come back as plain 0-d tensors, equal on every rank."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    def train_step(model, opt_state, batch):
        specs = rules.tree_batch_specs(batch)
        placed = {k: shard_whole(v, dmesh, specs[k]) for k, v in batch.items()}
        with implicit_replication():
            model, opt_state, metrics = step(model, opt_state, placed)
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in metrics.items()}
        return model, opt_state, metrics

    return train_step


def build(cfg, *, mesh=None, device=None, seq_len=128, global_batch=8,
          seed=0, lr=3e-4, total_steps=1000):
    """(model, opt_state, train_step, stream) for ``cfg``, the counterpart
    of JAX's ``build(mesh=)``.

    ``mesh=None``: everything on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``), as JAX's default ``make_local_mesh()`` is (1, 1, 1)
    on one card.  A :class:`~repro_torch.launch.mesh.Mesh`: every rank of
    the initialised process group (whose size must be the mesh's;
    :func:`mesh_device` names the device) draws the model from ``seed`` the
    same way, keeps its slice of each parameter at the sharding rules'
    placements and places the AdamW state beside them (the moments at the
    parameters' placements, the step replicated); the step places each
    batch by the rules.  Every rank's stream yields the same global batch
    (``n_hosts=1``, as JAX's single controller).  The step is eager (no
    counterpart of ``jax.jit``); it updates the model and the state in
    place."""
    opt_cfg = AdamWConfig(lr=lr, total_steps=total_steps,
                          warmup_steps=max(10, total_steps // 20))
    step = ST.make_train_step(cfg, opt_cfg)
    if mesh is None:
        model, opt_state = ST.init_train_state(
            cfg, seed=seed, device=resolve_device(device))
    else:
        dev = mesh_device(mesh, device)
        dmesh = MESH.device_mesh(mesh, dev.type)
        rules = SH.ShardingRules(mesh)
        model = place_model(M.LMModel(cfg, device=dev, seed=seed), rules,
                            dmesh)
        opt_state = init_opt_state(model)
        step = mesh_train_step(step, rules, dmesh)
    data_cfg = DataConfig(seq_len=seq_len, global_batch=global_batch,
                          vocab_size=cfg.vocab_size, seed=seed,
                          frontend_len=cfg.frontend_len if cfg.frontend else 0,
                          d_model=cfg.d_model)
    stream = SyntheticLMStream(data_cfg)
    return model, opt_state, step, stream


def _ckpt_dir(requested, dist) -> str:
    """``requested``, or a new directory under CKPT_ROOT made by rank 0 and
    named to every rank."""
    if requested is not None:
        return requested
    path = [None]
    if dist is None or dist.get_rank() == 0:
        CKPT_ROOT.mkdir(parents=True, exist_ok=True)
        path[0] = tempfile.mkdtemp(prefix="run_", dir=CKPT_ROOT)
    if dist is not None:
        dist.broadcast_object_list(path, src=0)
    return path[0]


def main(argv=None) -> FaultTolerantLoop:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="an empty or new directory (default: a new one "
                         "under build/repro_torch/ckpt)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default), 'cuda:N' or 'cpu'; under "
                         "torchrun 'cuda' is the rank's card, 'cpu' a gloo "
                         "group")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dist = None
    if os.environ.get("WORLD_SIZE"):
        import torch.distributed as dist
        cpu = torch.device(args.device).type == "cpu"
        dist.init_process_group("gloo" if cpu else "nccl")
    try:
        mesh = MESH.make_world_mesh() if dist is not None else None
        model, opt_state, step, stream = build(
            cfg, mesh=mesh, device=args.device, seq_len=args.seq_len,
            global_batch=args.global_batch, lr=args.lr,
            total_steps=args.steps)
        loop = FaultTolerantLoop(step, stream, model, opt_state,
                                 ckpt_dir=_ckpt_dir(args.ckpt_dir, dist),
                                 ckpt_every=args.ckpt_every)
        t0 = time.time()
        loop.run(args.steps)
        dt = time.time() - t0
        if dist is None or dist.get_rank() == 0:
            losses = [m["loss"] for m in loop.metrics_log]
            print(f"steps={args.steps} wall={dt:.1f}s "
                  f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f} "
                  f"median_step={loop.watchdog.median*1e3:.0f}ms "
                  f"stragglers={loop.watchdog.flagged}")
            if args.log:
                with open(args.log, "w") as f:
                    json.dump({"metrics": loop.metrics_log, "wall_s": dt}, f)
    finally:
        if dist is not None:
            dist.destroy_process_group()
    return loop


if __name__ == "__main__":
    main()

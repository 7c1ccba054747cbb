"""The per-device regions of the port's sharded model path compute the
unsharded function, on real DTensors.

Eight processes on the CPU (a ``gloo`` group, spawned) form a (2, 4)
``data`` × ``model`` mesh and run one decode step of eleven smoke configs
in float32, their parameters, cache and token laid out by the sharding
rules as the dry run lays them out: internlm2_20b with 12 query and 2 KV heads
(the KV projection gathered, each device's query heads in one GQA group),
mamba2_370m (SSD heads over ``model``, the state at ``cache_spec``'s
placements), moonshot_v1_16b_a3b (experts over ``model``) with a capacity
factor that drops tokens, hymba_1_5b with its 2 SSD heads replicated,
granite_moe_3b_a800m with 6 experts (``MOE_ALT``'s d_ff shards) that drop
tokens and whisper_large_v3 with 5 heads (its encoder, cross attention
and learned positions).  The logits, the next token and the
updated cache are held against the unsharded port's on the same seeded
inputs at 1e-5, and the MoE's kept and dropped choices, per layer, are the
unsharded MoE's.  Then a prefill of a batch (hymba's window ring filled
per device), its logits and cache; and the loss and every parameter's
gradient of one train-mode batch (remat on, as the smoke configs have
it), against the unsharded ones at 1e-5: the regions' gradients reach
every device's shards, summed where devices used a replicated input
differently.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import smoke_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import steps as ST

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
BATCH, CACHE_LEN, TRAIN_LEN = 16, 8, 16
TOL = 1e-5
WORKERS_TIMEOUT_S = 300
CASES = {
    "internlm2_20b": {"n_heads": 12, "n_kv_heads": 2},
    "mamba2_370m": {},
    # 16 tokens × 2 choices over 4 experts of capacity 4: some drop
    "moonshot_v1_16b_a3b": {"moe_capacity_factor": 0.5},
    # SSD heads replicated (2 over 4), out_proj's rows split; KV heads
    # gathered
    "hymba_1_5b": {"n_heads": 5, "n_kv_heads": 1, "ssm_heads": 2},
    # 6 experts over 4: MOE_ALT's d_ff shards; 6 query heads gathered
    "granite_moe_3b_a800m": {"n_heads": 6, "n_kv_heads": 2, "n_experts": 6,
                             "moe_capacity_factor": 0.5},
    # 5 heads over 4, gathered: the encoder, cross attention and the
    # learned positions
    "whisper_large_v3": {"n_heads": 5, "n_kv_heads": 5},
    "olmo_1b": {},
    # llama3_405b's 128/8 and starcoder2_7b's 36/4 head ratios
    "llama3_405b": {"n_heads": 16, "n_kv_heads": 1},
    "starcoder2_7b": {"n_heads": 9, "n_kv_heads": 1},
    # 4 query and 2 KV heads, and the vision prefix of 8 embeddings
    "internvl2_1b": {},
    "olmo_1b@2x2x2": {},
}
MOE = ("moonshot_v1_16b_a3b", "granite_moe_3b_a800m")


def _arch_mesh(case) -> tuple:
    """(arch, mesh name) of a case ``arch`` or ``arch@mesh``."""
    arch, _, mesh = case.partition("@")
    return arch, mesh or "2x4"


def _inputs(case, overrides):
    """The case's config, model, cache and token, from seed 0."""
    cfg = dataclasses.replace(smoke_config(_arch_mesh(case)[0]), **overrides)
    model = M.LMModel(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    cache = M.init_cache(cfg, BATCH, CACHE_LEN, enc_len=cfg.frontend_len,
                         device="cpu")
    for layer in cache:
        for t in layer.values():
            t.copy_(torch.from_numpy(
                rng.standard_normal(t.shape).astype(np.float32)))
    token = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32))
    return cfg, model, cache, token


def _train_batch(cfg):
    """Tokens and labels, and the encoder's frame embeddings (whisper) or
    the vision prefix's (internvl2)."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, TRAIN_LEN + 1))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(tokens[:, 1:].astype(np.int32))}
    if cfg.encoder_layers or cfg.frontend == "vision_stub":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    return batch


def _recording_slots(record: list):
    """``L._slots`` that also appends each call's kept choices."""
    inner = L._slots

    def slots(*args, **kw):
        keep, pos = inner(*args, **kw)
        record.append(keep.clone())
        return keep, pos
    return slots


def _step(arch, overrides, place=None):
    """(next token, logits, cache, kept choices per MoE layer) of one
    decode step, its inputs laid out by ``place`` (None: unsharded)."""
    cfg, model, cache, token = _inputs(arch, overrides)
    if place is not None:
        model, cache, token = place(model, cache, token)
    record = []
    inner, L._slots = L._slots, _recording_slots(record)
    try:
        nxt, logits, cache = ST.make_decode_step(cfg)(model, cache, token,
                                                      CACHE_LEN - 1)
    finally:
        L._slots = inner
    return nxt, logits, cache, record


def _prefill(arch, overrides, place=None, put_batch=None, init_cache=None):
    """(logits, cache) of a prefill of the train batch's tokens into a
    cache of CACHE_LEN + TRAIN_LEN positions (hymba's window ring is
    filled from its tail)."""
    cfg, model, cache, token = _inputs(arch, overrides)
    batch = _train_batch(cfg)
    batch.pop("labels")
    kw = {}
    if place is not None:
        model, _, _ = place(model, cache, token)
        batch, kw = put_batch(batch), {"init_cache": init_cache}
    return ST.make_prefill(cfg, CACHE_LEN + TRAIN_LEN, **kw)(model, batch)


def _gradients(arch, overrides, place=None, put_batch=None):
    """(loss, {name: gradient}) of one train-mode batch."""
    cfg, model, cache, token = _inputs(arch, overrides)
    batch = _train_batch(cfg)
    if place is not None:
        model, _, _ = place(model, cache, token)
        batch = put_batch(batch)
    params = dict(model.named_parameters())
    loss, _, grads = ST._grads(cfg, model, params, batch)
    return loss, grads


def _worker(rank, world, init, out, cases):
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as MESH_
    from repro_torch.launch import shardings as SH
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    meshes = {}
    try:
        results = {}
        for case, overrides in cases.items():
            mesh_name = _arch_mesh(case)[1]
            if mesh_name not in meshes:
                mesh = MESH_.make_mesh(*MESHES[mesh_name], ["cpu"])
                meshes[mesh_name] = (mesh, MESH_.device_mesh(mesh, "cpu"))
            mesh, dmesh = meshes[mesh_name]
            rules = SH.ShardingRules(mesh)

            def put(t, spec):
                return distribute_tensor(t, dmesh, SH.placements(spec, dmesh))

            def place(model, cache, token):
                specs = rules.tree_param_specs(model)
                for prefix, mod in model.named_modules():
                    for name, p in list(mod._parameters.items()):
                        full = f"{prefix}.{name}" if prefix else name
                        mod._parameters[name] = torch.nn.Parameter(
                            put(p.detach(), specs[full]))
                cache = [{k: put(t, s[k]) for k, t in c.items()}
                         for c, s in zip(cache, rules.tree_cache_specs(cache))]
                return model, cache, put(token, rules.batch_spec(token.shape))

            def put_batch(batch):
                return {k: put(v, rules.batch_spec(v.shape))
                        for k, v in batch.items()}

            with implicit_replication():
                nxt, logits, cache, kept = _step(case, overrides, place)
            # the kept choices of each batch shard, from its model rank 0
            shards = [None] * world
            dist.all_gather_object(shards, (dmesh.get_coordinate(), kept))
            kept = [torch.cat([k[layer] for c, k in sorted(
                        (tuple(c), k) for c, k in shards) if c[-1] == 0])
                    for layer in range(len(kept))]
            with implicit_replication():
                loss, grads = _gradients(case, overrides, place, put_batch)
                pre_logits, pre_cache = _prefill(
                    case, overrides, place, put_batch,
                    D._Placer(mesh, dmesh).cache_allocator(rules))
            results[case] = {
                "next": nxt.full_tensor(), "logits": logits.full_tensor(),
                "cache": [{k: t.full_tensor() for k, t in c.items()}
                          for c in cache],
                "kept": kept, "loss": loss.full_tensor(),
                "prefill": (pre_logits.full_tensor(), [
                    {k: t.full_tensor() for k, t in c.items()}
                    for c in pre_cache]),
                "grads": {n: g.full_tensor() for n, g in grads.items()}}
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("split_numeric")
    world = int(np.prod(MESHES["2x4"][0]))
    workers = mp.start_processes(
        _worker, args=(world, f"file://{tmp / 'store'}", str(tmp / "out.pt"),
                       CASES), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + WORKERS_TIMEOUT_S
    while not workers.join(timeout=1):      # raises if a worker failed
        if time.monotonic() > deadline:
            for p in workers.processes:
                p.kill()
            pytest.fail(f"the {world} gloo workers did not finish in "
                        f"{WORKERS_TIMEOUT_S} s")
    return torch.load(tmp / "out.pt")


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_decode_step_is_the_unsharded_one(arch, sharded):
    nxt, logits, cache, kept = _step(arch, CASES[arch])
    got = sharded[arch]
    torch.testing.assert_close(got["logits"], logits, rtol=TOL, atol=TOL)
    assert torch.equal(got["next"], nxt)
    for got_layer, want_layer in zip(got["cache"], cache, strict=True):
        assert set(got_layer) == set(want_layer)
        for key, want in want_layer.items():
            torch.testing.assert_close(got_layer[key], want, rtol=TOL,
                                       atol=TOL)
    assert len(got["kept"]) == len(kept)
    for got_keep, want_keep in zip(got["kept"], kept):
        assert torch.equal(got_keep, want_keep)
    if arch in MOE:
        assert kept and all(not bool(k.all()) for k in kept)  # drops


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_gradients_are_the_unsharded_ones(arch, sharded):
    loss, grads = _gradients(arch, CASES[arch])
    got = sharded[arch]
    torch.testing.assert_close(got["loss"], loss, rtol=TOL, atol=TOL)
    assert set(got["grads"]) == set(grads)
    for name, want in grads.items():
        torch.testing.assert_close(got["grads"][name], want, rtol=TOL,
                                   atol=TOL, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_prefill_is_the_unsharded_one(arch, sharded):
    logits, cache = _prefill(arch, CASES[arch])
    got_logits, got_cache = sharded[arch]["prefill"]
    torch.testing.assert_close(got_logits, logits, rtol=TOL, atol=TOL)
    for got_layer, want_layer in zip(got_cache, cache, strict=True):
        assert set(got_layer) == set(want_layer)
        for key, want in want_layer.items():
            torch.testing.assert_close(got_layer[key], want, rtol=TOL,
                                       atol=TOL)

"""Train, serve and evaluation step factories over the port's model zoo —
the counterpart of ``repro.models.steps``.

``make_train_step`` → one AdamW step (gradient accumulation included);
``make_prefill / make_decode_step`` → the serving path (KV/SSM caches);
``make_eval_step`` → the forward-only loss.  Each step takes the
:class:`~repro_torch.models.model.LMModel` where the JAX step takes its
parameter tree; the serving and evaluation steps run without autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state


def _label_log_probs(logits, labels):
    """log_softmax(logits) at ``labels``.  On a DTensor whose vocabulary is
    sharded it runs on each device's shards (the vocabulary-parallel cross
    entropy of Megatron, and what XLA's partitioner makes of
    ``log_softmax``): the row max, the sum of exponentials and the label's
    logit (looked up in the shard that holds it) are each reduced over the
    vocabulary's mesh dimension, so no device holds the (B, S, V) logits
    whole, as it would under DTensor's own ``log_softmax``."""
    dtensor = L.dtensor_type()
    vdim = [] if dtensor is None or not isinstance(logits, dtensor) else [
        d for d, p in enumerate(logits.placements)
        if p.is_shard(logits.ndim - 1)]
    if not vdim:
        logp = F.log_softmax(logits, dim=-1)
        return logp.gather(-1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    (vdim,) = vdim
    mesh = logits.device_mesh
    rows = [Replicate() if d == vdim else p
            for d, p in enumerate(logits.placements)]

    def reduced(local, op):
        """A per-shard partial result reduced over the vocabulary shards."""
        placements = list(rows)
        placements[vdim] = Partial(op)
        return dtensor.from_local(local, mesh, placements,
                                  run_check=False).redistribute(
            mesh, rows).to_local()

    local = logits.to_local()
    v_local = local.shape[-1]
    offset = mesh.get_coordinate()[vdim] * v_local
    label = labels.redistribute(mesh, rows).to_local().long() - offset
    held = (label >= 0) & (label < v_local)
    shifted = local - reduced(local.detach().amax(-1, keepdim=True), "max")
    lse = torch.log(reduced(torch.exp(shifted).sum(-1), "sum"))
    picked = shifted.gather(-1, label.clamp(0, v_local - 1)[..., None])[..., 0]
    picked = reduced(picked * held.to(picked.dtype), "sum")
    return dtensor.from_local(picked - lse, mesh, rows, run_check=False,
                              shape=labels.shape,
                              stride=L.contiguous_stride(labels.shape))


def cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions; logits f32 (B, S, V), labels (B, S)."""
    ll = _label_log_probs(logits, labels)
    if mask is None:
        mask = torch.ones_like(ll)
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg, model, batch, *, aux_weight: float = 0.01):
    logits, aux, _ = model(batch, mode="train")
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        # modality prefix (VLM): loss only over the token tail
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    loss = cross_entropy(logits, labels, batch.get("loss_mask"))
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(model, batch):
        loss, metrics = loss_fn(cfg, model, batch)
        return dict(metrics, loss=loss)
    return eval_step


def make_prefill(cfg, max_len: int, *, init_cache=M.init_cache):
    """``prefill(model, batch) -> (logits, cache)``.  ``init_cache``
    allocates the cache (``init_cache(cfg, batch, max_len, enc_len=,
    device=)``); the dry run passes one that allocates DTensor shards."""
    @torch.no_grad()
    def prefill(model, batch):
        b = batch["tokens"].shape[0]
        enc_len = batch["embeds"].shape[1] if cfg.encoder_layers else 0
        cache = init_cache(cfg, b, max_len, enc_len=enc_len,
                           device=model.device)
        if cfg.encoder_layers:
            enc_out = model.encode(batch["embeds"])
            cache = M.fill_cross_cache(cfg, model, cache, enc_out)
        logits, _, cache = model(batch, mode="prefill", cache=cache,
                                 cache_index=0)
        return logits, cache

    return prefill


def greedy_token(logits):
    """The argmax over the vocabulary of the last position, (B,) int32.  A
    DTensor's vocabulary shards (and partial sums) are gathered first:
    DTensor's sharded argmax reads its shards' offsets as numbers, which
    the dry run's fake tensors do not hold; the gather is the plan's, and
    its census counts it."""
    last = logits[:, -1]
    dtensor = L.dtensor_type()
    if dtensor is not None and isinstance(last, dtensor):
        from torch.distributed.tensor import Replicate
        last = last.redistribute(last.device_mesh, [
            Replicate() if p.is_partial() or (p.is_shard()
                                              and p.dim == last.ndim - 1)
            else p for p in last.placements])
    return torch.argmax(last, dim=-1).to(torch.int32)


def make_decode_step(cfg):
    @torch.no_grad()
    def decode_step(model, cache, token, cache_index: int):
        """token: (B, 1) int32; cache_index: the token's position."""
        logits, _, cache = model({"tokens": token}, mode="decode",
                                 cache=cache, cache_index=cache_index)
        next_tok = greedy_token(logits)
        return next_tok[:, None], logits, cache

    return decode_step


def _grads(cfg, model, params: dict, batch: dict):
    """(loss, metrics, {name: gradient}) of one batch, the gradients in the
    parameters' dtypes (zeros for a parameter the loss does not reach, as
    JAX's grad gives)."""
    loss, metrics = loss_fn(cfg, model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                materialize_grads=True)
    return loss.detach(), metrics, dict(zip(params, grads))


def _microbatches(batch: dict, accum: int) -> list:
    """JAX's microbatches of ``batch``: microbatch i holds rows [i·B/accum,
    (i+1)·B/accum) of every entry.  On a DTensor batch that slice does not
    follow the data shards, so the entry is gathered over the mesh
    dimensions that shard its rows (tokens are small), sliced, and each
    microbatch sharded there again where its rows divide the shards (else
    left replicated there, as the rules' fallback replicates)."""
    dtensor = L.dtensor_type()
    out = [{} for _ in range(accum)]
    for k, v in batch.items():
        rows = v.shape[0] // accum
        if dtensor is None or not isinstance(v, dtensor):
            micro = v.reshape((accum, rows) + v.shape[1:])
            for i in range(accum):
                out[i][k] = micro[i]
            continue
        from torch.distributed.tensor import Replicate
        mesh = v.device_mesh
        whole = v.redistribute(mesh, [Replicate() if p.is_shard(0) else p
                                      for p in v.placements])
        target, cut = [], 1
        for dim, p in enumerate(v.placements):
            if p.is_shard(0) and rows % (cut * mesh.size(dim)) == 0:
                cut *= mesh.size(dim)
            elif p.is_shard(0):
                p = Replicate()
            target.append(p)
        for i in range(accum):
            out[i][k] = whole[i * rows:(i + 1) * rows].redistribute(
                mesh, target)
    return out


def make_train_step(cfg, opt_cfg: AdamWConfig = AdamWConfig()):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the parameters and the optimizer state are updated in place
    (the counterpart of ``donate_argnums``); metrics ``ce``, ``aux``,
    ``loss``, ``grad_norm`` and ``lr`` are 0-d tensors on the model's device,
    so the step never waits on the host.

    With ``cfg.grad_accum`` > 1 the batch is split into that many
    microbatches, as JAX splits it: microbatch i is rows [i·B/accum,
    (i+1)·B/accum) of the global batch (on a DTensor batch, gathered and
    sharded again over the data axes, :func:`_microbatches`).  Each one's
    gradients are added into float32 buffers as ``g / accum`` (not into
    ``.grad`` in the parameters' dtype; on DTensor parameters the buffers
    have the parameters' placements), its loss as ``loss / accum``; the
    other metrics are the microbatches' means."""
    accum = max(int(getattr(cfg, "grad_accum", 1)), 1)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if accum == 1:
            loss, metrics, grads = _grads(cfg, model, params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.items()}
            loss, seq = None, []
            for mb in _microbatches(batch, accum):
                l_i, m_i, g_i = _grads(cfg, model, params, mb)
                for n, g in g_i.items():
                    grads[n] = grads[n] + g.float() / accum
                loss = l_i / accum if loss is None else loss + l_i / accum
                seq.append(m_i)
            metrics = {k: torch.stack([m[k].detach() for m in seq]).mean()
                       for k in seq[0]}
        _, opt_state, stats = adamw_update(opt_cfg, params, grads, opt_state)
        return model, opt_state, dict(metrics, loss=loss, **stats)

    return train_step


def init_train_state(cfg, *, seed: int = 0, device=None):
    """(LMModel drawn from ``seed`` on ``device``, its AdamW state)."""
    model = M.LMModel(cfg, device=device, seed=seed)
    return model, init_opt_state(model)

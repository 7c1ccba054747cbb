"""Serve and evaluation step factories over the port's model zoo — the
serving half of ``repro.models.steps``.

``make_prefill / make_decode_step`` → the serving path (KV/SSM caches);
``make_eval_step`` → the forward-only loss.  Each step takes the
:class:`~repro_torch.models.model.LMModel` where the JAX step takes its
parameter tree, and runs without autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import model as M


def cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions; logits f32 (B, S, V), labels (B, S)."""
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
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


def make_prefill(cfg, max_len: int):
    @torch.no_grad()
    def prefill(model, batch):
        b = batch["tokens"].shape[0]
        enc_len = batch["embeds"].shape[1] if cfg.encoder_layers else 0
        cache = M.init_cache(cfg, b, max_len, enc_len=enc_len,
                             device=model.device)
        if cfg.encoder_layers:
            enc_out = model.encode(batch["embeds"])
            cache = M.fill_cross_cache(cfg, model, cache, enc_out)
        logits, _, cache = model(batch, mode="prefill", cache=cache,
                                 cache_index=0)
        return logits, cache

    return prefill


def make_decode_step(cfg):
    @torch.no_grad()
    def decode_step(model, cache, token, cache_index: int):
        """token: (B, 1) int32; cache_index: the token's position."""
        logits, _, cache = model({"tokens": token}, mode="decode",
                                 cache=cache, cache_index=cache_index)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache

    return decode_step

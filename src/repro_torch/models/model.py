"""Composable model zoo of the port: one ``nn.Module`` covering all assigned
families — the counterpart of ``repro.models.model``.

* an ``nn.ModuleList`` of decoder layers (and of encoder layers for whisper)
  in place of the JAX package's stacked per-layer params and ``lax.scan``;
* KV caches (full, sliding-window ring for Hymba), SSM state caches and
  whisper cross-attention caches for decode, as a list with one dict per
  layer whose tensors have the JAX cache's per-layer layout; the port
  updates them in place and returns the same list;
* modality frontends are STUBS, as in the JAX package: ``batch["embeds"]``
  carries precomputed frame/patch embeddings at d_model.

Modes: "train" (causal, full seq), "prefill" (fills the cache, returns the
last position's logits), "decode" (single token step against the cache).
``LMModel`` runs on ``cuda`` unless the caller passes ``device="cpu"``.

Remat (``cfg.remat``), the counterpart of ``jax.checkpoint``: while autograd
records, each decoder layer of the train mode is recomputed in the backward
pass under ``cfg.remat_policy`` ("dots": the GEMMs' outputs are saved, as
``dots_saveable`` saves them; "nothing": the whole layer is recomputed), and
each encoder layer is recomputed whole.  Without grad (serving, evaluation)
nothing is wrapped.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


def model_device(device) -> torch.device:
    """``resolve_device(device)``, except that ``"meta"`` stays meta: a
    model or a cache on meta holds shapes and dtypes, no data, and runs on
    no device."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


class Layer(nn.Module):
    """One layer's parameters (JAX's ``_layer_params``); kind: decoder |
    encoder | cross_decoder | ssm_only."""

    def __init__(self, cfg, init: L.ParamInit, *, kind: str):
        super().__init__()
        d = cfg.d_model
        if kind != "ssm_only" and cfg.n_heads:
            self.attn = L.Attention(cfg, init)
            self.ln_attn = L.Norm(cfg, d, init)
        if kind == "cross_decoder":
            self.cross = L.Attention(cfg, init)
            self.ln_cross = L.Norm(cfg, d, init)
        if cfg.family == "moe":
            self.moe = L.MoE(cfg, init)
            self.ln_mlp = L.Norm(cfg, d, init)
        elif cfg.d_ff:
            self.mlp = L.MLP(cfg, init)
            self.ln_mlp = L.Norm(cfg, d, init)
        if cfg.family in ("ssm", "hybrid") or kind == "ssm_only":
            self.ssm = S.SSD(cfg, init)
            if not hasattr(self, "ln_attn"):
                self.ln_attn = L.Norm(cfg, d, init)


class LMModel(nn.Module):
    """The model of one config (JAX's ``init_params`` + ``forward``).

    Parameters are drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed``: normal(0, 0.02) in the config's dtype (the router in
    float32), ``a_log`` 0, ``d_skip`` 1, norm scales 1 and biases 0 — the
    JAX package's distributions, not its values (torch's stream is not JAX's
    PRNG).  :func:`repro_torch.models.convert.params_from_jax` loads a JAX
    parameter tree instead.  Parameter names are the JAX tree's paths with
    the layer index after ``layers.`` / ``enc_layers.``.  On
    ``device="meta"`` the model holds shapes and dtypes only (the dry run's
    ``abstract_params``): nothing is drawn."""

    def __init__(self, cfg, *, device=None, seed: int = 0):
        super().__init__()
        dev = model_device(device)
        init = L.ParamInit(dev, seed)
        dt = torch_dtype(cfg)
        self.cfg = cfg
        self.embed = init.normal((cfg.vocab_size, cfg.d_model), dt)
        self.ln_final = L.Norm(cfg, cfg.d_model, init)
        if not cfg.tie_embeddings:
            self.lm_head = init.normal((cfg.d_model, cfg.vocab_size), dt)
        if cfg.max_position_embeddings:
            self.pos_embed = init.normal(
                (cfg.max_position_embeddings, cfg.d_model), dt)
        kind = "cross_decoder" if cfg.encoder_layers else (
            "ssm_only" if cfg.family == "ssm" else "decoder")
        self.layers = nn.ModuleList(Layer(cfg, init, kind=kind)
                                    for _ in range(cfg.n_layers))
        if cfg.encoder_layers:
            self.enc_layers = nn.ModuleList(Layer(cfg, init, kind="encoder")
                                            for _ in range(cfg.encoder_layers))
            self.enc_ln_final = L.Norm(cfg, cfg.d_model, init)
            self.enc_pos_embed = init.normal(
                (max(cfg.frontend_len, 1), cfg.d_model), dt)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def encode(self, embeds):
        """Encoder stack over precomputed frontend embeddings (B, T, d)."""
        cfg = self.cfg
        b, t, _ = embeds.shape
        x = embeds.to(torch_dtype(cfg)) + self.enc_pos_embed[None, :t]
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        remat = cfg.remat and torch.is_grad_enabled()
        for lp in self.enc_layers:
            if remat:
                x = checkpoint(_encoder_layer, cfg, lp, x, positions=positions,
                               use_reentrant=False)
            else:
                x = _encoder_layer(cfg, lp, x, positions=positions)
        return L.apply_norm(cfg, self, x, "enc_ln_final")

    def _embed_tokens(self, tokens, positions):
        x = L.embed_lookup(self.embed, tokens)
        if self.cfg.max_position_embeddings:
            pos = torch.clamp(positions,
                              max=self.cfg.max_position_embeddings - 1)
            dtensor = L.dtensor_type()
            if dtensor is not None and isinstance(tokens, dtensor):
                pos = L.shard_like(pos, tokens)
            x = x + L.embed_lookup(self.pos_embed, pos)
        return x

    def _logits(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x.float() @ head.float()

    def forward(self, batch, mode: str = "train", cache=None,
                cache_index: int = 0):
        """batch: {"tokens": (B, S) integers, optional "embeds": (B, T, d)}.

        train/prefill: full-sequence causal pass; prefill with a cache fills
        it and returns the last position's logits.  decode: tokens (B, 1)
        against the cache at cache_index.  Returns (logits float32, aux_loss,
        cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = (torch.arange(s, device=tokens.device)[None].expand(b, s)
                     + cache_index)
        x = self._embed_tokens(tokens, positions)

        enc_out = None
        if cfg.encoder_layers and mode != "decode":
            # with a cache, the layers read the cross cache that
            # fill_cross_cache filled, so the encoder output is not needed
            if cache is None:
                enc_out = self.encode(batch["embeds"])
        elif (cfg.frontend == "vision_stub" and "embeds" in batch
              and mode != "decode"):
            x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
            s = x.shape[1]
            positions = torch.arange(s, device=x.device)[None].expand(b, s)

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if mode in ("train", "prefill") and cache is None:
            remat = (cfg.remat and mode == "train"
                     and torch.is_grad_enabled())
            for lp in self.layers:
                if remat:
                    x, aux = checkpoint(
                        _decoder_layer_train, cfg, lp, x, aux, positions,
                        enc_out, use_reentrant=False,
                        context_fn=_remat_context(cfg.remat_policy))
                else:
                    x, aux, _ = _decoder_layer(cfg, lp, x, aux,
                                               positions=positions, mode=mode,
                                               enc_out=enc_out)
            x = L.apply_norm(cfg, self, x, "ln_final")
            return self._logits(x), aux, None

        if len(cache) != len(self.layers):
            raise ValueError(f"cache holds {len(cache)} layers, the model "
                             f"{len(self.layers)}")
        for lp, cl in zip(self.layers, cache):
            x, aux, _ = _decoder_layer(cfg, lp, x, aux, positions=positions,
                                       mode=mode, cache_layer=cl,
                                       index=cache_index, enc_out=enc_out)
        x = L.apply_norm(cfg, self, x, "ln_final")
        if mode == "prefill":
            x = x[:, -1:]
        return self._logits(x), aux, cache


# --- caches ----------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, *, enc_len: int = 0,
               device=None) -> list[dict]:
    """One dict per layer: "k"/"v" (B, cache_len, Hkv, Dh), "pos" (B,
    cache_len) int32 from -1 for a sliding window, "state" (B, H, P, N)
    float32 for SSM layers, "cross_k"/"cross_v" (B, enc_len, Hkv, Dh).
    ``device="meta"`` gives shapes only, as the model does."""
    dev = model_device(device)
    dt = torch_dtype(cfg)
    cache_len = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    cache = []
    for _ in range(cfg.n_layers):
        c = {}
        if cfg.n_heads:
            kv = (batch, cache_len, cfg.n_kv_heads, cfg.d_head)
            c["k"] = torch.zeros(kv, dtype=dt, device=dev)
            c["v"] = torch.zeros(kv, dtype=dt, device=dev)
            if cfg.attn_window:
                c["pos"] = torch.full((batch, cache_len), -1,
                                      dtype=torch.int32, device=dev)
        if cfg.family in ("ssm", "hybrid"):
            c["state"] = S.init_ssm_state(cfg, batch, device=dev)
        if cfg.encoder_layers:
            cross = (batch, enc_len, cfg.n_kv_heads, cfg.d_head)
            c["cross_k"] = torch.zeros(cross, dtype=dt, device=dev)
            c["cross_v"] = torch.zeros(cross, dtype=dt, device=dev)
        cache.append(c)
    return cache


def fill_cross_cache(cfg, model, cache, enc_out):
    """Per-layer cross-attention K/V from encoder outputs, into the cache."""
    for lp, cl in zip(model.layers, cache):
        k = L.split_heads(enc_out @ lp.cross.wk, cfg.n_kv_heads, cfg.d_head)
        v = L.split_heads(enc_out @ lp.cross.wv, cfg.n_kv_heads, cfg.d_head)
        cl["cross_k"] = k.to(cl["cross_k"].dtype)
        cl["cross_v"] = v.to(cl["cross_v"].dtype)
    return cache


# --- remat -------------------------------------------------------------------------

# the ops whose outputs "dots" keeps (dot_general's counterparts); the
# policy sees torch.matmul and einsum already decomposed into mm / bmm
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default, torch.ops.aten.matmul.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(policy: str):
    """``checkpoint``'s ``context_fn`` for ``cfg.remat_policy``: "dots"
    saves the GEMMs' outputs and recomputes the rest (``dots_saveable``);
    "nothing" recomputes everything (``nothing_saveable``)."""
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    if policy == "nothing":
        return noop_context_fn
    raise ValueError(f"remat_policy {policy!r}: expected 'dots' or 'nothing'")


def _decoder_layer_train(cfg, lp, x, aux, positions, enc_out):
    x, aux, _ = _decoder_layer(cfg, lp, x, aux, positions=positions,
                               mode="train", enc_out=enc_out)
    return x, aux


# --- layer bodies -----------------------------------------------------------------


def _project_qkv(cfg, attn, h, positions):
    q = L.split_heads(h @ attn.wq, cfg.n_heads, cfg.d_head)
    k = L.split_heads(h @ attn.wk, cfg.n_kv_heads, cfg.d_head)
    v = L.split_heads(h @ attn.wv, cfg.n_kv_heads, cfg.d_head)
    if cfg.rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _windowed_insert(cfg, lp, cache_layer, k_new, v_new, index, positions):
    """Ring-buffer insert for sliding-window caches (Hymba long decode)."""
    w = cache_layer["k"].shape[1]
    slot = index % w
    L.update_slice(cache_layer["k"], k_new, slot)
    L.update_slice(cache_layer["v"], v_new, slot)
    L.update_slice(cache_layer["pos"], positions.to(torch.int32), slot)
    return cache_layer


def _ring_fill(buf, slots, new):
    """``buf[:, slots] = new`` in place (the windowed prefill's ring fill;
    ``slots`` a plain tensor).  On a DTensor buffer it runs on each
    device's shards: ``new`` (a plain tensor counts as replicated) is
    brought to the buffer's placements, whose ring dim, which the fill
    writes across, is not sharded."""
    dtensor = L.dtensor_type()
    if dtensor is None or not isinstance(buf, dtensor):
        buf[:, slots] = new.to(buf.dtype)
        return buf
    from torch.distributed.tensor import Replicate
    mesh = buf.device_mesh
    if any(p.is_shard(1) for p in buf.placements):
        raise NotImplementedError(
            f"ring fill of a buffer sharded along its ring: "
            f"{buf.placements}")
    if not isinstance(new, dtensor):
        new = L.from_local(new, mesh, [Replicate()] * mesh.ndim, new.shape)
    buf.to_local()[:, slots] = new.redistribute(
        mesh, buf.placements).to_local().to(buf.dtype)
    return buf


def _attn_block(cfg, lp, x, *, positions, mode, cache_layer, index,
                window=None):
    h = L.apply_norm(cfg, lp, x, "ln_attn")
    s = h.shape[1]
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    if mode == "prefill" and cfg.attn_window and cache_layer is not None:
        # windowed prefill: full pass, then ring-fill the cache with the
        # trailing `window` tokens' K/V.
        q, k, v = _project_qkv(cfg, lp.attn, h, positions)
        if s >= cfg.blockwise_attn_threshold:
            out = L.blockwise_attention(q, k, v, causal=True,
                                        block=cfg.attn_block_size,
                                        window=cfg.attn_window)
        else:
            out = L.naive_attention(q, k, v, causal=True,
                                    window=cfg.attn_window)
        out = L.merge_heads(out) @ lp.attn.wo
        w = cache_layer["k"].shape[1]
        tail = min(w, s)
        # ring invariant: position p lives at slot p % w (so decode's
        # index % w insert always overwrites the oldest entry)
        slots = positions[0, s - tail:] % w
        for name, new in (("k", k), ("v", v)):
            cache_layer[name].zero_()
            _ring_fill(cache_layer[name], slots, new[:, s - tail:])
        cache_layer["pos"].fill_(-1)
        _ring_fill(cache_layer["pos"], slots,
                   positions[:, s - tail:].to(torch.int32))
        return out, cache_layer
    if mode == "decode" and cfg.attn_window and cache_layer is not None:
        # sliding-window ring cache: project, rope at absolute pos, ring insert
        q, k, v = _project_qkv(cfg, lp.attn, h, positions)
        _windowed_insert(cfg, lp, cache_layer, k, v, index, positions)
        scale = dh ** -0.5
        q5 = L._group_q(q, hkv)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(),
                              cache_layer["k"].float()) * scale
        pos = cache_layer["pos"]
        valid = ((pos >= 0)[:, None, :]
                 & (pos[:, None, :] <= positions[:, :, None])
                 & (pos[:, None, :] > positions[:, :, None] - cfg.attn_window))
        scores = torch.where(valid[:, None, None], scores, L.NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        v_cache = cache_layer["v"]
        out = torch.einsum("bhgqk,bkhd->bqhgd",
                           probs.to(v_cache.dtype).float(), v_cache.float())
        out = L.merge_heads(out.to(x.dtype)) @ lp.attn.wo
        return out, cache_layer
    return lp.attn(h, positions=positions, causal=True, cache=cache_layer,
                   cache_index=index, window=window)


def _decoder_layer(cfg, lp, x, aux, *, positions, mode, cache_layer=None,
                   index=0, enc_out=None):
    if cfg.family == "ssm":
        h = L.apply_norm(cfg, lp, x, "ln_attn")
        st = cache_layer.get("state") if cache_layer is not None else None
        y, st_new = S.ssd_forward(cfg, lp.ssm, h, state=st)
        x = x + y
        if cache_layer is not None:
            cache_layer["state"] = st_new
    elif cfg.family == "hybrid":
        a_out, _ = _attn_block(cfg, lp, x, positions=positions, mode=mode,
                               cache_layer=cache_layer, index=index)
        h = L.apply_norm(cfg, lp, x, "ln_attn")
        st = cache_layer.get("state") if cache_layer is not None else None
        s_out, st_new = S.ssd_forward(cfg, lp.ssm, h, state=st)
        x = x + (a_out + s_out) / 2.0
        if cache_layer is not None:
            cache_layer["state"] = st_new
    else:
        a_out, _ = _attn_block(cfg, lp, x, positions=positions, mode=mode,
                               cache_layer=cache_layer, index=index)
        x = x + a_out

    if cfg.encoder_layers:
        h = L.apply_norm(cfg, lp, x, "ln_cross")
        if cache_layer is not None:
            kv = (cache_layer["cross_k"], cache_layer["cross_v"])
        else:
            kv = (L.split_heads(enc_out @ lp.cross.wk, cfg.n_kv_heads,
                                cfg.d_head),
                  L.split_heads(enc_out @ lp.cross.wv, cfg.n_kv_heads,
                                cfg.d_head))
        c_out, _ = lp.cross(h, positions=positions, causal=False,
                            kv_override=kv, window=0)
        x = x + c_out

    if cfg.family == "moe":
        h = L.apply_norm(cfg, lp, x, "ln_mlp")
        y, a = lp.moe(h)
        x = x + y
        aux = aux + a
    elif cfg.d_ff:
        h = L.apply_norm(cfg, lp, x, "ln_mlp")
        x = x + lp.mlp(h)
    return x, aux, cache_layer


def _encoder_layer(cfg, lp, x, *, positions):
    h = L.apply_norm(cfg, lp, x, "ln_attn")
    out, _ = lp.attn(h, positions=positions, causal=False, window=0)
    x = x + out
    h = L.apply_norm(cfg, lp, x, "ln_mlp")
    return x + lp.mlp(h)

"""Transformer building blocks of the port: norms, RoPE, GQA attention (naive,
blockwise online-softmax, decode-with-cache, sliding-window), MLPs and top-k
MoE — the counterpart of ``repro.models.layers``.

The norms, RoPE and both attention forms are plain functions on tensors under
the JAX names.  Attention, the MLP and the MoE are ``nn.Module``s whose
parameters carry the JAX parameter tree's names and layouts (a weight is
(d_in, d_out), applied as ``x @ w``), so :mod:`repro_torch.models.convert`
copies a JAX tree leaf by leaf.  Compute dtype follows the inputs (bf16 in
the production configs); softmax and norm statistics are float32, and every
product that the JAX package takes with ``preferred_element_type=float32`` is
taken here on float32 operands, so its output is never rounded to bf16.

No library attention kernel: masks use ``NEG_INF`` (-1e30), not -inf, and
the blockwise form's online softmax runs in float32, as in the JAX package.
KV caches are updated in place (the JAX package returns new arrays).

Over DTensors (the dry run's mesh plans) both attention forms run on each
device's shards (:func:`per_device_attention`): attention is independent
per batch row and per KV-head group, as XLA's partitioner treats it, while
DTensor's own einsum rule would flatten a batch and a head dim that are
both sharded into one, which some torch releases refuse.
"""
from __future__ import annotations

import dataclasses
import functools
import sys

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import torch_dtype

NEG_INF = -1e30


class ParamInit:
    """Draws the initial weights on one device from one explicit generator:
    normal(0, 0.02) in the given dtype, as ``jax.nn.initializers.normal(0.02)``
    draws them in the JAX package.  Torch's stream is not JAX's PRNG, so the
    values differ from the JAX package's for the same seed; the distributions
    are the same.  On ``torch.device("meta")`` there is no generator and
    nothing is drawn: the parameters hold shapes and dtypes only."""

    def __init__(self, device: torch.device, seed: int):
        self.device = device
        # on "meta" (shapes only, the dry run's stand-ins) nothing is drawn
        self.generator = (None if device.type == "meta" else
                          torch.Generator(device=device).manual_seed(seed))

    def normal(self, shape, dtype) -> nn.Parameter:
        w = torch.empty(shape, dtype=dtype, device=self.device)
        if self.generator is None:
            return nn.Parameter(w)
        return nn.Parameter(w.normal_(0.0, 0.02, generator=self.generator))

    def full(self, shape, value, dtype) -> nn.Parameter:
        return nn.Parameter(torch.full(shape, value, dtype=dtype,
                                       device=self.device))


# --- norms --------------------------------------------------------------------


def _whole_rows(x):
    """x itself, or, for a DTensor holding partial sums (a row-parallel
    product's output, a lookup in a vocabulary-sharded table), x with them
    reduced: a norm reads whole rows, so its input is all-reduced there, as
    Megatron and XLA's partitioner place that all-reduce.  (DTensor would
    otherwise carry the partial sums through the norm's linear steps into
    the next product, and every device would then run that product whole.)"""
    dtensor = dtensor_type()
    if dtensor is None or not isinstance(x, dtensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def rmsnorm(x, weight):
    x = _whole_rows(x)
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + 1e-6)
    return (out * weight.float()).to(x.dtype)


def layernorm(x, weight, bias):
    x = _whole_rows(x)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)    # jnp.var: population
    out = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (out * weight.float() + bias.float()).to(x.dtype)


def layernorm_np(x):
    """OLMo's non-parametric LayerNorm (no weight/bias)."""
    x = _whole_rows(x)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)


class Norm(nn.Module):
    """A norm's parameters (JAX's ``norm_params``): rmsnorm a scale of ones,
    layernorm a scale and a bias of zeros, layernorm_np none."""

    def __init__(self, cfg, d: int, init: ParamInit):
        super().__init__()
        dt = torch_dtype(cfg)
        if cfg.norm in ("rmsnorm", "layernorm"):
            self.scale = init.full((d,), 1.0, dt)
        if cfg.norm == "layernorm":
            self.bias = init.full((d,), 0.0, dt)


def apply_norm(cfg, params, x, name: str):
    """The norm ``params.<name>`` (a :class:`Norm`) of ``cfg.norm`` on x."""
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, getattr(params, name).scale)
    if cfg.norm == "layernorm":
        norm = getattr(params, name)
        return layernorm(x, norm.scale, norm.bias)
    return layernorm_np(x)


# --- RoPE ---------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, Dh); positions: (B, S) integers."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)    # (Dh/2,)
    angles = positions[..., None].float() * freqs             # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- attention ----------------------------------------------------------------


def _group_q(q, hkv: int):
    """(B, S, Hq, Dh) -> (B, S, Hkv, G, Dh): query heads grouped per KV head,
    so GQA never materialises repeated K/V."""
    b, s, hq, dh = q.shape
    return q.reshape(b, s, hkv, hq // hkv, dh)


def update_slice(buf, new, index: int):
    """``jax.lax.dynamic_update_slice_in_dim(buf, new, index, axis=1)``, in
    place: an insert that would run past the end starts earlier so that it
    fits, as XLA clamps the start index.  An insert longer than the buffer
    raises, where the JAX package raises a TypeError while tracing."""
    n, size = new.shape[1], buf.shape[1]
    if n > size:
        raise ValueError(
            f"cannot insert {n} positions into a cache of {size}: the "
            f"sequence (with any modality prefix) is longer than the cache "
            f"(dynamic_update_slice of update shape {tuple(new.shape)} into "
            f"operand shape {tuple(buf.shape)})")
    start = min(max(int(index), 0), size - n)
    buf[:, start:start + n] = new.to(buf.dtype)
    return buf


def dtensor_type():
    """DTensor's class, or None while ``torch.distributed.tensor`` is not
    imported (then no tensor is one)."""
    return getattr(sys.modules.get("torch.distributed.tensor"), "DTensor",
                   None)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a DTensor made from
    a local shard states its global strides)."""
    return torch.empty(shape, device="meta").stride()


def per_device_attention(fn):
    """``fn(q, k, v, **kw)`` on plain tensors as it is; on DTensors, on each
    device's shards.  Per mesh dimension, a batch shard of q (dim 0) stays;
    otherwise the heads (dim 2) are sharded there when the query and the KV
    head counts both divide (each device keeps whole GQA groups), else the
    dimension is replicated.  q, k and v are brought to those placements
    (DTensor reduces a partial q, gathers a sequence-sharded cache), ``fn``
    runs on the local shards, and the output, of q's shape, keeps them."""
    @functools.wraps(fn)
    def wrapped(q, k, v, **kw):
        dtensor = dtensor_type()
        if dtensor is None or not isinstance(q, dtensor):
            return fn(q, k, v, **kw)
        from torch.distributed.tensor import Replicate, Shard
        mesh, target, cut = q.device_mesh, [], 1
        for dim, p in enumerate(q.placements):
            n = mesh.size(dim)
            if isinstance(p, Shard) and p.dim == 0:
                target.append(p)
            elif not (q.shape[2] % (cut * n) or k.shape[2] % (cut * n)):
                target.append(Shard(2))
                cut *= n
            else:
                target.append(Replicate())
        q, k, v = (t.redistribute(mesh, target) for t in (q, k, v))
        out = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
        # the local result may be a permuted view; the DTensor's metadata
        # says contiguous
        return dtensor.from_local(out.contiguous(), mesh, target,
                                  run_check=False, shape=q.shape,
                                  stride=contiguous_stride(q.shape))
    return wrapped


def embed_lookup(table, tokens):
    """``table[tokens]``, the embedding lookup (JAX's ``params["embed"]
    [tokens]``).  On a DTensor table it runs on each device's shards, as
    XLA partitions a gather: each device looks its tokens up in its own rows
    of the table (a table sharded over the vocabulary gives zeros for the
    rows it does not hold, so that mesh dimension's output is a partial
    sum), and the output keeps the tokens' placements elsewhere.  A mesh
    dimension that shards both the tokens and the table, or the table's
    vocabulary over more than one mesh dimension, raises."""
    dtensor = dtensor_type()
    if dtensor is None or not isinstance(table, dtensor):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    if not isinstance(tokens, dtensor):
        tokens = dtensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    out_placements, offset, vocab_dims = [], 0, 0
    coord = mesh.get_coordinate()
    for dim, (pt, pw) in enumerate(zip(tokens.placements, table.placements)):
        if pt.is_partial() or (pt.is_shard() and pw.is_shard()):
            raise NotImplementedError(
                f"embed_lookup over DTensors: tokens {tokens.placements}, "
                f"table {table.placements}")
        if pw.is_shard(0):
            vocab_dims += 1
            offset = coord[dim] * (table.shape[0] // mesh.size(dim))
            out_placements.append(Partial())
        elif pw.is_shard(1):
            out_placements.append(Shard(tokens.ndim))
        else:
            out_placements.append(pt)
    if vocab_dims > 1:
        raise NotImplementedError(
            f"embed_lookup over DTensors: the table {table.placements} "
            f"shards its vocabulary over more than one mesh dimension")
    rows = table.to_local()
    tok = tokens.to_local().long() - offset
    valid = (tok >= 0) & (tok < rows.shape[0])
    out = rows[tok.clamp(0, rows.shape[0] - 1)] * valid[..., None].to(
        rows.dtype)
    shape = (*tokens.shape, table.shape[1])
    return dtensor.from_local(out, mesh, out_placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


@per_device_attention
def naive_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0):
    """q: (B, Sq, Hq, Dh), k/v: (B, Skv, Hkv, Dh), Hkv | Hq (GQA grouped).
    Scores materialised in float32 — short sequences and decode;
    blockwise_attention covers long prefill."""
    hkv = k.shape[2]
    q5 = _group_q(q, hkv)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float()) * scale
    sq, skv = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    b, _, hq, dh = q.shape
    return out.reshape(b, sq, hq, dh).to(q.dtype)


@per_device_attention
def blockwise_attention(q, k, v, *, causal: bool, block: int = 1024,
                        window: int = 0):
    """Flash-style online-softmax attention: KV walked in blocks, O(S·block)
    score memory, GQA-grouped.  Exact (float32 running max/denominator); the
    JAX package's ``lax.scan`` over blocks is a loop here."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    skv = k.shape[1]
    n_blocks = -(-skv // block)
    pad = n_blocks * block - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = dh ** -0.5
    qf = _group_q(q, hkv).float()
    q_pos = torch.arange(sq, device=q.device)
    g = hq // hkv
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32,
                      device=q.device)
    m_run = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    for i in range(n_blocks):
        kblk = k[:, i * block:(i + 1) * block]
        vblk = v[:, i * block:(i + 1) * block]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, kblk.float()) * scale
        k_pos = i * block + torch.arange(block, device=q.device)
        mask = k_pos[None, :] < skv
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m_run, scores.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vblk.dtype).float(), vblk.float())
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    # (B, Hkv, G, Sq, Dh) -> (B, Sq, Hq, Dh)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return out.to(q.dtype)


class Attention(nn.Module):
    """GQA attention (JAX's ``attention_params`` / ``attention_forward``).
    ``cfg.gqa_repeat_kv`` (a baseline ablation of the TPU dry run) is not
    read: the grouped form gives the same result."""

    def __init__(self, cfg, init: ParamInit, d_model=None):
        super().__init__()
        self.cfg = cfg
        d = d_model or cfg.d_model
        q_dim, kv_dim = cfg.qkv_dims
        dt = torch_dtype(cfg)
        self.wq = init.normal((d, q_dim), dt)
        self.wk = init.normal((d, kv_dim), dt)
        self.wv = init.normal((d, kv_dim), dt)
        self.wo = init.normal((q_dim, d), dt)

    def forward(self, x, *, positions, causal=True, cache=None,
                cache_index=None, window=None, kv_override=None):
        """Returns (out, cache).

        cache: {"k", "v"} (B, max_len, Hkv, Dh), updated in place at
        cache_index.  kv_override: (k, v) for cross-attention (encoder
        outputs, pre-projected)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        window = cfg.attn_window if window is None else window
        q = (x @ self.wq).reshape(b, s, hq, dh)
        if kv_override is None:
            k = (x @ self.wk).reshape(b, s, hkv, dh)
            v = (x @ self.wv).reshape(b, s, hkv, dh)
            if cfg.rope:
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)
        else:
            k, v = kv_override
            if cfg.rope:
                q = apply_rope(q, positions, cfg.rope_theta)

        if cache is not None and kv_override is None:
            # decode / cached path: mask beyond cache_index + s
            k = update_slice(cache["k"], k, cache_index)
            v = update_slice(cache["v"], v, cache_index)
            out = naive_attention(q, k, v, causal=causal, window=window,
                                  q_offset=cache_index)
        elif s >= cfg.blockwise_attn_threshold:
            out = blockwise_attention(q, k, v, causal=causal,
                                      block=cfg.attn_block_size, window=window)
        else:
            out = naive_attention(q, k, v, causal=causal, window=window)
        return out.reshape(b, s, hq * dh) @ self.wo, cache


# --- MLP ----------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU (``wi_gate``, ``wi_up``, ``wo``) or GELU (``wi``, ``wo``); GELU
    is the tanh approximation, ``jax.nn.gelu``'s default."""

    def __init__(self, cfg, init: ParamInit, d_ff=None):
        super().__init__()
        self.cfg = cfg
        d, dff = cfg.d_model, d_ff or cfg.d_ff
        dt = torch_dtype(cfg)
        if cfg.activation == "swiglu":
            self.wi_gate = init.normal((d, dff), dt)
            self.wi_up = init.normal((d, dff), dt)
        else:
            self.wi = init.normal((d, dff), dt)
        self.wo = init.normal((dff, d), dt)

    def forward(self, x):
        if self.cfg.activation == "swiglu":
            return (F.silu(x @ self.wi_gate) * (x @ self.wi_up)) @ self.wo
        return F.gelu(x @ self.wi, approximate="tanh") @ self.wo


# --- MoE ----------------------------------------------------------------------


def _top_k(logits, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoE(nn.Module):
    """Capacity-based top-k MoE with scatter dispatch / gather combine
    (Switch semantics: overflowing tokens are dropped).  The router is
    float32 whatever the config's dtype; shared experts are a SwiGLU MLP."""

    def __init__(self, cfg, init: ParamInit):
        super().__init__()
        self.cfg = cfg
        d, dff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = torch_dtype(cfg)
        self.router = init.normal((d, e), torch.float32)
        self.wi_gate = init.normal((e, d, dff), dt)
        self.wi_up = init.normal((e, d, dff), dt)
        self.wo = init.normal((e, dff, d), dt)
        if cfg.n_shared_experts:
            self.shared = MLP(dataclasses.replace(cfg, activation="swiglu"),
                              init, d_ff=dff * cfg.n_shared_experts)

    def forward(self, x, *, capacity_factor: float | None = None):
        """Returns (out, aux), aux the float32 load-balancing loss."""
        cfg = self.cfg
        if capacity_factor is None:
            capacity_factor = cfg.moe_capacity_factor
        b, s, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        t = b * s
        xf = x.reshape(t, d)
        logits = xf.float() @ self.router                          # (T, E)
        topv, topi = _top_k(logits, k)                             # (T, K)
        gates = torch.softmax(topv, dim=-1)

        # aux load-balancing loss (Switch-style)
        probs = torch.softmax(logits, dim=-1)
        me = probs.mean(dim=0)
        assigned = F.one_hot(topi, e).float().sum(1)               # (T, E)
        ce = assigned.mean(dim=0) / k
        aux = e * torch.sum(me * ce)

        flat_e = topi.reshape(-1)                                  # (T·K,)
        flat_gate = gates.reshape(-1)
        flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
        onehot = F.one_hot(flat_e, e)                              # (T·K, E)
        pos = torch.cumsum(onehot, dim=0) - onehot
        pos_in_e = pos.gather(1, flat_e[:, None])[:, 0]
        capacity = max(4, int(t * k / e * capacity_factor + 0.999))
        keep = pos_in_e < capacity
        pos_c = torch.clamp(pos_in_e, max=capacity - 1)

        # dispatch: a kept token owns its slot; a dropped one adds zeros to
        # slot capacity - 1, so the accumulating scatter is exact in any order
        contrib = xf[flat_tok] * keep[:, None].to(x.dtype)
        buf = torch.zeros((e, capacity, d), dtype=x.dtype, device=x.device)
        buf.index_put_((flat_e, pos_c), contrib, accumulate=True)

        h = F.silu(torch.bmm(buf, self.wi_gate))                   # ecd,edf
        h = h * torch.bmm(buf, self.wi_up)
        y = torch.bmm(h, self.wo)                                  # (E, C, d)

        yk = y[flat_e, pos_c] * (flat_gate * keep).to(x.dtype)[:, None]
        # combine: JAX's scatter-add into zeros adds each token's K choices
        # in order; a loop over K keeps that order (and is deterministic)
        yk = yk.reshape(t, k, d)
        out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
        for j in range(k):
            out = out + yk[:, j]
        out = out.reshape(b, s, d)
        if cfg.n_shared_experts:
            out = out + self.shared(x)
        return out, aux

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

Over DTensors (the dry run's mesh plans) the ops DTensor's own rules
refuse run as regions on each device's shards, as XLA's partitioner
reshards where DTensor will not.  A projection sharded over ``model`` is
viewed as heads by :func:`split_heads`, gathered first where the head count
does not divide the shards.  Both attention forms run per device
(:func:`per_device_attention`): attention is independent per batch row and
per query head, so a device keeps whole GQA groups, or query heads of one
group with that group's KV head, or the whole; DTensor's einsum rule would
flatten a sharded batch and head dim into one, which some torch releases
refuse.  The MoE dispatch has no DTensor rule (``index_put_``): its
routed experts run per device (:func:`_moe_per_device`) and compute the
unsharded function.  The plain-tensor path is untouched by all of it.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import torch_dtype
from repro_torch.device import dtensor_type

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


class _WholeRowsGrad(torch.autograd.Function):
    """The identity, whose backward reduces a gradient that holds partial
    sums (Megatron's ``f``: identity forward, all-reduce backward)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _whole_rows(grad)


def _whole_rows_grad(out):
    """A norm's output, whose gradient is reduced where it holds partial
    sums.  The norm's output feeds products whose weights are sharded over
    ``model`` by columns (the Q/K/V projections, the MLP's input, the
    vocabulary head), so the gradient of their input comes back as a
    partial sum over ``model``.  Left so, it reaches the previous
    row-parallel product (``wo``), whose input gradient would take a
    partial-sum operand against a weight sharded by columns: DTensor then
    gathers the weight, the cheaper move by bytes, and every device runs
    that product whole.  Reduced here, as Megatron and XLA's partitioner
    reduce it, each device keeps its shard of the work.  A plain tensor,
    or one that needs no gradient, is returned as it is."""
    dtensor = dtensor_type()
    if (dtensor is None or not isinstance(out, dtensor)
            or not out.requires_grad):
        return out
    return _WholeRowsGrad.apply(out)


def rmsnorm(x, weight):
    x = _whole_rows(x)
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + 1e-6)
    return _whole_rows_grad((out * weight.float()).to(x.dtype))


def layernorm(x, weight, bias):
    x = _whole_rows(x)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)    # jnp.var: population
    out = (xf - mu) * torch.rsqrt(var + 1e-5)
    return _whole_rows_grad((out * weight.float() + bias.float()).to(x.dtype))


def layernorm_np(x):
    """OLMo's non-parametric LayerNorm (no weight/bias)."""
    x = _whole_rows(x)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return _whole_rows_grad(((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype))


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


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a DTensor made from
    a local shard states its global strides)."""
    return torch.empty(shape, device="meta").stride()


def from_local(local, mesh, placements, shape):
    """The DTensor of global ``shape`` (contiguous) on ``mesh`` at
    ``placements`` whose shard on this device is ``local``."""
    shape = torch.Size(shape)
    return dtensor_type().from_local(local, mesh, placements,
                                     run_check=False, shape=shape,
                                     stride=contiguous_stride(shape))


def _block_index(coord, dims, mesh) -> int:
    """The index of this device's shard of a tensor dim sharded over the
    mesh dimensions ``dims`` (in mesh order, the first major, as DTensor
    lays a dim over several mesh dimensions out)."""
    index = 0
    for dim in dims:
        index = index * mesh.size(dim) + coord[dim]
    return index


def per_device_attention(fn):
    """``fn(q, k, v, **kw)`` on plain tensors as it is; on DTensors, on each
    device's shards.  Per mesh dimension, a batch shard of q (dim 0) stays;
    otherwise the query heads (dim 2) are sharded there when they divide
    and each device's query heads then still make whole GQA groups (the KV
    heads are sharded with them) or lie in one group (the KV heads are
    replicated there, and each device attends with its group's KV head);
    else the dimension is replicated.  q, k and v are brought to those
    placements (DTensor reduces a partial q, gathers a sequence-sharded
    cache), ``fn`` runs on the local shards, and the output, of q's shape,
    keeps q's.  A replicated KV head that only some devices attend with
    gets its gradient as a partial sum there."""
    @functools.wraps(fn)
    def wrapped(q, k, v, **kw):
        dtensor = dtensor_type()
        if dtensor is None or not isinstance(q, dtensor):
            return fn(q, k, v, **kw)
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh, hq, hkv = q.device_mesh, q.shape[2], k.shape[2]
        group = hq // hkv
        # per mesh dim: (q's placement, k/v's, k/v's gradient's)
        plan, q_dims, kv_dims, q_cut, kv_cut = [], [], [], 1, 1
        for dim, p in enumerate(q.placements):
            n = mesh.size(dim)
            heads = hq % (q_cut * n) == 0
            if isinstance(p, Shard) and p.dim == 0:
                plan.append((p, p, p))
            elif heads and q_cut == kv_cut and hkv % (kv_cut * n) == 0:
                plan.append((Shard(2), Shard(2), Shard(2)))
                q_dims.append(dim)
                kv_dims.append(dim)
                q_cut, kv_cut = q_cut * n, kv_cut * n
            elif heads and group % (hq // (q_cut * n)) == 0:
                plan.append((Shard(2), Replicate(), Partial()))
                q_dims.append(dim)
                q_cut *= n
            else:
                plan.append((Replicate(), Replicate(), Replicate()))
        q_target, kv_target, kv_grad = (list(c) for c in zip(*plan))
        q = q.redistribute(mesh, q_target)
        k, v = (t.redistribute(mesh, kv_target) for t in (k, v))
        k_loc, v_loc = (t.to_local(grad_placements=kv_grad) for t in (k, v))
        if q_cut > kv_cut:
            # this device's query heads lie in one group: its KV head
            coord = mesh.get_coordinate()
            first = _block_index(coord, q_dims, mesh) * (hq // q_cut)
            head = first // group - _block_index(coord, kv_dims, mesh) * (
                hkv // kv_cut)
            k_loc = k_loc[:, :, head:head + 1]
            v_loc = v_loc[:, :, head:head + 1]
        out = fn(q.to_local(), k_loc, v_loc, **kw)
        # the local result may be a permuted view; the DTensor's metadata
        # says contiguous
        return from_local(out.contiguous(), mesh, q_target, q.shape)
    return wrapped


def split_heads(x, n_heads: int, d_head: int):
    """(B, S, n_heads·d_head) -> (B, S, n_heads, d_head): a projection
    viewed as heads.  On a DTensor, per mesh dimension, a shard of the
    projection's columns stays a shard of the heads where the head count
    divides it (each device holds whole heads), and is gathered first
    where it does not (an all-gather of the projection); a batch shard or a
    partial sum stays as it is."""
    dtensor = dtensor_type()
    b, s = x.shape[:2]
    if dtensor is None or not isinstance(x, dtensor):
        return x.reshape(b, s, n_heads, d_head)
    from torch.distributed.tensor import Replicate
    mesh, last, cut, target = x.device_mesh, x.ndim - 1, 1, []
    for dim, p in enumerate(x.placements):
        if p.is_shard(last) and n_heads % (cut * mesh.size(dim)):
            p = Replicate()
        elif p.is_shard(last):
            cut *= mesh.size(dim)
        target.append(p)
    x = x.redistribute(mesh, target)
    local = x.to_local()
    local = local.reshape(*local.shape[:2], n_heads // cut, d_head)
    return from_local(local, mesh, target, (b, s, n_heads, d_head))


def merge_heads(x):
    """(B, S, H, Dh) -> (B, S, H·Dh) (or any (B, S, ...) to (B, S, -1)),
    the attention output before ``wo``.  On a DTensor it runs on each
    device's shards (a shard of dim 2 is a shard of the merged columns; a
    shard of a later dim is gathered first), so its gradient, which comes
    back from ``wo`` as a column shard, is brought to the heads'
    placements (gathered where the heads are replicated) instead of split
    into heads that do not divide it."""
    b, s = x.shape[:2]
    dtensor = dtensor_type()
    if dtensor is None or not isinstance(x, dtensor):
        return x.reshape(b, s, -1)
    from torch.distributed.tensor import Replicate
    target = [Replicate() if p.is_shard() and p.dim > 2 else p
              for p in x.placements]
    x = x.redistribute(x.device_mesh, target)
    local = x.to_local()
    return from_local(local.reshape(*local.shape[:2], -1), x.device_mesh,
                      target, (b, s, math.prod(x.shape[2:])))


def shard_like(t, ref):
    """The plain tensor ``t``, of ``ref``'s global shape, as a DTensor at
    ``ref``'s placements, which shard dim 0 or nothing: each device keeps
    its rows, nothing is sent."""
    mesh = ref.device_mesh
    if any(p.is_partial() or (p.is_shard() and not p.is_shard(0))
           for p in ref.placements):
        raise NotImplementedError(f"shard_like at {ref.placements}")
    dims = [dim for dim, p in enumerate(ref.placements) if p.is_shard(0)]
    rows = t.shape[0] // math.prod(mesh.size(dim) for dim in dims)
    first = _block_index(mesh.get_coordinate(), dims, mesh) * rows
    return from_local(t[first:first + rows], mesh, ref.placements, t.shape)


def embed_lookup(table, tokens):
    """``table[tokens]``, the embedding lookup (JAX's ``params["embed"]
    [tokens]``).  On a DTensor table it runs on each device's shards, as
    XLA partitions a gather: each device looks its tokens up in its own rows
    of the table (a table sharded over the vocabulary gives zeros for the
    rows it does not hold, so that mesh dimension's output is a partial
    sum), and the output keeps the tokens' placements elsewhere; the
    table's gradient is a partial sum over the dims that shard the tokens.
    A mesh dimension that shards both the tokens and the table, or the
    table's vocabulary over more than one mesh dimension, raises."""
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
    # a mesh dim that shards the tokens looks up different rows on each
    # device: the table's gradient is a partial sum there
    rows = table.to_local(grad_placements=[
        Partial() if pt.is_shard() else pw
        for pt, pw in zip(tokens.placements, table.placements)])
    tok = tokens.to_local().long() - offset
    valid = (tok >= 0) & (tok < rows.shape[0])
    out = rows[tok.clamp(0, rows.shape[0] - 1)] * valid[..., None].to(
        rows.dtype)
    return from_local(out, mesh, out_placements,
                      (*tokens.shape, table.shape[1]))


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


def repeat_kv(k, n_rep: int):
    """(B, S, Hkv, Dh) -> (B, S, Hkv·n_rep, Dh), each KV head repeated
    ``n_rep`` times in place (JAX's ``_repeat_kv``).  On a DTensor it runs
    on each device's shards: a shard of the KV heads is a shard of the
    repeated heads, and a shard of another dim stays."""
    if n_rep == 1:
        return k
    dtensor = dtensor_type()
    if dtensor is not None and isinstance(k, dtensor):
        local = repeat_kv(k.to_local(), n_rep)
        b, s, h, d = k.shape
        return from_local(local, k.device_mesh, k.placements,
                          (b, s, h * n_rep, d))
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


class Attention(nn.Module):
    """GQA attention (JAX's ``attention_params`` / ``attention_forward``).
    With ``cfg.gqa_repeat_kv`` (the TPU dry run's baseline ablation) the KV
    heads are repeated to the query heads' count before attention, as JAX
    materialises them (:func:`repeat_kv`): the output and the gradients
    are the grouped form's, and the dry run's record prices the
    materialised KV."""

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
        s = x.shape[1]
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        window = cfg.attn_window if window is None else window
        q = split_heads(x @ self.wq, hq, dh)
        if kv_override is None:
            k = split_heads(x @ self.wk, hkv, dh)
            v = split_heads(x @ self.wv, hkv, dh)
            if cfg.rope:
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)
        else:
            k, v = kv_override
            if cfg.rope:
                q = apply_rope(q, positions, cfg.rope_theta)

        if cache is not None and kv_override is None:
            k = update_slice(cache["k"], k, cache_index)
            v = update_slice(cache["v"], v, cache_index)
        if cfg.gqa_repeat_kv:
            k, v = repeat_kv(k, hq // hkv), repeat_kv(v, hq // hkv)
        if cache is not None and kv_override is None:
            # decode / cached path: mask beyond cache_index + s
            out = naive_attention(q, k, v, causal=causal, window=window,
                                  q_offset=cache_index)
        elif s >= cfg.blockwise_attn_threshold:
            out = blockwise_attention(q, k, v, causal=causal,
                                      block=cfg.attn_block_size, window=window)
        else:
            out = naive_attention(q, k, v, causal=causal, window=window)
        return merge_heads(out) @ self.wo, cache


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


def _slots(onehot, flat_e, capacity: int, offset=None):
    """(keep, slot) of each choice: its position among the choices of its
    expert in token order (after ``offset[e]`` earlier ones), kept below
    the capacity, the slot clamped to the last."""
    pos = torch.cumsum(onehot, dim=0) - onehot
    if offset is not None:
        pos = pos + offset[None]
    pos_in_e = pos.gather(1, flat_e[:, None])[:, 0]
    return pos_in_e < capacity, torch.clamp(pos_in_e, max=capacity - 1)


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
        dtensor = dtensor_type()
        if dtensor is not None and isinstance(x, dtensor):
            out, aux = _moe_per_device(self, x, capacity_factor)
            if cfg.n_shared_experts:
                out = out + self.shared(x)
            return out, aux
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
        capacity = max(4, int(t * k / e * capacity_factor + 0.999))
        keep, pos_c = _slots(onehot, flat_e, capacity)

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


def _moe_per_device(moe, x, capacity_factor: float):
    """:meth:`MoE.forward`'s routed experts on DTensors, on each device's
    shards, computing the unsharded function: the capacity comes from the
    global token count, and each choice's slot is its position in the
    global token order (batch shards are contiguous runs of it), so the
    same tokens are kept and dropped.  Per device: route its tokens; gather
    every batch shard's count per expert (an E-vector each) to offset its
    positions; scatter its kept choices for the experts it holds into an
    (E_local, C, d) buffer, a partial sum over the batch shards, which is
    reduced over them (scattered over the capacity slots where they divide
    it, else whole); run its experts (its own under expert parallelism,
    its d_ff slice of every one under ``MOE_ALT``, all of them replicated);
    gather the slots back, pick its choices' rows and sum each token's K
    choices over the devices holding their experts, in order.  The
    load-balancing loss sums its means over the batch shards.  Returns
    (out without the shared experts, aux)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    cfg = moe.cfg
    mesh = x.device_mesh
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    capacity = max(4, int(t * k / e * capacity_factor + 0.999))
    coord = mesh.get_coordinate()
    x_target = [p if p.is_shard(0) else Replicate() for p in x.placements]
    batch = [dim for dim, p in enumerate(x_target) if p.is_shard(0)]
    # the mesh dims that split the experts' weights (experts or d_ff)
    split = [dim for dim, p in enumerate(moe.wi_gate.placements)
             if p.is_shard()]
    ep = [dim for dim in split if moe.wi_gate.placements[dim].is_shard(0)]
    e_loc = e // math.prod(mesh.size(dim) for dim in ep)
    e0 = _block_index(coord, ep, mesh) * e_loc
    slots, cut = [], 1                  # batch dims that split the slots
    for dim in batch:
        if capacity % (cut * mesh.size(dim)) == 0:
            slots.append(dim)
            cut *= mesh.size(dim)
    whole = [Replicate()] * mesh.ndim
    # a token's value on the devices that split the experts: a partial sum
    per_token = [Partial() if dim in split else p
                 for dim, p in enumerate(x_target)]

    x = x.redistribute(mesh, x_target)
    logits = x.float() @ moe.router                              # (T, E)
    x_loc = x.to_local(grad_placements=per_token)
    b_loc = x_loc.shape[0]
    t_loc = b_loc * s
    xf = x_loc.reshape(t_loc, d)
    topv, topi = _top_k(logits.to_local(grad_placements=per_token).reshape(
        t_loc, e), k)
    gates = torch.softmax(topv, dim=-1)

    def total(local):
        """The sum over the batch shards of a local (E,) sum, replicated."""
        return from_local(local, mesh, [
            Partial() if dim in batch else Replicate()
            for dim in range(mesh.ndim)], local.shape).redistribute(
                mesh, whole)

    # aux load-balancing loss (Switch-style), from the global means
    probs = torch.softmax(logits.to_local().reshape(t_loc, e), dim=-1)
    me = total(probs.sum(dim=0)) / t
    assigned = F.one_hot(topi, e).float().sum(1)                  # (T, E)
    ce = total(assigned.sum(dim=0)) / t / k
    aux = e * torch.sum(me * ce)

    flat_e = topi.reshape(-1)                                     # (T·K,)
    flat_gate = gates.reshape(-1)
    flat_tok = torch.arange(t_loc, device=xf.device).repeat_interleave(k)
    onehot = F.one_hot(flat_e, e)                                 # (T·K, E)
    # the counts of the batch shards before this one offset its positions
    counts = from_local(onehot.sum(dim=0)[None], mesh, x_target, (
        math.prod(mesh.size(dim) for dim in batch), e))
    counts = counts.redistribute(mesh, whole).to_local()
    keep, pos_c = _slots(onehot, flat_e, capacity, offset=counts[
        :_block_index(coord, batch, mesh)].sum(dim=0))
    mine = keep & (flat_e >= e0) & (flat_e < e0 + e_loc)
    e_c = torch.clamp(flat_e - e0, 0, e_loc - 1)

    # dispatch: this device's kept choices for its experts; the others add
    # zeros, so the accumulating scatter is exact in any order
    contrib = xf[flat_tok] * mine[:, None].to(x_loc.dtype)
    buf = torch.zeros((e_loc, capacity, d), dtype=x_loc.dtype,
                      device=xf.device)
    buf.index_put_((e_c, pos_c), contrib, accumulate=True)
    expert = [Shard(0) if dim in ep else Replicate()
              for dim in range(mesh.ndim)]
    buf = from_local(buf, mesh, [Partial() if dim in batch else p
                                 for dim, p in enumerate(expert)],
                     (e, capacity, d))
    at_slots = [Shard(1) if dim in slots else p
                for dim, p in enumerate(expert)]
    buf = buf.redistribute(mesh, at_slots).to_local()

    def weight(w):
        """The local shard of an expert weight, its gradient a partial sum
        over the dims that split the slots."""
        w = w.redistribute(mesh, [p if dim in split else Replicate()
                                  for dim, p in enumerate(w.placements)])
        return w.to_local(grad_placements=[
            Partial() if dim in slots else p
            for dim, p in enumerate(w.placements)])

    h = F.silu(torch.bmm(buf, weight(moe.wi_gate)))
    h = h * torch.bmm(buf, weight(moe.wi_up))
    y = torch.bmm(h, weight(moe.wo))                   # (E_loc, C_loc, d)
    y = from_local(y, mesh, [Partial() if dim in split and dim not in ep
                             else p for dim, p in enumerate(at_slots)],
                   (e, capacity, d))
    gathered = [Replicate() if dim in batch else p
                for dim, p in enumerate(y.placements)]
    # the gradient of d_ff shards' partial sums is each shard's whole; of
    # the rows each device picks for its own tokens, a partial sum
    y = y.redistribute(mesh, gathered).to_local(grad_placements=[
        Partial() if dim in batch else Replicate() if p.is_partial() else p
        for dim, p in enumerate(gathered)])

    # combine: each choice's row is held by the devices of its expert; the
    # K choices are summed over them, then added in order, as unsharded
    yk = y[e_c, pos_c] * (flat_gate * mine).to(x_loc.dtype)[:, None]
    yk = from_local(yk.reshape(t_loc, k, d), mesh, per_token, (t, k, d))
    yk = yk.redistribute(mesh, x_target).to_local()
    out = torch.zeros((t_loc, d), dtype=x_loc.dtype, device=xf.device)
    for j in range(k):
        out = out + yk[:, j]
    return from_local(out.reshape(b_loc, s, d), mesh, x_target,
                      x.shape), aux

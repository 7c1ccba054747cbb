"""Mamba-2 SSD (state-space duality) block — chunked dual form + O(1)
single-token decode state update [arXiv:2405.21060]; the counterpart of
``repro.models.ssm``.

Scalar-per-head decay A (SSD restriction), H heads with head dim P and state
size N:    h_t = a_t · h_{t-1} + B_t ⊗ (Δ_t x_t) ;   y_t = C_t · h_t + D x_t.

The chunked dual form: intra-chunk quadratic term (L ∘ C Bᵀ)(Δx) with
L[t,u] = Π_{u<v≤t} a_v, inter-chunk contribution from the running state,
carried chunk by chunk (the JAX package's ``lax.scan`` is a loop here).
The state is float32 whatever the config's dtype.  Over DTensors (the dry
run's mesh plans) the block runs on each device's shards
(:func:`_ssd_per_device`), as attention does: DTensor's einsum rule would
flatten a sharded batch and head dim into one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import torch_dtype
from repro_torch.models import layers as L


class SSD(nn.Module):
    """The SSD block's parameters (JAX's ``ssm_params``): ``in_proj`` (x and
    gate z), ``bc_proj`` (B, C per head), ``dt_proj`` (per-head Δ logits),
    ``a_log`` (A = -exp(a_log), float32 zeros), ``d_skip`` (float32 ones) and
    ``out_proj``."""

    def __init__(self, cfg, init: L.ParamInit, d_model=None):
        super().__init__()
        self.cfg = cfg
        d = d_model or cfg.d_model
        h = cfg.ssm_heads
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state
        dt = torch_dtype(cfg)
        self.in_proj = init.normal((d, 2 * d_in), dt)
        self.bc_proj = init.normal((d, 2 * n * h), dt)
        self.dt_proj = init.normal((d, h), dt)
        self.a_log = init.full((h,), 0.0, torch.float32)
        self.d_skip = init.full((h,), 1.0, torch.float32)
        self.out_proj = init.normal((d_in, d), dt)

    def forward(self, x, *, state=None):
        return ssd_forward(self.cfg, self, x, state=state)


def init_ssm_state(cfg, batch: int, d_model: int | None = None,
                   dtype=torch.float32, device=None):
    d = d_model or cfg.d_model
    p = cfg.ssm_expand * d // cfg.ssm_heads
    return torch.zeros((batch, cfg.ssm_heads, p, cfg.ssm_state), dtype=dtype,
                       device=device)


def _project(cfg, params, x):
    """The shared prologue: (xh, z, B, C, Δ, log a) in float32 but z."""
    xs, z = (x @ params.in_proj).chunk(2, dim=-1)          # (B,S,d_in) each
    b_mat, c_mat = (x @ params.bc_proj).chunk(2, dim=-1)
    return _split(cfg.ssm_heads, cfg.ssm_state, x, xs, z, b_mat, c_mat,
                  params.dt_proj, params.a_log)


def _split(h, n, x, xs, z, b_mat, c_mat, dt_proj, a_log):
    """The prologue's projections viewed as h heads of state size n."""
    b, s, _ = x.shape
    p = xs.shape[-1] // h
    b_mat = b_mat.reshape(b, s, h, n).float()
    c_mat = c_mat.reshape(b, s, h, n).float()
    xh = xs.reshape(b, s, h, p).float()
    dt = F.softplus(x.float() @ dt_proj.float())
    log_a = dt * -torch.exp(a_log)                         # (B,S,H) ≤ 0
    return xh, z, b_mat, c_mat, dt, log_a


def _gate_out(params, y, z, x):
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params.out_proj


def ssd_forward(cfg, params, x, *, state=None):
    """x: (B, S, d) -> (y (B, S, d), new_state (B, H, P, N)).  Over
    DTensors it runs on each device's shards (:func:`_ssd_per_device`)."""
    dtensor = L.dtensor_type()
    if dtensor is not None and isinstance(x, dtensor):
        return _ssd_per_device(cfg, params, x, state)
    b, s, d = x.shape
    xh, z, b_mat, c_mat, dt, log_a = _project(cfg, params, x)
    y, new_state = _ssd(cfg, xh, b_mat, c_mat, dt, log_a, params.d_skip,
                        state)
    return _gate_out(params, y.reshape(b, -1, cfg.ssm_expand * d), z,
                     x), new_state


def _ssd(cfg, xh, b_mat, c_mat, dt, log_a, d_skip, state):
    """The scan over the prologue's heads: (y (B, S, H, P), new state)."""
    b, s, h, p = xh.shape
    n = b_mat.shape[-1]
    xdt = xh * dt[..., None]                               # (B,S,H,P)

    if state is None:
        state = torch.zeros((b, h, p, n), dtype=torch.float32,
                            device=xh.device)

    if s == 1:
        a1 = torch.exp(log_a[:, 0])                        # (B,H)
        bx = b_mat[:, 0, :, None, :] * xdt[:, 0, :, :, None]  # (B,H,P,N)
        new_state = state * a1[:, :, None, None] + bx
        y = torch.einsum("bhpn,bhn->bhp", new_state, c_mat[:, 0])
        y = y + d_skip[None, :, None] * xh[:, 0]
        y = y[:, None]                                     # (B,1,H,P)
    else:
        chunk = min(cfg.ssm_chunk, s)
        if s % chunk:
            chunk = s  # ragged sequence: single-chunk fallback (quadratic)
        nc = s // chunk
        la_c = log_a.reshape(b, nc, chunk, h)
        b_c = b_mat.reshape(b, nc, chunk, h, n)
        c_c = c_mat.reshape(b, nc, chunk, h, n)
        xdt_c = xdt.reshape(b, nc, chunk, h, p)
        cum = torch.cumsum(la_c, dim=2)                    # inclusive (B,NC,T,H)

        # intra-chunk: y[t] = Σ_{u<=t} exp(cum_t - cum_u) (C_t·B_u) Δx_u
        scores = torch.einsum("bgthn,bguhn->bgtuh", c_c, b_c)
        li = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                    device=xh.device))
        # the exponent is masked, not its value: exp of the upper triangle
        # (li ≥ 0) can overflow, and 0·inf in the backward pass is NaN
        l_mat = torch.exp(torch.where(tri[None, None, :, :, None], li,
                                      float("-inf")))
        y_intra = torch.einsum("bgtuh,bguhp->bgthp", scores * l_mat, xdt_c)

        # end-of-chunk states: Σ_u exp(cum_T - cum_u) B_u ⊗ Δx_u
        total = cum[:, :, -1, :]                           # (B,NC,H)
        dec_end = torch.exp(total[:, :, None, :] - cum)    # (B,NC,T,H)
        chunk_state = torch.einsum("bgth,bgthn,bgthp->bghpn",
                                   dec_end, b_c, xdt_c)

        new_state = state
        y_inter = []
        for g in range(nc):
            dec0 = torch.exp(cum[:, g])                    # (B,T,H)
            y_inter.append(torch.einsum("bthn,bhpn,bth->bthp",
                                        c_c[:, g], new_state, dec0))
            new_state = (new_state * torch.exp(total[:, g])[:, :, None, None]
                         + chunk_state[:, g])
        y = (y_intra + torch.stack(y_inter, dim=1)
             + d_skip[None, None, None, :, None]
             * xh.reshape(b, nc, chunk, h, p))
        y = y.reshape(b, s, h, p)

    return y, new_state


def _ssd_per_device(cfg, params, x, state):
    """:func:`ssd_forward` on DTensors, on each device's shards, as
    :func:`repro_torch.models.layers.per_device_attention` runs attention:
    per mesh dimension a batch shard of x stays; over ``model`` the SSD
    heads are sharded where ``cfg.ssm_heads`` divides its size, else
    replicated; elsewhere x is replicated.  Each device projects x onto
    its heads' columns of ``in_proj`` (x and the gate z) and ``bc_proj``
    (B and C): it gathers the weight, or the product when that is smaller
    (fewer tokens on the device than ``d_model``).  The state is brought
    to the batch shards and the heads' placement (``cache_spec``'s: heads
    over ``model``) and comes back there; the output is a partial sum over
    ``model`` where the rows of ``out_proj`` are split there, and keeps
    the batch shards.  A replicated input that devices use differently
    gets its gradient as a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    h, n = cfg.ssm_heads, cfg.ssm_state
    b, s, d = x.shape
    d_in = cfg.ssm_expand * d
    p = d_in // h
    names = mesh.mesh_dim_names or ()
    model = names.index("model") if "model" in names else None
    split = model is not None and h % mesh.size(model) == 0
    # out_proj's rows split over model: each device gates and projects
    # its rows' columns of y
    rows = (model is not None
            and params.out_proj.placements[model].is_shard(0))
    coord = mesh.get_coordinate()
    x_target, differs = [], []
    for dim, pl in enumerate(x.placements):
        batch = isinstance(pl, Shard) and pl.dim == 0
        x_target.append(pl if batch else Replicate())
        differs.append(batch or ((split or rows) and dim == model))
    h0, h1 = 0, h
    if split:
        h0 = coord[model] * h // mesh.size(model)
        h1 = h0 + h // mesh.size(model)

    def grads(placements):
        """A used-differently replicated input's gradient placements."""
        return [Partial() if diff and not pl.is_shard() else pl
                for pl, diff in zip(placements, differs)]

    x = x.redistribute(mesh, x_target)
    x_loc = x.to_local(grad_placements=grads(x_target))
    tokens = x_loc.shape[0] * x_loc.shape[1]

    def columns(w, spans):
        """x_loc @ w[:, spans], the spans' columns side by side: the
        product gathered where the device holds fewer tokens than ``w`` has
        rows, else the weight."""
        if tokens < w.shape[0]:
            y = (x @ w).redistribute(mesh, x_target)
            y = y.to_local(grad_placements=grads(x_target))
            return torch.cat([y[..., lo:hi] for lo, hi in spans], dim=-1)
        full = [Replicate()] * mesh.ndim
        w = w.redistribute(mesh, full).to_local(grad_placements=grads(full))
        return x_loc @ torch.cat([w[:, lo:hi] for lo, hi in spans], dim=1)

    def whole(t):
        full = [Replicate()] * mesh.ndim
        return t.redistribute(mesh, full).to_local(grad_placements=grads(
            full))

    xs, z = columns(params.in_proj, [(h0 * p, h1 * p),
                                     (d_in + h0 * p, d_in + h1 * p)]).chunk(
        2, dim=-1)
    b_mat, c_mat = columns(params.bc_proj, [(h0 * n, h1 * n),
                                            (h * n + h0 * n,
                                             h * n + h1 * n)]).chunk(2, dim=-1)
    xh, z, b_mat, c_mat, dt, log_a = _split(
        h1 - h0, n, x_loc, xs, z, b_mat, c_mat,
        whole(params.dt_proj)[:, h0:h1], whole(params.a_log)[h0:h1])
    state_target = [pl if pl.is_shard() else (
        Shard(1) if split and dim == model else Replicate())
        for dim, pl in enumerate(x_target)]
    if state is not None:
        state = state.redistribute(mesh, state_target).to_local()
    y, new_state = _ssd(cfg, xh, b_mat, c_mat, dt, log_a,
                        whole(params.d_skip)[h0:h1], state)
    y = y.reshape(*y.shape[:2], -1)

    # out_proj: this device's rows (its shard over model, or its heads')
    wo = params.out_proj
    wo_target = [Shard(0) if rows and dim == model else Replicate()
                 for dim in range(mesh.ndim)]
    wo_loc = wo.redistribute(mesh, wo_target).to_local(
        grad_placements=grads(wo_target))
    if rows and not split:
        lo, hi = (coord[model] * wo_loc.shape[0],
                  (coord[model] + 1) * wo_loc.shape[0])
        y, z = y[..., lo:hi], z[..., lo:hi]
    elif not rows:
        wo_loc = wo_loc[h0 * p:h1 * p]
    out = (y * F.silu(z.float())).to(x.dtype) @ wo_loc
    out_placements = [Partial() if dim == model and (rows or split) else pl
                      for dim, pl in enumerate(x_target)]
    return (L.from_local(out, mesh, out_placements, x.shape),
            L.from_local(new_state, mesh, state_target, (b, h, p, n)))


# --- reference: naive sequential recurrence (oracle for tests) -----------------


def ssd_reference(cfg, params, x, *, state=None):
    """Step-by-step recurrence — O(S) sequential, used as the test oracle."""
    b, s, d = x.shape
    h = cfg.ssm_heads
    d_in = cfg.ssm_expand * d
    p = d_in // h
    n = cfg.ssm_state
    xh, z, b_mat, c_mat, dt, log_a = _project(cfg, params, x)
    a_t = torch.exp(log_a)
    st = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if state is None else state)
    ys = []
    for i in range(s):
        bx = b_mat[:, i, :, None, :] * (xh[:, i] * dt[:, i, :, None])[..., None]
        st = st * a_t[:, i, :, None, None] + bx
        ys.append(torch.einsum("bhpn,bhn->bhp", st, c_mat[:, i]))
    ys = torch.stack(ys, dim=1) + params.d_skip[None, None, :, None] * xh
    return _gate_out(params, ys.reshape(b, s, d_in), z, x), st

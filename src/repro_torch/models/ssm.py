"""Mamba-2 SSD (state-space duality) block — chunked dual form + O(1)
single-token decode state update [arXiv:2405.21060]; the counterpart of
``repro.models.ssm``.

Scalar-per-head decay A (SSD restriction), H heads with head dim P and state
size N:    h_t = a_t · h_{t-1} + B_t ⊗ (Δ_t x_t) ;   y_t = C_t · h_t + D x_t.

The chunked dual form: intra-chunk quadratic term (L ∘ C Bᵀ)(Δx) with
L[t,u] = Π_{u<v≤t} a_v, inter-chunk contribution from the running state,
carried chunk by chunk (the JAX package's ``lax.scan`` is a loop here).
The state is float32 whatever the config's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import torch_dtype
from repro_torch.models.layers import ParamInit


class SSD(nn.Module):
    """The SSD block's parameters (JAX's ``ssm_params``): ``in_proj`` (x and
    gate z), ``bc_proj`` (B, C per head), ``dt_proj`` (per-head Δ logits),
    ``a_log`` (A = -exp(a_log), float32 zeros), ``d_skip`` (float32 ones) and
    ``out_proj``."""

    def __init__(self, cfg, init: ParamInit, d_model=None):
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
    b, s, d = x.shape
    h = cfg.ssm_heads
    p = cfg.ssm_expand * d // h
    n = cfg.ssm_state
    xs, z = (x @ params.in_proj).chunk(2, dim=-1)          # (B,S,d_in) each
    b_mat, c_mat = (x @ params.bc_proj).chunk(2, dim=-1)
    b_mat = b_mat.reshape(b, s, h, n).float()
    c_mat = c_mat.reshape(b, s, h, n).float()
    xh = xs.reshape(b, s, h, p).float()
    dt = F.softplus(x.float() @ params.dt_proj.float())
    log_a = dt * -torch.exp(params.a_log)                  # (B,S,H) ≤ 0
    return xh, z, b_mat, c_mat, dt, log_a


def _gate_out(params, y, z, x):
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params.out_proj


def ssd_forward(cfg, params, x, *, state=None):
    """x: (B, S, d) -> (y (B, S, d), new_state (B, H, P, N))."""
    b, s, d = x.shape
    h = cfg.ssm_heads
    d_in = cfg.ssm_expand * d
    p = d_in // h
    n = cfg.ssm_state
    xh, z, b_mat, c_mat, dt, log_a = _project(cfg, params, x)
    xdt = xh * dt[..., None]                               # (B,S,H,P)

    if state is None:
        state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)

    if s == 1:
        a1 = torch.exp(log_a[:, 0])                        # (B,H)
        bx = b_mat[:, 0, :, None, :] * xdt[:, 0, :, :, None]  # (B,H,P,N)
        new_state = state * a1[:, :, None, None] + bx
        y = torch.einsum("bhpn,bhn->bhp", new_state, c_mat[:, 0])
        y = y + params.d_skip[None, :, None] * xh[:, 0]
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
                                    device=x.device))
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
             + params.d_skip[None, None, None, :, None]
             * xh.reshape(b, nc, chunk, h, p))
        y = y.reshape(b, s, h, p)

    return _gate_out(params, y.reshape(b, -1, d_in), z, x), new_state


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

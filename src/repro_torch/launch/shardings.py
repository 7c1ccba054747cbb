"""Logical sharding rules: tree-path pattern → partition spec with
divisibility fallback — the counterpart of ``repro.launch.shardings``, whose
rule table and rules are copied here.

TP over "model" (attention heads / d_ff / vocab / experts), DP over
("pod", "data"), SP (sequence sharding) over "data" for the long-context
decode caches.  Any dim that does not divide its mesh axes falls back to
replication for that dim — e.g. StarCoder2's 36 query heads or Granite's
49,155-entry vocab under model=16 (recorded by ``fallbacks``).

Layout.  The JAX tree stacks each per-layer leaf on a leading ``n_layers``
axis; the port keeps one module per layer (``layers.3.attn.wq`` of shape
(d, q) is row 3 of JAX's ``layers/attn/wq`` of shape (L, d, q)), and its
decode cache is a list of per-layer dicts of JAX's per-layer shapes.  The
tree helpers map each port name to its JAX path and stacked shape, apply
the JAX rule once per JAX leaf, in JAX's leaf order (sorted keys), and drop
the leading layer entry.  So one rule table serves both layouts, and
``fallbacks`` names the same paths in the same order as JAX's.

:func:`placements` turns a spec into the ``Shard`` / ``Replicate`` of a
DTensor per mesh dimension.
"""
from __future__ import annotations

import math
import re

from torch import nn

# (path regex, per-dim logical axes measured from the *last* dims of the leaf)
# Leading stacked axes (layer stack) are padded with None automatically.
PARAM_RULES: list[tuple[str, tuple]] = [
    (r"(^|/)embed$",        (("model",), None)),            # (vocab, d)
    (r"pos_embed$",         (None, None)),
    (r"lm_head$",           (None, ("model",))),            # (d, vocab)
    (r"attn/w[qkv]$",       (None, ("model",))),
    (r"attn/wo$",           (("model",), None)),
    (r"cross/w[qkv]$",      (None, ("model",))),
    (r"cross/wo$",          (("model",), None)),
    (r"mlp/wi(_gate|_up)?$", (None, ("model",))),
    (r"mlp/wo$",            (("model",), None)),
    (r"moe/router$",        (None, None)),
    (r"moe/wi(_gate|_up)$", (("model",), None, None)),      # (E, d, ff) — EP
    (r"moe/wo$",            (("model",), None, None)),
    (r"shared/wi(_gate|_up)$", (None, ("model",))),
    (r"shared/wo$",         (("model",), None)),
    (r"ssm/in_proj$",       (None, ("model",))),
    (r"ssm/bc_proj$",       (None, ("model",))),
    (r"ssm/dt_proj$",       (None, None)),
    (r"ssm/out_proj$",      (("model",), None)),
    (r"ssm/(a_log|d_skip)$", (None,)),
    (r"(ln_|norm)",         None),                          # replicate norms
]

# fallback alternatives tried per rule when the primary axis does not divide
MOE_ALT = {r"moe/wi(_gate|_up)$": (None, None, ("model",)),
           r"moe/wo$": (None, ("model",), None)}

# the port's per-layer module lists, JAX's stacked subtrees
STACKED = ("layers", "enc_layers")


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``): one entry per
    tensor dim, None, an axis name, or a tuple of axis names.  A tuple, so
    ``tuple(jax_spec) == tuple(port_spec)`` compares the two packages'."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def jax_path(name: str) -> str:
    """The JAX tree path of a port name: ``layers.3.attn.wq`` →
    ``layers/attn/wq``."""
    parts = name.split(".")
    if parts[0] in STACKED:
        del parts[1]
    return "/".join(parts)


def _named(tree) -> dict:
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def _stacked(named: dict) -> dict:
    """JAX path → (stacked shape, the port names of its rows), in JAX's
    leaf order.  The layer count of a stacked subtree is the highest index
    the names hold, plus one."""
    counts = {}
    for name in named:
        parts = name.split(".")
        if parts[0] in STACKED:
            counts[parts[0]] = max(counts.get(parts[0], 0), int(parts[1]) + 1)
    out = {}
    for name, t in named.items():
        top = name.split(".")[0]
        shape = tuple(t.shape)
        path = jax_path(name)
        if top in STACKED:
            shape = (counts[top],) + shape
        entry = out.setdefault(path, (shape, []))
        if entry[0] != shape:
            raise ValueError(f"{name}: shape {shape[1:]}, but {entry[1][0]} "
                             f"has {entry[0][1:]}")
        entry[1].append(name)
    return {p: out[p] for p in sorted(out, key=lambda p: tuple(p.split("/")))}


def _unstack(spec: P, stacked: bool) -> P:
    """A stacked leaf's spec without its layer entry (always None)."""
    if not stacked or not spec:
        return spec
    if spec[0] is not None:
        raise ValueError(f"spec {spec} shards the layer axis")
    return P(*spec[1:])


class ShardingRules:
    def __init__(self, mesh, *, moe_replicate: bool = False):
        self.mesh = mesh
        self.axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        self.fallbacks: list[str] = []
        # §Perf knob: replicate expert weights instead of EP/d_ff sharding
        # (small-expert models: trades memory for zero MoE collectives)
        self.moe_replicate = moe_replicate

    def _fits(self, dim: int, axes) -> bool:
        if axes is None:
            return True
        size = 1
        for a in axes:
            size *= self.axis_sizes.get(a, 1)
        return dim % size == 0

    def _spec_from_dims(self, shape, dims, path=""):
        """dims: per-dim axes for the LAST len(dims) dims of shape."""
        pad = len(shape) - len(dims)
        spec = [None] * pad
        for dim_size, axes in zip(shape[pad:], dims):
            if axes is None:
                spec.append(None)
            elif self._fits(dim_size, axes):
                spec.append(axes[0] if len(axes) == 1 else tuple(axes))
            else:
                self.fallbacks.append(f"{path}: dim {dim_size} !% {axes}")
                spec.append(None)
        return P(*spec)

    def param_spec(self, path: str, shape) -> P:
        if self.moe_replicate and re.search(r"moe/(wi|wo|router)", path):
            return P()
        for pat, dims in PARAM_RULES:
            if re.search(pat, path):
                if dims is None:
                    return P()
                # MoE expert-axis fallback: try EP first, then d_ff sharding
                if pat in MOE_ALT and not self._fits(
                        shape[len(shape) - len(dims)], dims[0]):
                    alt = MOE_ALT[pat]
                    return self._spec_from_dims(shape, alt, path)
                return self._spec_from_dims(shape, dims, path)
        return P()

    def batch_spec(self, shape, *, seq_axis: int | None = 1) -> P:
        dp = tuple(a for a in ("pod", "data") if a in self.axis_sizes)
        b = shape[0]
        spec = [None] * len(shape)
        if self._fits(b, dp):
            spec[0] = dp if len(dp) > 1 else dp[0]
        elif "data" in self.axis_sizes and self._fits(b, ("data",)):
            spec[0] = "data"
        return P(*spec)

    def cache_spec(self, path: str, shape) -> P:
        """Decode caches: (L, B, S, H, dh) k/v, (L, B, S) pos,
        (L, B, H, P, N) ssm state.  Batch → data(/pod); heads → model;
        B==1 (long-context) → shard the sequence dim over data (SP)."""
        dp = tuple(a for a in ("pod", "data") if a in self.axis_sizes)
        spec = [None] * len(shape)
        b = shape[1]
        batch_sharded = False
        if self._fits(b, dp) and b > 1:
            spec[1] = dp if len(dp) > 1 else dp[0]
            batch_sharded = True
        if path.endswith("state"):                      # (L,B,H,P,N)
            if self._fits(shape[2], ("model",)):
                spec[2] = "model"
            return P(*spec)
        if path.endswith("pos"):                        # (L,B,S)
            if not batch_sharded and self._fits(shape[2], ("data",)):
                spec[2] = "data"
            return P(*spec)
        if len(shape) >= 5:                             # (L,B,S,H,dh) k/v
            if not batch_sharded and self._fits(shape[2], ("data",)):
                spec[2] = "data"                        # sequence parallelism
            if self._fits(shape[3], ("model",)):
                spec[3] = "model"
        return P(*spec)

    # --- tree-level helpers, over the port's layout --------------------------

    def tree_param_specs(self, tree) -> dict:
        """Port name → spec for a module's parameters (or a dict name →
        tensor), each JAX leaf's rule applied once, in JAX's order."""
        out = {}
        for path, (shape, names) in _stacked(_named(tree)).items():
            spec = _unstack(self.param_spec(path, shape),
                            names[0].split(".")[0] in STACKED)
            out.update((name, spec) for name in names)
        return out

    def tree_opt_specs(self, opt_tree) -> dict:
        """The AdamW state ``{"m", "v", "step"}``: the moments by their
        parameters' rules (JAX strips ``m/`` and ``v/``), the 0-d step
        replicated; in JAX's leaf order m, step, v."""
        return {"m": self.tree_param_specs(opt_tree["m"]), "step": P(),
                "v": self.tree_param_specs(opt_tree["v"])}

    def tree_batch_specs(self, batch_tree) -> dict:
        return {k: self.batch_spec(tuple(v.shape))
                for k, v in sorted(batch_tree.items())}

    def tree_cache_specs(self, cache_tree) -> list:
        """The port's per-layer cache (a list of dicts): each key's rule on
        the stacked (L, ...) shape, the layer entry dropped."""
        n = len(cache_tree)
        specs = {key: _unstack(self.cache_spec(
                     key, (n,) + tuple(cache_tree[0][key].shape)), True)
                 for key in sorted(cache_tree[0])}
        return [dict(specs) for _ in cache_tree]


def shard_sizes(spec, mesh) -> list:
    """Per tensor dim of ``spec``, the number of shards it is cut into."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for entry in spec:
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(math.prod(sizes[a] for a in axes))
    return out


def local_shape(shape, spec, mesh) -> tuple:
    """One device's shard of a tensor of ``shape`` under ``spec`` (every
    sharded dim divides, as the rules' fallbacks make sure)."""
    shape = tuple(shape)
    cuts = shard_sizes(spec, mesh) + [1] * (len(shape) - len(spec))
    for dim, (size, cut) in enumerate(zip(shape, cuts)):
        if size % cut:
            raise ValueError(f"dim {dim} of {shape} does not divide into "
                             f"{cut} shards under {spec}")
    return tuple(size // cut for size, cut in zip(shape, cuts))


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a :class:`Mesh` or a
    ``DeviceMesh``): per mesh dimension, ``Shard(i)`` where tensor dim i
    names that axis, else ``Replicate()``.  A dim over ``("pod", "data")``
    is ``Shard(i)`` on both, pod major, as JAX orders it.  A mesh
    dimension of size 1 is ``Replicate()``: its one shard is the whole
    tensor."""
    from torch.distributed.tensor import Replicate, Shard
    if hasattr(mesh, "axis_names"):
        names, sizes = mesh.axis_names, mesh.devices.shape
    else:
        names, sizes = mesh.mesh_dim_names, mesh.shape
    out = []
    for axis, size in zip(names, sizes):
        dims = [i for i, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)

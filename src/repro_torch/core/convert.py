"""Carry the host-precomputed state of a JAX engine into the port.

The "weights" of this system are the twiddle plans and RNS constants the
host computes before any transform.  These functions take the fields of the
JAX package's ``ChannelPlan`` and ``RnsChain`` as ``dataclasses.asdict``
gives them (numpy arrays and Python ints) and build the port's dataclasses,
so both packages can run the same plans.  Nothing of the JAX package is
imported.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.limb_gemm import ChannelPlan
from repro_torch.core.rns import RnsChain


def channel_plan_from_numpy(fields: dict) -> ChannelPlan:
    fused = fields["fused_operand"]
    return ChannelPlan(
        modulus=int(fields["modulus"]), d=int(fields["d"]),
        data_limbs=int(fields["data_limbs"]), tw_limbs=int(fields["tw_limbs"]),
        accum=str(fields["accum"]),
        w_planes=np.asarray(fields["w_planes"], np.int8),
        fused_operand=None if fused is None else np.asarray(fused, np.int8))


def rns_chain_from_numpy(fields: dict) -> RnsChain:
    return RnsChain(
        p=int(fields["p"]), base=tuple(int(m) for m in fields["base"]),
        redundant=int(fields["redundant"]), M=int(fields["M"]),
        inv_Mi_mod_mi=np.asarray(fields["inv_Mi_mod_mi"], np.uint32),
        Mi_mod_mr=np.asarray(fields["Mi_mod_mr"], np.uint32),
        M_inv_mod_mr=int(fields["M_inv_mod_mr"]),
        Ti_digits=np.asarray(fields["Ti_digits"], np.uint32),
        V_digits=np.asarray(fields["V_digits"], np.uint32),
        p_digits=np.asarray(fields["p_digits"], np.uint32),
        p_prime=int(fields["p_prime"]),
        n_red_digits=int(fields["n_red_digits"]))

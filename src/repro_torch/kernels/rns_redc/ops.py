"""The RNS-to-field wrapper: checks, then the CUDA kernel or, on the CPU, the plain version."""
from __future__ import annotations

import torch

from repro_torch.core.rns import RnsChain
from repro_torch.core.zones import KERNEL_CALL
from repro_torch.kernels.rns_redc.kernel import COUNTER, rns_redc_cuda
from repro_torch.kernels.rns_redc.ref import rns_redc_ref

FORMS = ("digits", "words")
BASE_CHANNELS = (8, 17)    # the kernel is instantiated for 9 and 18 channels
SHAPE = {"n_red_digits": 23, "n_digits": 25, "n_words": 8}   # BN254's r


def rns_redc(residues: torch.Tensor, chain: RnsChain,
             form: str = "digits") -> torch.Tensor:
    """int64 (..., n+1) residues (base channels, then the redundant one;
    each non-negative and below 2**32) -> int64 (..., 23) canonical digit-12
    of X mod p (``form="digits"``, what ``rns.rns_to_field`` returns) or
    (..., 8) 32-bit words of it (``"words"``, each < 2**32).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  The chain has 9 or 18 channels and BN254's r.  No
    launch log records the call: the kernel is no staging pass's K node.
    """
    if form not in FORMS:
        raise ValueError(f"rns_redc form {form!r}; expected one of {FORMS}")
    if residues.dtype != torch.int64:
        raise TypeError(f"rns_redc takes int64 residues, got {residues.dtype}")
    if chain.n not in BASE_CHANNELS:
        raise ValueError(f"rns_redc runs 9- and 18-channel chains, not "
                         f"{chain.n + 1}")
    if residues.dim() < 1 or residues.shape[-1] != chain.n + 1:
        raise ValueError(f"rns_redc needs the chain's {chain.n + 1} channels "
                         f"on the last axis, got shape "
                         f"{tuple(residues.shape)}")
    got = {"n_red_digits": chain.n_red_digits,
           "n_digits": chain.Ti_digits.shape[1], "n_words": chain.n_words}
    if got != SHAPE:
        raise ValueError(f"rns_redc is built for BN254's r ({SHAPE}), got a "
                         f"chain with {got}")
    if not residues.is_contiguous():
        raise ValueError("rns_redc needs contiguous residues")
    COUNTER.calls += 1
    with KERNEL_CALL:     # what the kernel runs, not its caller
        if residues.is_cuda:
            return rns_redc_cuda(residues, chain, form == "words")
        if residues.is_cpu:
            return rns_redc_ref(residues, chain, form)
        raise ValueError(f"rns_redc runs on cuda or cpu, not {residues.device}")

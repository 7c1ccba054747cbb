"""ctypes binding of the CUDA kernel ``rns_redc_launch``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rns import RnsChain
from repro_torch.kernels import build

COUNTER = build.KernelCounter()


def constants(chain: RnsChain) -> np.ndarray:
    """The chain's constants as the C entry reads them, uint32: the n+1
    moduli, (M/m_i)^{-1} mod m_i, M/m_i mod m_r, M^{-1} mod m_r, −p^{-1}
    mod β, the digits of T (n × nd, row-major), of V and of p.  The launch
    copies them into the kernel's parameters (a captured graph keeps them
    in its node), so nothing is uploaded."""
    return np.concatenate([
        np.asarray(chain.moduli, np.uint32),
        np.asarray(chain.inv_Mi_mod_mi, np.uint32),
        np.asarray(chain.Mi_mod_mr, np.uint32),
        np.array([chain.M_inv_mod_mr, chain.p_prime], np.uint32),
        np.asarray(chain.Ti_digits, np.uint32).ravel(),
        np.asarray(chain.V_digits, np.uint32),
        np.asarray(chain.p_digits, np.uint32)])


def rns_redc_cuda(residues: torch.Tensor, chain: RnsChain,
                  words: bool) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream of ``residues``'
    device: the words form (8 a residue vector) or the digits form (23).
    The caller (``ops.rns_redc``) has checked dtype, channels, chain and
    contiguity."""
    n_out = chain.n_words if words else chain.n_red_digits
    out = residues.new_empty(residues.shape[:-1] + (n_out,))
    ptrs = build.pointers("rns_redc_launch", residues, out)
    n_el = out.numel() // n_out
    if n_el:
        consts = constants(chain)
        build.launch("rns_redc_launch", residues, *ptrs, n_el, chain.n,
                     int(words), consts.ctypes.data, consts.size)
        COUNTER.launches += 1
    return out


def grid_blocks(n_el: int) -> int:
    """Blocks in the kernel's grid for ``n_el`` elements, as the launch
    computes them (builds the library on first use)."""
    return build.entries()["rns_redc_blocks"](n_el)

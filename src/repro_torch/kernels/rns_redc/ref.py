"""Plain PyTorch version of the RNS-to-field reduction."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import montgomery as MG
from repro_torch.core import rns as R


def rns_redc_ref(residues: torch.Tensor, chain: R.RnsChain,
                 form: str) -> torch.Tensor:
    """(..., n+1) residues -> int64 (..., nred) digits of X mod p
    (``form="digits"``) or (..., n_words) words of it (``"words"``)."""
    digits = R.rns_to_field(residues, chain)
    if form == "words":
        return MG.digits_to_words_u32(digits)[..., :chain.n_words]
    return digits


def edge_residues(shape, rng: np.random.Generator) -> torch.Tensor:
    """(rows, d, C) int64 residues on the CPU for checking the kernel: half
    the rows the residues of integers uniform below M, the first row
    opening with 0, 1, M − 1, p − 1, p and 2**19·(p − 1)² where that is
    below M; the other half independent uniform residues of each channel."""
    rows, d, c = shape
    chain = R.make_chain(c)
    p = R.F.BN254_FR
    half = rows // 2 or 1
    nbytes = (chain.M.bit_length() + 7) // 8 + 1
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % chain.M
            for _ in range(half * d)]
    edges = [v for v in (0, 1, chain.M - 1, p - 1, p, 2**19 * (p - 1) ** 2)
             if v < chain.M]
    vals[:len(edges)] = edges
    out = np.empty((rows, d, c), np.int64)
    out[:half] = R.to_rns_np(np.array(vals, object), chain).reshape(half, d, c)
    for ch, m in enumerate(chain.moduli):
        out[half:, :, ch] = rng.integers(0, m, (rows - half, d))
    return torch.from_numpy(out)

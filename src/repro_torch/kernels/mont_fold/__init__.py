"""K2 — the fold of limb-weight diagonals to residues mod m (CUDA, ``csrc/mont_fold.cu``)."""

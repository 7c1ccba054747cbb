"""K3 — one staging pass, limb GEMM and fold in one kernel (CUDA, ``csrc/fused_ntt_tile.cu``)."""

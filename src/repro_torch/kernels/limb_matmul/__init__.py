"""K1 — the u8×s8 limb GEMM of one staging pass (CUDA, ``csrc/limb_matmul.cu``)."""

"""ctypes binding of the K3 CUDA kernel ``fused_ntt_tile_launch``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

COUNTER = build.KernelCounter()


def fused_ntt_tile_cuda(a_u8: torch.Tensor, b3_s8: torch.Tensor, modulus: int,
                        accum: str) -> torch.Tensor:
    """Launch K3 on the current stream of the operands' device.  The caller
    (``ops.fused_ntt_tile``) has checked dtypes, shapes, n_diag, modulus and
    contiguity.  Residues leave in an int32 tensor, as K2's do."""
    lib = build.load()
    n, k = a_u8.shape
    _, d, n_diag = b3_s8.shape
    out = torch.empty((n, d), dtype=torch.int32, device=a_u8.device)
    if n == 0 or d == 0:
        return out
    with torch.cuda.device(a_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_ntt_tile_launch(
            a_u8.data_ptr(), b3_s8.data_ptr(), out.data_ptr(), n, k, d,
            n_diag, modulus, int(accum == "fp32_mantissa"), stream)
    build.check(code, "fused_ntt_tile")
    COUNTER.launches += 1
    return out

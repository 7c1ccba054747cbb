"""ctypes binding of the K1 CUDA kernel ``limb_matmul_launch``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

COUNTER = build.KernelCounter()


def limb_matmul_cuda(a_u8: torch.Tensor, b_s8: torch.Tensor,
                     accum: str) -> torch.Tensor:
    """Launch K1 on the current stream of the operands' device.  The caller
    (``ops.limb_matmul``) has checked dtypes, shapes and contiguity."""
    lib = build.load()
    n, k = a_u8.shape
    m = b_s8.shape[1]
    out = torch.empty((n, m), dtype=torch.int32, device=a_u8.device)
    if n == 0 or m == 0:
        return out
    with torch.cuda.device(a_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.limb_matmul_launch(
            a_u8.data_ptr(), b_s8.data_ptr(), out.data_ptr(), n, k, m,
            int(accum == "fp32_mantissa"), stream)
    build.check(code, "limb_matmul")
    COUNTER.launches += 1
    return out

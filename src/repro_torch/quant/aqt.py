"""The paper's arithmetic core applied to AI workloads: W8A8 symmetric
quantisation with an integer product, as a quantised matmul mode for LM
projection layers — the counterpart of ``repro.quant.aqt``.

The accumulator-exactness bound of the crypto pipeline transfers: a K-dim
reduction of 8-bit products is bit-exact while K·(255·128) stays inside the
accumulator's window (Prop. 5.1).  Two accumulators, as in JAX:

* ``int32_native``: s8 × s8 → s32 exactly.  On a CUDA tensor the product is
  ``torch._int_mm`` (a library GEMM: JAX takes this product with
  ``jnp.dot`` outside any Pallas kernel), whose shape limits — more than 16
  rows, K and N multiples of 8 — are met by padding with zeros, which is
  exact, and slicing the result; on a CPU tensor it is the plain integer
  matmul.  int32 sums wrap past the window, as JAX's do.
* ``fp32_mantissa``: a float32 matmul with TF32 off, exact while
  K·127² < 2**24.

No float path stands in for a failed integer one.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.accumulator import MAX_PIXEL_PRODUCT, accumulator_window
from repro_torch.runtime.compression import true_div


def quantize_symmetric(x, bits: int = 8, axis=-1):
    """Per-channel symmetric quantisation -> (int8 codes, f32 scales)."""
    xf = x.float()
    maxval = xf.abs().amax(dim=axis, keepdim=True)
    q = 2 ** (bits - 1) - 1
    scale = true_div(torch.clamp(maxval, min=1e-12), float(q))
    codes = torch.clamp(torch.round(xf / scale), -q, q).to(torch.int8)
    return codes, scale


def exact_k_bound(accum: str = "int32_native") -> int:
    """Max contraction length with guaranteed-exact accumulation (Prop 5.1)."""
    return accumulator_window(accum) // MAX_PIXEL_PRODUCT


def int_mm_padded(a, b):
    """(M, K) int8 @ (K, N) int8 → (M, N) int32 through ``torch._int_mm``:
    M padded to more than 16 rows and K, N to multiples of 8 with zeros,
    the result sliced back.  An operand that needs no padding is passed as
    it is laid out (``QuantizedLinear`` keeps its codes column-major, the
    layout of cuBLASLt's int8 GEMM)."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b)[:m, :n]


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def int8_product(x_codes, w_codes, accum: str = "int32_native"):
    """(..., K) int8 × (K, N) int8 as float32, under ``accum``."""
    if accum == "fp32_mantissa":
        with _no_tf32():
            return torch.matmul(x_codes.float(), w_codes.float())
    if accum != "int32_native":
        raise ValueError(f"accum {accum!r}: expected 'int32_native' or "
                         f"'fp32_mantissa'")
    lead, k = x_codes.shape[:-1], x_codes.shape[-1]
    a = x_codes.reshape(-1, k)
    if a.is_cuda:
        acc = int_mm_padded(a, w_codes)
    else:
        acc = a.to(torch.int32) @ w_codes.to(torch.int32)
    return acc.reshape(*lead, w_codes.shape[1]).float()


def quantized_matmul(x, w_codes, w_scale, *, accum: str = "int32_native"):
    """(..., K) activations × (K, N) int8 weights via the integer path.

    w_scale: (1, N) per-output-column scales (from quantize_symmetric axis=0).
    """
    x_codes, x_scale = quantize_symmetric(x, axis=-1)
    return int8_product(x_codes, w_codes, accum) * x_scale * w_scale


class QuantizedLinear(nn.Module):
    """W8A8 projection layer sharing the crypto pipeline's discipline: the
    weight's per-output-column codes (column-major) and scales are buffers
    on its device."""

    def __init__(self, w, *, accum: str = "int32_native"):
        super().__init__()
        codes, scale = quantize_symmetric(w, axis=0)   # per-out-col
        self.register_buffer("codes", codes.t().contiguous().t())
        self.register_buffer("scale", scale)
        self.accum = accum

    def forward(self, x):
        return quantized_matmul(x, self.codes, self.scale,
                                accum=self.accum).to(x.dtype)

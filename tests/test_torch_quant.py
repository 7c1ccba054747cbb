"""The port's W8A8 path (``repro_torch.quant``) against the JAX package's
``repro.quant`` on the CPU, bit for bit.

Quantisation is the same float32 arithmetic in the same order (|x| max,
clamp, divide, round half to even, clip); the int32 model's product is an
exact integer product in both packages, and the fp32 model's is exact while
K·127² < 2**24, so each output is the same float32 scale products of the
same integers.  ``QuantizedLinear`` is held within 0.05 of the float
product as in ``tests/test_quant.py``, ``exact_k_bound`` to its values, and
the padded ``torch._int_mm`` product (the card's int32 path) to the plain
integer product at shapes ``_int_mm`` refuses unpadded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import QuantizedLinear as JaxQuantizedLinear
from repro.quant import quantize_symmetric as jax_quantize_symmetric
from repro.quant import quantized_matmul as jax_quantized_matmul
from repro.quant.aqt import exact_k_bound as jax_exact_k_bound
from repro_torch.quant import QuantizedLinear, quantize_symmetric, quantized_matmul
from repro_torch.quant import aqt

ACCUMS = ["int32_native", "fp32_mantissa"]


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_symmetric_bit_for_bit(axis, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(48, 40)).astype(np.float32)
    x[3] = 0.0                                   # a zero row: the 1e-12 clamp
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jc, js = jax_quantize_symmetric(jx, axis=axis)
    tc, ts = quantize_symmetric(tx, axis=axis)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("accum", ACCUMS)
def test_quantized_matmul_bit_for_bit(accum):
    rng = np.random.default_rng(1)
    k = 300
    assert k * 127 * 127 < 2 ** 24
    x = rng.normal(size=(2, 5, k)).astype(np.float32)
    w = (rng.normal(size=(k, 24)) * 0.05).astype(np.float32)
    jc, js = jax_quantize_symmetric(jnp.asarray(w), axis=0)
    want = jax_quantized_matmul(jnp.asarray(x), jc, js, accum=accum)
    tc, ts = quantize_symmetric(torch.from_numpy(w), axis=0)
    got = quantized_matmul(torch.from_numpy(x), tc, ts, accum=accum)
    assert got.shape == (2, 5, 24) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("accum", ACCUMS)
def test_quantized_linear_bit_for_bit_and_close_to_fp(accum):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(128, 64)) * 0.05).astype(np.float32)
    x = rng.normal(size=(8, 128)).astype(np.float32)
    layer = QuantizedLinear(torch.from_numpy(w), accum=accum)
    got = layer(torch.from_numpy(x))
    want = JaxQuantizedLinear(jnp.asarray(w), accum=accum)(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = x @ w
    rel = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert rel < 0.05
    assert {n for n, _ in layer.named_buffers()} == {"codes", "scale"}


def test_quantized_linear_keeps_bf16():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32) * 0.05)
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    out = QuantizedLinear(w.bfloat16())(x.bfloat16())
    ref = x.bfloat16().float() @ w.bfloat16().float()
    assert out.dtype == torch.bfloat16
    assert float((out.float() - ref).abs().max() / ref.abs().max()) < 0.05


def test_quantized_matmul_int32_exact_within_window():
    """Integer-valued inputs inside the Prop-5.1 window are bit-exact."""
    rng = np.random.default_rng(2)
    k = 256
    assert k < aqt.exact_k_bound("int32_native")
    xi = rng.integers(-127, 128, (4, k))
    wi = rng.integers(-127, 128, (k, 16))
    x = torch.as_tensor(xi, dtype=torch.float32) / 127.0
    out = quantized_matmul(x, torch.as_tensor(wi, dtype=torch.int8),
                           torch.full((1, 16), 1.0 / 127.0))
    want = (xi @ wi).astype(np.float64) / (127.0 * 127.0)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)


def test_exact_k_bounds_match_paper_and_jax():
    assert aqt.exact_k_bound("fp32_mantissa") == (1 << 24) // (255 * 128)
    assert aqt.exact_k_bound("int32_native") == ((1 << 31) - 1) // (255 * 128)
    for accum in ACCUMS:
        assert aqt.exact_k_bound(accum) == jax_exact_k_bound(accum)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (8, 13, 7), (16, 16, 16),
                                   (17, 8, 8), (5, 300, 24), (40, 9, 31)])
def test_int_mm_padding_is_exact(m, k, n):
    """The card's int32 product: zero padding to > 16 rows and K, N
    multiples of 8, then ``torch._int_mm`` (run here on the CPU), sliced
    back, equals the plain integer product; the extreme codes included."""
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a = torch.as_tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8)
    b = torch.as_tensor(rng.integers(-127, 128, (k, n)), dtype=torch.int8)
    a[0, 0], b[0, 0] = -127, -127
    got = aqt.int_mm_padded(a, b)
    assert got.shape == (m, n) and got.dtype == torch.int32
    assert torch.equal(got, a.to(torch.int32) @ b.to(torch.int32))


def test_unknown_accumulator_refused():
    codes = torch.zeros((4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="accum"):
        aqt.int8_product(codes, codes, "bf16")

"""Staged transform and workload engines: PyTorch port (CPU) vs the JAX package.

Channel plans must be byte-identical; every transform row must equal the
JAX engine's and the bignum oracle's (tolerance 0).  The JAX engines run
eagerly on the CPU.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import field as JF
from repro.core import limb_gemm as JG
from repro.core import ntt as JNTT
from repro.core import workloads as JWK
from repro_torch.core import convert
from repro_torch.core import limb_gemm as TG
from repro_torch.core import workloads as TWK
from repro_torch.kernels import mont_fold_window_fn, tile_fn
from repro_torch.kernels.limb_matmul.kernel import COUNTER as K1
from repro_torch.kernels.mont_fold.kernel import COUNTER as K2

Q = JF.DILITHIUM_Q
RNG = np.random.default_rng(7)


def _dil_rows(n, d):
    return RNG.integers(0, Q, (n, d), dtype=np.uint64).astype(np.uint32)


def _u32(t):
    return t.numpy().astype(np.uint32)


def _bn_coeffs(n, d, nbytes=16):
    return np.array([[int.from_bytes(RNG.bytes(nbytes), "little")
                      for _ in range(d)] for _ in range(n)], object)


@pytest.mark.parametrize("d,m,limbs", [(64, Q, 3), (256, Q, 3),
                                       (16, 2013265921, 4)])
def test_channel_plans_byte_identical(d, m, limbs):
    w = JNTT.ntt_matrix(d, m, negacyclic=(m == Q))
    jp = JG.make_channel_plan(w, m, data_limbs=limbs, tw_limbs=limbs)
    tp = TG.make_channel_plan(w, m, data_limbs=limbs, tw_limbs=limbs)
    assert tp.w_planes.dtype == np.int8 and tp.fused_operand.dtype == np.int8
    assert tp.w_planes.tobytes() == jp.w_planes.tobytes()
    assert tp.fused_operand.tobytes() == jp.fused_operand.tobytes()
    assert (tp.n_diag, tp.d_max, tp.n_passes, tp.tile_bounds()) == \
        (jp.n_diag, jp.d_max, jp.n_passes, jp.tile_bounds())


def _int32_plan(d=256):
    w = JNTT.ntt_matrix(d, Q, negacyclic=True)
    return (w, JG.make_channel_plan(w, Q, data_limbs=3, tw_limbs=3,
                                    accum="int32_native"),
            TG.make_channel_plan(w, Q, data_limbs=3, tw_limbs=3,
                                 accum="int32_native"))


@pytest.mark.parametrize("reduction,kappa", [("eager", None), ("lazy", 1),
                                             ("lazy", 2), ("lazy", None)])
def test_staged_transform_matches_jax(reduction, kappa):
    w, jp, tp = _int32_plan()
    a = _dil_rows(4, 256)
    yj, sj = JG.staged_transform(jnp.asarray(a), jp, reduction=reduction,
                                 kappa=kappa, d_max=171)
    K1.reset()
    K2.reset()
    yt, st = TG.staged_transform(torch.from_numpy(a.astype(np.int64)), tp,
                                 reduction=reduction, kappa=kappa, d_max=171)
    np.testing.assert_array_equal(_u32(yt), np.asarray(yj))
    np.testing.assert_array_equal(_u32(yt), JNTT.matrix_ntt_oracle_np(a, w, Q))
    assert st == sj
    assert (K1.calls, K2.calls) == (2, st["n_folds"])


def test_staged_transform_rejects_what_jax_rejects():
    _, _, tp = _int32_plan(64)
    a = torch.zeros((1, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="kappa"):
        TG.staged_transform(a, tp, reduction="eager", kappa=2)
    with pytest.raises(ValueError, match="reduction"):
        TG.staged_transform(a, tp, reduction="lazzy")
    fp = TG.make_channel_plan(JNTT.ntt_matrix(256, Q, negacyclic=True), Q,
                              data_limbs=3, tw_limbs=3)
    with pytest.raises(ValueError, match="ceiling"):
        TG.staged_transform(torch.zeros((1, 256), dtype=torch.int64), fp,
                            d_max=200)


def test_per_plane_mode_and_adapters_match_fused():
    """Per-plane mode (no fused operand: one K1 call per limb pair) and the
    explicit kernel_fn/fold_fn adapters give the fused default's rows."""
    w, _, tp = _int32_plan(128)
    planar = TG.make_channel_plan(w, Q, data_limbs=3, tw_limbs=3,
                                  accum="int32_native", fuse_below=64)
    assert planar.fused_operand is None and planar.gemms_per_pass == 9
    a = torch.from_numpy(_dil_rows(3, 128).astype(np.int64))
    want, _ = TG.staged_transform(a, tp, d_max=64)
    K1.reset()
    got, st = TG.staged_transform(a, planar, d_max=64)
    assert K1.calls == st["n_passes"] * 9
    assert torch.equal(got, want)
    lazy, _ = TG.staged_transform(a, tp, reduction="lazy", kappa=2, d_max=64,
                                  kernel_fn=tile_fn(),
                                  fold_fn=mont_fold_window_fn())
    assert torch.equal(lazy, want)
    with pytest.raises(ValueError, match="fused"):
        TG.staged_transform(a, planar, kernel_fn=tile_fn())


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("cfg", [
    dict(accum="fp32_mantissa"),
    dict(accum="int32_native", reduction="lazy", kappa=2, d_tile=171),
], ids=["fp32_eager", "int32_lazy"])
def test_dilithium_engine_matches_jax_and_oracle(d, cfg):
    je = JWK.DilithiumEngine(d, **cfg)
    te = TWK.DilithiumEngine(d, device="cpu", **cfg)
    a = _dil_rows(5, d)
    got = _u32(te.e2e(a))
    np.testing.assert_array_equal(got, np.asarray(je.e2e(jnp.asarray(a))))
    np.testing.assert_array_equal(got, te.oracle_np(a))
    assert te.fold_profile == je.fold_profile
    assert te.last_stats == je.last_stats


@pytest.mark.parametrize("d,n_channels", [(16, 9), (32, 9), (16, 18),
                                          (32, 18)])
def test_bn254_engine_matches_jax(d, n_channels):
    je = JWK.BN254Engine(d, n_channels=n_channels)
    te = TWK.BN254Engine(d, n_channels=n_channels, device="cpu")
    coeffs = _bn_coeffs(2, d)
    a_j = je.ingest(coeffs)
    a_t = te.ingest(coeffs)
    np.testing.assert_array_equal(_u32(a_t), np.asarray(a_j))
    got = te.e2e(a_t)
    np.testing.assert_array_equal(_u32(got), np.asarray(je.e2e(a_j)))
    assert te.fold_profile == je.fold_profile
    assert dataclasses.asdict(te.wclass) == dataclasses.asdict(je.wclass)
    assert te.n_channels == n_channels


def test_bn254_explicit_evaluation_matrix_matches_jax():
    """As tests/test_kernels.py::test_bn254_engine_with_pallas: a random
    88-bit evaluation matrix; transformed residues and the reduction equal
    the JAX engine's, and inside the CRT envelope the field result equals
    the bignum oracle mod p."""
    d = 32
    rng = np.random.default_rng(5)
    omega = np.array([[int.from_bytes(rng.bytes(11), "little")
                       for _ in range(d)] for _ in range(d)], object)
    coeffs = np.array([[int.from_bytes(rng.bytes(16), "little")
                        for _ in range(d)] for _ in range(2)], object)
    je = JWK.BN254Engine(d, evaluation_matrix=omega)
    te = TWK.BN254Engine(d, evaluation_matrix=omega, device="cpu")
    a_j = je.ingest(coeffs)
    y_t = te.evaluate(te.ingest(coeffs))
    np.testing.assert_array_equal(_u32(y_t), np.asarray(je.evaluate(a_j)))
    digits = te.reduce(y_t)
    np.testing.assert_array_equal(_u32(digits),
                                  np.asarray(je.reduce(je.evaluate(a_j))))
    assert te.in_envelope(coeffs)
    from repro_torch.core import wordarith as TW
    np.testing.assert_array_equal(TW.digits_to_int_batch(digits.numpy()),
                                  te.oracle_eval_np(coeffs) % JF.BN254_FR)


def test_convert_carries_jax_plans_and_chain():
    jd = JWK.DilithiumEngine(64, accum="int32_native")
    plan = convert.channel_plan_from_numpy(dataclasses.asdict(jd.plan))
    for f in dataclasses.fields(plan):
        a, b = getattr(plan, f.name), getattr(jd.plan, f.name)
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
    carried = TWK.DilithiumEngine(64, accum="int32_native", plan=plan,
                                  device="cpu")
    a = _dil_rows(3, 64)
    np.testing.assert_array_equal(_u32(carried.e2e(a)),
                                  np.asarray(jd.e2e(jnp.asarray(a))))
    with pytest.raises(ValueError, match="carried plan"):
        TWK.DilithiumEngine(128, plan=plan, device="cpu")

    jb = JWK.BN254Engine(16)
    chain = convert.rns_chain_from_numpy(dataclasses.asdict(jb.chain))
    plans = [convert.channel_plan_from_numpy(dataclasses.asdict(p))
             for p in jb.plans]
    for f in dataclasses.fields(jb.chain):
        a, b = getattr(chain, f.name), getattr(jb.chain, f.name)
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
    tb = TWK.BN254Engine(16, chain=chain, plans=plans, device="cpu")
    coeffs = _bn_coeffs(2, 16)
    np.testing.assert_array_equal(
        _u32(tb.e2e(tb.ingest(coeffs))),
        np.asarray(jb.e2e(jb.ingest(coeffs))))
    with pytest.raises(ValueError, match="carried plans"):
        TWK.BN254Engine(16, chain=chain, plans=plans[:3], device="cpu")


def test_make_engine_caches_per_device():
    a = TWK.make_engine("dilithium", 64, device="cpu")
    assert a is TWK.make_engine("dilithium", 64, device="cpu")
    assert a.device == torch.device("cpu")
    assert TWK.make_engine("bn254_full", 16, device="cpu").n_channels == 18
    with pytest.raises(KeyError):
        TWK.make_engine("rsa", 64, device="cpu")

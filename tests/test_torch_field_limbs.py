"""PyTorch port vs the JAX package: limbs, field ops, folds, word arithmetic.

Same numpy inputs (seeded) through ``repro`` and ``repro_torch``; every
comparison is exact (tolerance 0).  Residues enter torch as int64.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import accumulator as JACC
from repro.core import field as JF
from repro.core import limbs as JL
from repro.core import montgomery as JMG
from repro.core import ntt as JNTT
from repro.core import primes as JP
from repro.core import rns as JR
from repro.core import wordarith as JW
from repro_torch.core import accumulator as TACC
from repro_torch.core import field as TF
from repro_torch.core import limbs as TL
from repro_torch.core import montgomery as TMG
from repro_torch.core import ntt as TNTT
from repro_torch.core import primes as TP
from repro_torch.core import rns as TR
from repro_torch.core import wordarith as TW

RNG = np.random.default_rng(11)
CHAIN9 = JR.make_chain(9)
MODULI = [JF.DILITHIUM_Q, 2013265921, (1 << 31) - 99] + list(CHAIN9.moduli[:3])


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _u32(x):
    return np.asarray(x).astype(np.uint32)


# --- limbs ---------------------------------------------------------------------

@pytest.mark.parametrize("n_limbs", [3, 4])
def test_decompose_recompose_match_jax(n_limbs):
    x = RNG.integers(0, 2**32, (7, 33), dtype=np.uint64).astype(np.uint32)
    if n_limbs == 3:
        x = x & np.uint32(0xFFFFFF)
    want = np.asarray(JL.decompose_u8(jnp.asarray(x), n_limbs))
    got = TL.decompose_u8(_t(x), n_limbs)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = TL.recompose_u32(got)
    np.testing.assert_array_equal(
        _u32(back), np.asarray(JL.recompose_u32(jnp.asarray(want))))
    np.testing.assert_array_equal(_u32(back), x)


def test_host_limb_helpers_match_jax():
    m = (1 << 31) - 99
    w = RNG.integers(0, m, (16, 16), dtype=np.int64)
    bal_j, bal_t = JL.balanced_residue(w, m), TL.balanced_residue(w, m)
    np.testing.assert_array_equal(bal_t, bal_j)
    np.testing.assert_array_equal(TL.signed_digits(bal_t, 4),
                                  JL.signed_digits(bal_j, 4))
    np.testing.assert_array_equal(TL.unsigned_digits_np(w, 4),
                                  JL.unsigned_digits_np(w, 4))
    d = TL.signed_digits(bal_t, 4)
    np.testing.assert_array_equal(TL.signed_digits_value(d), bal_t)
    with pytest.raises(ValueError):
        TL.signed_digits(np.array([1 << 40]), 3)


# --- field ops -----------------------------------------------------------------

@pytest.mark.parametrize("m", MODULI)
def test_modular_ops_match_jax(m):
    a = RNG.integers(0, m, 257, dtype=np.int64)
    b = RNG.integers(0, m, 257, dtype=np.int64)
    a[:3], b[:3] = [0, m - 1, 0], [0, m - 1, m - 1]
    ja, jb, jm = jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32), jnp.uint32(m)
    ta, tb = _t(a), _t(b)
    pairs = [
        (TF.addmod(ta, tb, m), JF.addmod_u32(ja, jb, jm)),
        (TF.submod(ta, tb, m), JF.submod_u32(ja, jb, jm)),
        (TF.negmod(ta, m), JF.negmod_u32(ja, jm)),
        (TF.mulmod(ta, tb, m), JF.mulmod_u32(ja, jb, jm)),
        (TF.shift8_mod(ta, m), JF.shift8_mod(ja, jm)),
        (TF.shift16_mod(ta, m), JF.shift16_mod(ja, jm)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_field_constants_match_jax():
    for name in ("dilithium", "bn254"):
        assert dataclasses.asdict(TF.field_for(name)) == \
            dataclasses.asdict(JF.field_for(name))
    assert TF.BN254_FR == JF.BN254_FR and TF.DILITHIUM_Q == JF.DILITHIUM_Q


# --- the fold (plain version of mont_fold) ------------------------------------

I32 = (1 << 31) - 1
FOLD_CASES = [
    ("sweep", -(2**24), 2**24),
    ("negative", -(2**24), 0),
    ("kappa_summed", -I32, I32 + 1),      # κ-pass sums at the int32 bound
    ("all_negative_full", -I32 - 1, 0),
]


@pytest.mark.parametrize("m", [JF.DILITHIUM_Q, 2013265921, (1 << 31) - 99,
                               CHAIN9.moduli[-1]])
@pytest.mark.parametrize("case,lo,hi", FOLD_CASES)
def test_fold_diagonals_matches_jax(m, case, lo, hi):
    n_diag = 5 if m == JF.DILITHIUM_Q else 7
    diags = RNG.integers(lo, hi, (4, 37, n_diag)).astype(np.int32)
    diags[0, 0] = [lo] * n_diag                     # the range edges
    diags[0, 1] = [hi - 1] * n_diag
    want = np.asarray(JF.fold_diagonals_u32(jnp.asarray(diags), jnp.uint32(m)))
    got = TF.fold_diagonals(torch.from_numpy(diags), m)
    np.testing.assert_array_equal(_u32(got), want)
    assert int(got.min()) >= 0 and int(got.max()) < m


# --- primes / NTT / accumulator --------------------------------------------------

def test_primes_and_ntt_matrices_match_jax():
    assert TP.ntt_friendly_primes(18, 17) == JP.ntt_friendly_primes(18, 17)
    assert all(TP.is_prime(p) for p in TP.ntt_friendly_primes(9, 17))
    for d, m, neg in ((64, JF.DILITHIUM_Q, True), (32, CHAIN9.moduli[0], False)):
        np.testing.assert_array_equal(TNTT.ntt_matrix(d, m, negacyclic=neg),
                                      JNTT.ntt_matrix(d, m, negacyclic=neg))
        np.testing.assert_array_equal(TNTT.intt_matrix(d, m, negacyclic=neg),
                                      JNTT.intt_matrix(d, m, negacyclic=neg))
    w = TNTT.ntt_matrix(16, JF.DILITHIUM_Q, negacyclic=True)
    a = RNG.integers(0, JF.DILITHIUM_Q, (3, 16)).astype(np.uint32)
    np.testing.assert_array_equal(
        TNTT.matrix_ntt_oracle_np(a, w, JF.DILITHIUM_Q),
        JNTT.matrix_ntt_oracle_np(a, w, JF.DILITHIUM_Q))


def test_accumulator_window_maths_match_jax():
    for accum in ("fp32_mantissa", "int32_native"):
        assert TACC.accumulator_window(accum) == JACC.accumulator_window(accum)
        assert TACC.exact_window_bruteforce(accum) == \
            JACC.exact_window_bruteforce(accum)
        for d_tile in (64, 128, 171, 512):
            for c in (3, 4):
                assert TACC.kappa_max(accum, d_tile, c) == \
                    JACC.kappa_max(accum, d_tile, c)
    assert TACC.kappa_max_bruteforce("int32_native", 2, 2, 2) == \
        JACC.kappa_max_bruteforce("int32_native", 2, 2, 2)
    for n_passes, kappa in ((5, 2), (3, None), (4, 1), (7, 3)):
        assert TACC.window_plan(n_passes, kappa, 8) == \
            JACC.window_plan(n_passes, kappa, 8)
    with pytest.raises(ValueError):
        TACC.window_plan(4, 9, 8)


def test_lazy_window_accumulator_checks_every_add():
    acc = TACC.LazyWindowAccumulator(JF.DILITHIUM_Q, "fp32_mantissa", 3,
                                     kappa=2, fold_fn=None)
    diag = torch.ones((1, 4, 5), dtype=torch.int32)
    acc.add(diag, 171)                      # one full fp32 pass fits
    with pytest.raises(ValueError, match="overflow"):
        acc.add(diag, 171)                  # the second would pass 2**24
    acc2 = TACC.LazyWindowAccumulator(JF.DILITHIUM_Q, "int32_native", 3,
                                      kappa=1)
    acc2.add(diag, 8)
    with pytest.raises(ValueError, match="fold first"):
        acc2.add(diag, 8)
    assert acc2.ready() and acc2.pending == 1
    y = acc2.fold()
    assert acc2.n_folds == 1 and acc2.pending == 0 and y.shape == (1, 4)
    with pytest.raises(ValueError, match="empty"):
        acc2.fold()


# --- word arithmetic, REDC, RNS -------------------------------------------------

def test_wordarith_matches_jax():
    nd = CHAIN9.Ti_digits.shape[1]
    xi = RNG.integers(0, 2**31, (3, 5, CHAIN9.n)).astype(np.uint32)
    want = np.asarray(JW.scalar_conv_accumulate(
        jnp.asarray(xi), jnp.asarray(CHAIN9.Ti_digits), nd + 3))
    got = TW.scalar_conv_accumulate(_t(xi), _t(CHAIN9.Ti_digits), nd + 3)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    norm_j = np.asarray(JW.normalize_digits(jnp.asarray(want)))
    norm_t = TW.normalize_digits(got)
    np.testing.assert_array_equal(_u32(norm_t), norm_j)
    p = CHAIN9.p_digits
    t = RNG.integers(0, TW.BETA, (6, len(p))).astype(np.uint32)
    t[0] = p                                              # t == p exactly
    np.testing.assert_array_equal(
        _u32(TW.cond_subtract(_t(t), p)),
        np.asarray(JW.cond_subtract(jnp.asarray(t), jnp.asarray(p))))
    np.testing.assert_array_equal(
        TW.digits_geq(_t(t), p).numpy(),
        np.asarray(JW.digits_geq(jnp.asarray(t), p)))
    a = np.stack([TW.int_to_digits(int(v) % CHAIN9.p, len(p))
                  for v in RNG.integers(0, 2**62, 4)])
    b = np.stack([TW.int_to_digits(int(v) % CHAIN9.p, len(p))
                  for v in RNG.integers(0, 2**62, 4)])
    np.testing.assert_array_equal(
        _u32(TW.digits_submod_p(_t(a), _t(b), p)),
        np.asarray(JW.digits_submod_p(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(p))))
    assert TW.digits_to_int(TW.int_to_digits(12345678901, 4)) == 12345678901
    np.testing.assert_array_equal(TW.digits_to_int_batch(a),
                                  JW.digits_to_int_batch(a))


def test_redc_and_word_packing_match_jax():
    nd = CHAIN9.n_red_digits + 2
    y = RNG.integers(0, TW.BETA, (5, nd)).astype(np.uint32)
    y[:, -1] = 0                                 # Y < β^(nd-1): inside the REDC range
    want = np.asarray(JMG.redc_digits(jnp.asarray(y), CHAIN9))
    got = TMG.redc_digits(_t(y), TR.make_chain(9))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        _u32(TMG.digits_to_words_u32(got)),
        np.asarray(JMG.digits_to_words_u32(jnp.asarray(want))))


@pytest.mark.parametrize("n_channels", [9, 18])
def test_rns_chain_and_reduction_match_jax(n_channels):
    jc, tc = JR.make_chain(n_channels), TR.make_chain(n_channels)
    for f in dataclasses.fields(jc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    vals = np.array([int.from_bytes(RNG.bytes(20), "little")
                     for _ in range(24)], object).reshape(4, 6)
    res = TR.to_rns_np(vals, tc)
    np.testing.assert_array_equal(res, JR.to_rns_np(vals, jc))
    np.testing.assert_array_equal(TR.from_rns_np(res, tc), vals)
    xi_j, al_j = JR.sk_alpha(jnp.asarray(res), jc)
    xi_t, al_t = TR.sk_alpha(_t(res), tc)
    np.testing.assert_array_equal(_u32(xi_t), np.asarray(xi_j))
    np.testing.assert_array_equal(_u32(al_t), np.asarray(al_j))
    got = TR.rns_to_field(_t(res), tc)
    np.testing.assert_array_equal(
        _u32(got), np.asarray(JR.rns_to_field(jnp.asarray(res), jc)))
    ints = TW.digits_to_int_batch(got.numpy())
    np.testing.assert_array_equal(ints, vals % TF.BN254_FR)

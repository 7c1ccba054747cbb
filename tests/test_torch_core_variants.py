"""The deferred core variants: PyTorch port (CPU) vs the JAX package.

The Table-1 accumulator probes, the traced-operand and scan forms of the
staged transform, the plain matrix oracle, the Cooley–Tukey and MORPH NTT
baselines and the lax fold.  The same seeded numpy inputs go through the
JAX function (eagerly on the CPU) and its port counterpart; every result
must be equal (tolerance 0).  Kernel calls are counted by the launch log,
which records the wrappers' plain versions on the CPU as it records the
kernels on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accumulator as JACC
from repro.core import limb_gemm as JG
from repro.core import montgomery as JMONT
from repro.core import ntt as JNTT
from repro.core import primes as JP
from repro_torch.core import accumulator as TACC
from repro_torch.core import limb_gemm as TG
from repro_torch.core import montgomery as TMONT
from repro_torch.core import ntt as TNTT
from repro_torch.core import zones as Z
from repro_torch.kernels import fused_transform

Q = 8380417
BIG = 2013265921                          # 15·2**27 + 1, a 31-bit NTT prime
FIG3 = JP.ntt_friendly_primes(9, 17)[0]   # the 4-limb prime of Fig. 3
RNG = np.random.default_rng(20)

# The paper's Table-1 rows, which the JAX package reproduces on the CPU.
PAPER_V4 = [True, True, True, False, False, False, False]
PAPER_V5 = [True] * 7


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _rows(n, d, m):
    return RNG.integers(0, m, (n, d), dtype=np.uint64).astype(np.uint32)


# --- Table 1 probes ------------------------------------------------------------


@pytest.mark.parametrize("s", JACC.TABLE1_TARGETS)
def test_probe_operands_and_exactness_equal_jax(s):
    jl, jr = JACC._operands_for_target(s)
    tl, tr = TACC._operands_for_target(s)
    assert (tl.dtype, tr.dtype, tl.shape, tr.shape) == \
        (jl.dtype, jr.dtype, jl.shape, jr.shape)
    assert np.array_equal(tl, jl) and np.array_equal(tr, jr)
    assert (tl.astype(np.int64) @ tr.astype(np.int64))[0, 0] == -s
    for accum in ("fp32_mantissa", "int32_native"):
        assert TACC.probe_exact(s, accum, device="cpu") == \
            JACC.probe_exact(s, accum)


def test_table1_rows_equal_jax_and_the_paper():
    rows = TACC.table1_rows(device="cpu")
    assert TACC.TABLE1_TARGETS == JACC.TABLE1_TARGETS
    assert rows == JACC.table1_rows()
    assert rows == {"tpu_v4_fp32_mantissa": PAPER_V4,
                    "tpu_v5_int32_native": PAPER_V5}


def test_probes_run_on_cuda_by_default():
    """Without ``device="cpu"`` the probes ask for CUDA and raise where
    there is none: nothing falls back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TACC.table1_rows()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TACC.probe_exact(2**24, "fp32_mantissa")


# --- Traced and scan staged transforms ----------------------------------------

# (accum, reduction, kappa, d_max): d_max = 48 cuts d = 200 into five passes,
# so κ = 2 pads the scan form to six.
MODES = [("fp32_mantissa", "eager", None, None),
         ("int32_native", "eager", None, 48),
         ("int32_native", "lazy", None, 48),
         ("int32_native", "lazy", 1, 48),
         ("int32_native", "lazy", 2, 48)]
FIELDS = [(Q, 3), (FIG3, 4)]


def _planes(m, limbs, d):
    """A random (d, d) matrix of residues (d need not be a power of two)
    and its per-plane plan."""
    w = _rows(d, d, m)
    plan = TG.make_channel_plan(w, m, data_limbs=limbs, tw_limbs=limbs,
                                fuse_below=0)
    return w, plan


def _variant_inputs(field, d, mode):
    m, limbs = field
    accum, reduction, kappa, d_max = mode
    w, plan = _planes(m, limbs, d)
    a = _rows(3, d, m)
    kw = dict(modulus=m, data_limbs=limbs, accum=accum, reduction=reduction,
              kappa=kappa, d_max=d_max)
    return (w, a, kw, (jnp.asarray(a), jnp.asarray(plan.w_planes)),
            (torch.as_tensor(a.astype(np.int64)),
             torch.as_tensor(plan.w_planes)))


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(map(str, m)))
@pytest.mark.parametrize("d", [64, 200, 256])
@pytest.mark.parametrize("field", FIELDS, ids=["dilithium", "fig3_4limb"])
def test_traced_and_scan_equal_jax(field, d, mode):
    """Both port forms equal JAX's traced form, the port's unrolled
    staged transform on a per-plane plan and the plain matrix oracle."""
    w, a, kw, jax_in, (ta, tw) = _variant_inputs(field, d, mode)
    want = np.asarray(JG.staged_transform_traced(*jax_in, **kw))
    traced = TG.staged_transform_traced(ta, tw, **kw)
    scan = TG.staged_transform_scan(ta, tw, **kw)
    assert traced.dtype == scan.dtype == torch.int64
    assert traced.shape == scan.shape == (3, d)
    assert np.array_equal(_u32(traced), want)
    assert np.array_equal(_u32(scan), want)
    m, limbs = field
    tplan = TG.make_channel_plan(w, m, data_limbs=limbs, tw_limbs=limbs,
                                 accum=kw["accum"], fuse_below=0)
    unrolled, _ = TG.staged_transform(ta, tplan, reduction=kw["reduction"],
                                      kappa=kw["kappa"], d_max=kw["d_max"])
    assert torch.equal(unrolled, traced)
    assert torch.equal(TG.matrix_transform_ref(ta, torch.as_tensor(
        w.astype(np.int64)), m), traced)


@pytest.mark.parametrize("mode", [MODES[0], MODES[2], MODES[4]],
                         ids=lambda m: "-".join(map(str, m)))
@pytest.mark.parametrize("field", FIELDS, ids=["dilithium", "fig3_4limb"])
def test_scan_equals_jax_scan(field, mode):
    """The port's scan form against JAX's ``lax.scan`` form itself (each
    call compiles a scan, so at the ragged d only): eager, one lazy window,
    and κ = 2, which pads five passes to six."""
    _, _, kw, jax_in, (ta, tw) = _variant_inputs(field, 200, mode)
    want = np.asarray(JG.staged_transform_scan(*jax_in, **kw))
    assert np.array_equal(_u32(TG.staged_transform_scan(ta, tw, **kw)), want)


def _w_and_a(m=Q, d=256, limbs=3):
    _, plan = _planes(m, limbs, d)
    a = np.zeros((1, d), np.uint32)
    return (jnp.asarray(a), jnp.asarray(plan.w_planes),
            torch.as_tensor(a.astype(np.int64)), torch.as_tensor(plan.w_planes))


def _message(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("variant", ["traced", "scan"])
@pytest.mark.parametrize("case,match", [
    # one pass wider than the fp32 ceiling (171 for three limbs)
    (dict(d_max=256), "per-pass ceiling"),
    # deferral depth with eager folds
    (dict(accum="int32_native", kappa=8), "requires reduction='lazy'"),
    # κ_max + 1: fp32 at the 171 tile has κ_max = 1
    (dict(reduction="lazy", kappa=2), "exceeds kappa_max=1"),
    # int32 at the 171 tile has κ_max = 128
    (dict(accum="int32_native", reduction="lazy", kappa=129, d_max=171),
     "exceeds kappa_max=128"),
    # one window over both passes is κ = 2 > κ_max = 1 under fp32
    (dict(reduction="lazy"), "exceeds kappa_max=1"),
], ids=["ceiling", "eager_kappa", "fp32_kappa_max_plus_1",
        "int32_kappa_max_plus_1", "fp32_one_window"])
def test_variants_raise_the_jax_messages(variant, case, match):
    ja, jw, ta, tw = _w_and_a()
    kw = dict(modulus=Q, data_limbs=3, **case)
    jfn = getattr(JG, f"staged_transform_{variant}")
    tfn = getattr(TG, f"staged_transform_{variant}")
    want = _message(lambda: jfn(ja, jw, **kw))
    assert match in want
    assert _message(lambda: tfn(ta, tw, **kw)) == want


def test_lazy_window_accumulator_overflow_raises():
    """A pass that would lift the pending window past the accumulator's
    window raises before anything is summed, as in the JAX package."""
    c, d_tile = 3, 171
    k_max = TACC.kappa_max("int32_native", d_tile, c)
    acc = TACC.LazyWindowAccumulator(Q, "int32_native", c, kappa=k_max + 1)
    jacc = JACC.LazyWindowAccumulator(Q, "int32_native", c, kappa=k_max + 1)
    diag = torch.zeros((1, 4, 5), dtype=torch.int32)
    for _ in range(k_max):
        acc.add(diag, d_tile)
        jacc.add(jnp.zeros((1, 4, 5), jnp.int32), d_tile)
    want = _message(lambda: jacc.add(jnp.zeros((1, 4, 5), jnp.int32), d_tile))
    assert "lazy window overflow" in want
    assert _message(lambda: acc.add(diag, d_tile)) == want


@pytest.mark.parametrize("d,mode,passes,padded,folds", [
    # (d, mode, unpadded passes, passes run by scan, folds of scan)
    (200, MODES[0], 2, 2, 2),
    (200, MODES[1], 5, 5, 5),
    (200, MODES[2], 5, 5, 1),
    (200, MODES[4], 5, 6, 3),
    (256, MODES[4], 6, 6, 3),
    (64, MODES[4], 2, 2, 1),
], ids=["fp32_eager", "int32_eager", "lazy_one_window", "lazy_k2_padded",
        "lazy_k2_even", "lazy_k2_d64"])
def test_launch_log_counts_k1_and_k2(d, mode, passes, padded, folds):
    """Every plane product is one K1 call and every fold one K2 call: the
    traced form runs the unrolled form's passes, the scan form its padded
    ones."""
    accum, reduction, kappa, d_max = mode
    _, plan = _planes(Q, 3, d)
    ta = torch.as_tensor(_rows(2, d, Q).astype(np.int64))
    tw = torch.as_tensor(plan.w_planes)
    kw = dict(modulus=Q, data_limbs=3, accum=accum, reduction=reduction,
              kappa=kappa, d_max=d_max)
    k_eff = padded // folds if reduction == "lazy" else 1
    unrolled_folds = passes if reduction == "eager" else -(-passes // k_eff)
    for fn, n_pass, n_fold in ((TG.staged_transform_traced, passes, unrolled_folds),
                               (TG.staged_transform_scan, padded, folds)):
        with Z.launch_log() as log:
            fn(ta, tw, **kw)
        kernels = [r.kernel for r in log.records]
        assert kernels.count("limb_matmul") == n_pass * 3 * 3
        assert kernels.count("mont_fold") == n_fold
        assert len(kernels) == n_pass * 9 + n_fold
        if reduction == "lazy":
            assert sum("vpu_fold_lazy" in r.path for r in log.records) == n_fold


# --- Cooley–Tukey, MORPH, the matrix oracle, the lax fold ---------------------


@pytest.mark.parametrize("negacyclic", [False, True])
@pytest.mark.parametrize("m", [Q, BIG])
@pytest.mark.parametrize("d", [8, 128])
def test_cooley_tukey_equals_jax_and_oracle(d, m, negacyclic):
    a = _rows(3, d, m)
    got = TNTT.cooley_tukey_ntt(torch.as_tensor(a.astype(np.int64)), m,
                                negacyclic=negacyclic)
    assert got.dtype == torch.int64 and got.shape == (3, d)
    want = np.asarray(jax.jit(lambda x: JNTT.cooley_tukey_ntt(
        x, m, negacyclic=negacyclic))(jnp.asarray(a)))
    assert np.array_equal(_u32(got), want)
    oracle = TNTT.cooley_tukey_oracle_np(a, m, negacyclic=negacyclic)
    assert np.array_equal(oracle, JNTT.cooley_tukey_oracle_np(
        a, m, negacyclic=negacyclic))
    assert np.array_equal(_u32(got), oracle)
    assert np.array_equal(TNTT._bit_reverse_perm(d), JNTT._bit_reverse_perm(d))
    for t, j in zip(TNTT._ct_stage_twiddles(d, m),
                    JNTT._ct_stage_twiddles(d, m), strict=True):
        assert t.dtype == j.dtype and np.array_equal(t, j)


@pytest.mark.parametrize("m", [Q, BIG])
def test_morph_stage_matrices_equal_jax_and_compose_to_the_ntt(m):
    d = 32
    mats = TNTT.morph_stage_matrices(d, m)
    jmats = JNTT.morph_stage_matrices(d, m)
    assert len(mats) == len(jmats) == 1 + 5
    for t, j in zip(mats, jmats):
        assert t.dtype == j.dtype == np.uint32 and np.array_equal(t, j)
    a = _rows(3, d, m)
    x = a.astype(object)
    for s in mats:
        x = (x @ s.astype(object)) % m
    ct = TNTT.cooley_tukey_ntt(torch.as_tensor(a.astype(np.int64)), m)
    assert np.array_equal(x.astype(np.uint32), _u32(ct))


@pytest.mark.parametrize("m", [Q, BIG])
def test_matrix_transform_ref_equals_jax(m):
    a = _rows(3, 24, m)
    w = _rows(24, 24, m)
    got = TG.matrix_transform_ref(torch.as_tensor(a.astype(np.int64)),
                                  torch.as_tensor(w.astype(np.int64)), m)
    want = np.asarray(JG.matrix_transform_ref(
        jnp.asarray(a), jnp.asarray(w), m))
    assert got.dtype == torch.int64
    assert np.array_equal(_u32(got), want)
    assert np.array_equal(_u32(got), JNTT.matrix_ntt_oracle_np(a, w, m))


@pytest.mark.parametrize("m", [2, Q, BIG, 2**31 - 1])
@pytest.mark.parametrize("n_diag", [1, 5, 7])
def test_fold_diagonals_lax_equals_jax(n_diag, m):
    diags = RNG.integers(-2**31, 2**31, (4, 33, n_diag), dtype=np.int64)
    edges = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 1])
    diags[0, :len(edges)] = edges[:, None]
    diags = diags.astype(np.int32)
    got = TMONT.fold_diagonals_lax(torch.as_tensor(diags), m)
    want = np.asarray(JMONT.fold_diagonals_lax(jnp.asarray(diags),
                                               jnp.uint32(m)))
    assert got.dtype == torch.int64
    assert np.array_equal(_u32(got), want)


def test_fig3_crossover_forms_agree():
    """The crossover's three forms at the Fig. 3 widths (4 × 4 limbs, fused
    below 1025, one row): Cooley–Tukey, the staged transform and the fused
    transform give the bignum oracle's residues, as in the JAX package."""
    d = 256
    a = _rows(1, d, FIG3)
    w = JNTT.ntt_matrix(d, FIG3)
    plan = TG.make_channel_plan(w, FIG3, data_limbs=4, tw_limbs=4,
                                fuse_below=1025)
    ta = torch.as_tensor(a.astype(np.int64))
    want = JNTT.cooley_tukey_oracle_np(a, FIG3)
    assert np.array_equal(_u32(TNTT.cooley_tukey_ntt(ta, FIG3)), want)
    assert np.array_equal(_u32(TG.staged_transform(ta, plan)[0]), want)
    assert np.array_equal(_u32(fused_transform(ta, plan)), want)
    jplan = JG.make_channel_plan(w, FIG3, data_limbs=4, tw_limbs=4,
                                 fuse_below=1025)
    assert np.array_equal(np.asarray(JG.staged_transform(
        jnp.asarray(a), jplan)[0]), want)

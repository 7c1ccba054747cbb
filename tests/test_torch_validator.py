"""The port's structural validator (``repro_torch.core.validator``) and zones
against the JAX package's (``repro.core.validator``).

Each case builds the same program in both packages from the same seeded
numpy inputs and validates it in each: the JAX side lowers and compiles it
and reads the HLO, the port runs it on the CPU under the launch log.  Held
equal: ``ok``, the set of violation codes, ``zones``, ``precision_zones``
and, where a case compares it, ``fold_census``'s ``n_fold_scopes`` and
``n_lazy_windows``.  The port's ``n_dots``/``n_folds``/``n_barriers`` are
held to the engine's fold profile (the JAX counts depend on XLA's fusion).
The matching of a launch log to a graph's kernel nodes, which runs on the
card, is checked on synthetic nodes and edges.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import field as JF
from repro.core import limb_gemm as JG
from repro.core import montgomery as JMONT
from repro.core import ntt as JNTT
from repro.core import validator as JV
from repro.core import workloads as JWK
from repro_torch.core import field as TF
from repro_torch.core import limb_gemm as TG
from repro_torch.core import validator as TV
from repro_torch.core import workloads as TWK
from repro_torch.core import zones as Z
from repro_torch.core.scheduler import coscheduler as TCOS
from repro_torch.kernels import graph_census as GC
from repro_torch.kernels.mont_fold.ops import mont_fold
from repro_torch.launch.serve import serve_crypto
from repro_torch.serve import CryptoServer, ServeConfig

Q = TF.DILITHIUM_Q
CPU = torch.device("cpu")


def _codes(rep) -> set:
    return {v[0] for v in rep.violations}


def _assert_same(jrep, trep):
    """The parity the port owes the JAX validator on one program."""
    assert (trep.ok, _codes(trep)) == (jrep.ok, _codes(jrep)), (
        jrep.violations, trep.violations)
    assert trep.zones == jrep.zones
    assert trep.precision_zones == jrep.precision_zones


def _assert_profile(trep, eng):
    """n_dots/n_folds/n_barriers from the fold profile: a GEMM per pass and
    channel, a fold per window and channel, a fold → next-GEMM path between
    consecutive windows of a channel."""
    fp = eng.fold_profile
    assert trep.n_dots == fp["n_passes"] * fp["n_channels"]
    assert trep.n_folds == fp["n_folds"]
    assert trep.n_barriers == fp["n_folds"] - fp["n_channels"]
    assert trep.graph is None          # the CPU reads the log, not a graph


def _zeros(shape):
    return jnp.zeros(shape, jnp.uint32), torch.zeros(shape, dtype=torch.int32)


# --- engines accepted ------------------------------------------------------------


def test_eager_dilithium_three_passes_accepted():
    jeng, teng = JWK.DilithiumEngine(512), TWK.DilithiumEngine(512, device="cpu")
    assert teng.n_passes == 3
    ja, ta = _zeros((8, 512))
    jrep = JV.validate_fn(jeng.evaluate, ja, expected_passes=3)
    trep = TV.validate_fn(teng.e2e, ta, expected_passes=3)
    _assert_same(jrep, trep)
    assert trep.ok and trep.zones == {"wzone_dilithium"}
    _assert_profile(trep, teng)
    jc, tc = JV.fold_census(jeng.evaluate, ja), TV.fold_census(teng.e2e, ta)
    assert (tc["n_fold_scopes"], tc["n_lazy_windows"]) == \
        (jc["n_fold_scopes"], jc["n_lazy_windows"]) == (3, 0)


@pytest.mark.parametrize("kappa,windows", [(2, 2), (4, 1)])
def test_lazy_kappa_windows_accepted(kappa, windows):
    kw = dict(accum="int32_native", reduction="lazy", kappa=kappa, d_tile=32)
    jeng = JWK.DilithiumEngine(128, **kw)
    teng = TWK.DilithiumEngine(128, device="cpu", **kw)
    assert teng.fold_profile["n_folds"] == windows
    checks = dict(expect_eager=False, expected_windows=windows,
                  n_diag=teng.n_diag)
    ja, ta = _zeros((2, 128))
    jrep = JV.validate_fn(jeng.evaluate, ja, **checks)
    trep = TV.validate_fn(teng.e2e, ta, **checks)
    _assert_same(jrep, trep)
    assert trep.ok
    _assert_profile(trep, teng)
    jc, tc = JV.fold_census(jeng.evaluate, ja), TV.fold_census(teng.e2e, ta)
    assert (tc["n_fold_scopes"], tc["n_lazy_windows"]) == \
        (jc["n_fold_scopes"], jc["n_lazy_windows"]) == (windows, windows)


def test_bn254_nine_channels_accepted():
    """BN254 d = 64: one pass on each of 9 channels, then rns_to_field under
    ``wzone_bn254/vpu_montgomery``; its kernels are no summation window."""
    jeng, teng = JWK.BN254Engine(64), TWK.BN254Engine(64, device="cpu")
    ja, ta = _zeros((8, 64, 9))
    jrep = JV.validate_fn(jeng.e2e, ja, expected_passes=1)
    trep = TV.validate_fn(teng.e2e, ta, expected_passes=1)
    _assert_same(jrep, trep)
    assert trep.ok and trep.precision_zones == {"pzone_4limb"}
    _assert_profile(trep, teng)


def test_gemm_under_vpu_montgomery_is_no_summation_window():
    """A K1 call under ``vpu_montgomery`` between two passes of a channel
    would be an open summation if it counted; it is skipped, as the JAX V1
    skips the Montgomery matmuls."""
    teng = TWK.DilithiumEngine(256, device="cpu")
    plan = teng.plan
    _, fused = TG.plane_operands(plan, CPU)

    def fn(a):
        y = teng.e2e(a)
        with Z.workload_zone("dilithium"), Z.precision_zone(3), \
                Z.scope("vpu_montgomery"):
            TG.tile_diagonals(a, None, fused, plan)
        return y

    rep = TV.validate_fn(fn, torch.zeros((4, 256), dtype=torch.int32),
                         expected_passes=2)
    assert rep.ok, rep.violations
    assert (rep.n_dots, rep.n_folds, rep.n_barriers) == (3, 2, 1)


def test_dilithium_and_bn254_zones_in_one_function_accepted():
    """The JAX package's zone-separated program: a Dilithium engine, then
    work in the BN254 zones (after an optimization barrier on the JAX
    side); both zones are seen and nothing mixes them."""
    jd, td = JWK.DilithiumEngine(256), TWK.DilithiumEngine(256, device="cpu")

    def jfn(a, b):
        y1 = jd.evaluate(a)
        y1, b = jax.lax.optimization_barrier((y1, b))
        with jax.named_scope("wzone_bn254"), jax.named_scope("pzone_4limb"):
            y2 = b * jnp.uint32(2)
        return y1, y2

    def tfn(a, b):
        y1 = td.e2e(a)
        with Z.workload_zone("bn254"), Z.precision_zone(4):
            y2 = b * 2
        return y1, y2

    (ja, ta), (jb, tb) = _zeros((4, 256)), _zeros((4, 256))
    jrep = JV.validate_fn(jfn, ja, jb, expected_passes=2)
    trep = TV.validate_fn(tfn, ta, tb, expected_passes=2)
    _assert_same(jrep, trep)
    assert trep.ok and trep.zones == {"wzone_dilithium", "wzone_bn254"}
    assert trep.precision_zones == {"pzone_3limb", "pzone_4limb"}
    assert (trep.n_dots, trep.n_folds, trep.n_barriers) == (2, 2, 1)


def test_dilithium_and_bn254_engines_in_one_function_accepted():
    """Both engines' transforms in one program: each K node in its own
    zones, no read across them.  (The JAX validator flags the same pair in
    one module, V3/V4: XLA fuses across the two zones there, which the port
    cannot do.)"""
    td, tb = (TWK.DilithiumEngine(256, device="cpu"),
              TWK.BN254Engine(64, device="cpu"))
    rep = TV.validate_fn(lambda a, b: (td.e2e(a), tb.evaluate(b)),
                         torch.zeros((4, 256), dtype=torch.int32),
                         torch.zeros((4, 64, 9), dtype=torch.int32),
                         expected_passes=2)
    assert rep.ok, rep.violations
    assert rep.zones == {"wzone_dilithium", "wzone_bn254"}
    assert rep.precision_zones == {"pzone_3limb", "pzone_4limb"}
    assert (rep.n_dots, rep.n_folds, rep.n_barriers) == (2 + 9, 2 + 9, 1)


# --- malformed programs flagged --------------------------------------------------


def _plans(d: int, accum="fp32_mantissa"):
    """The same channel plan in both packages (Dilithium's negacyclic NTT
    matrix) and the port's fused operand."""
    w = JNTT.ntt_matrix(d, Q, negacyclic=True)
    jplan = JG.make_channel_plan(w, Q, data_limbs=3, tw_limbs=3, accum=accum)
    tplan = TG.make_channel_plan(w, Q, data_limbs=3, tw_limbs=3, accum=accum)
    return jplan, tplan, torch.as_tensor(tplan.fused_operand)


def test_deferred_fold_staged_function_flagged_v1_v2():
    """Every pass's GEMM before any fold: an open summation (V1) and no
    fold → next-GEMM ordering (V2)."""
    d_tile = 32
    jplan, tplan, fused = _plans(96)
    tiles = tplan.tile_bounds(d_tile)
    m = jnp.uint32(Q)

    def jfn(a):
        with jax.named_scope("wzone_dilithium"), jax.named_scope("pzone_3limb"):
            diags = []
            for t, (lo, hi) in enumerate(tiles):
                with jax.named_scope(f"staging_pass_{t}"):
                    diags.append(JG.tile_diagonals(
                        a[:, lo:hi], None,
                        jnp.asarray(jplan.fused_operand[lo * 3:hi * 3]), jplan))
            y = jnp.zeros((a.shape[0], jplan.d), jnp.uint32)
            for t, diag in enumerate(diags):
                with jax.named_scope(f"staging_pass_{t}"), \
                        jax.named_scope("vpu_fold"):
                    y = JF.addmod_u32(y, JF.fold_diagonals_u32(diag, m), m)
        return y

    def tfn(a):
        with Z.workload_zone("dilithium"), Z.precision_zone(3):
            diags = []
            for t, (lo, hi) in enumerate(tiles):
                with Z.scope(f"staging_pass_{t}"):
                    diags.append(TG.tile_diagonals(
                        a[:, lo:hi], None, fused[lo * 3:hi * 3], tplan))
            y = torch.zeros((a.shape[0], tplan.d), dtype=torch.int64)
            for t, diag in enumerate(diags):
                with Z.scope(f"staging_pass_{t}"), Z.scope("vpu_fold"):
                    y = TF.addmod(y, mont_fold(diag, Q), Q)
        return y

    ja, ta = _zeros((2, 96))
    jrep = JV.validate_fn(jfn, ja, expected_passes=len(tiles))
    trep = TV.validate_fn(tfn, ta, expected_passes=len(tiles))
    _assert_same(jrep, trep)
    assert _codes(trep) == {"V1", "V2"}
    with pytest.raises(TV.ValidationError):
        trep.raise_if_failed()


def test_double_fold_window_flagged_v7():
    jplan, tplan, fused = _plans(64, "int32_native")
    m = jnp.uint32(Q)

    def jfn(x):
        with jax.named_scope("wzone_dilithium"), jax.named_scope("pzone_3limb"):
            diag = JG.tile_diagonals(x, None, jnp.asarray(jplan.fused_operand),
                                     jplan)
            with jax.named_scope("lazy_window_0"), \
                    jax.named_scope("vpu_fold_lazy"):
                y1 = JMONT.fold_diagonals_lax(diag, m)
                y2 = JMONT.fold_diagonals_lax(diag + jnp.int32(1), m)
            return JF.addmod_u32(y1, y2, m)

    def tfn(x):
        with Z.workload_zone("dilithium"), Z.precision_zone(3):
            diag = TG.tile_diagonals(x, None, fused, tplan)
            with Z.scope("lazy_window_0"), Z.scope("vpu_fold_lazy"):
                y1 = mont_fold(diag, Q)
                y2 = mont_fold(diag + 1, Q)
            return TF.addmod(y1, y2, Q)

    checks = dict(expect_eager=False, expected_windows=1, n_diag=tplan.n_diag)
    ja, ta = _zeros((2, 64))
    jrep = JV.validate_fn(jfn, ja, **checks)
    trep = TV.validate_fn(tfn, ta, **checks)
    _assert_same(jrep, trep)
    assert _codes(trep) == {"V7"}
    jc, tc = JV.fold_census(jfn, ja), TV.fold_census(tfn, ta)
    assert (tc["n_fold_scopes"], tc["n_lazy_windows"]) == \
        (jc["n_fold_scopes"], jc["n_lazy_windows"]) == (1, 1)


def test_eager_folds_in_a_lazy_program_flagged_v6():
    d_tile = 32
    jplan, tplan, fused = _plans(96, "int32_native")

    def jfn(x):
        with jax.named_scope("wzone_dilithium"), jax.named_scope("pzone_3limb"):
            return JG.staged_transform(x, jplan, reduction="eager",
                                       d_max=d_tile)[0]

    def tfn(x):
        with Z.workload_zone("dilithium"), Z.precision_zone(3):
            return TG.staged_transform(x, tplan, reduction="eager",
                                       d_max=d_tile, planes=(None, fused))[0]

    checks = dict(expect_eager=False, expected_windows=1, n_diag=tplan.n_diag)
    ja, ta = _zeros((2, 96))
    jrep = JV.validate_fn(jfn, ja, **checks)
    trep = TV.validate_fn(tfn, ta, **checks)
    _assert_same(jrep, trep)
    assert _codes(trep) == {"V6"}
    jc, tc = JV.fold_census(jfn, ja), TV.fold_census(tfn, ta)
    assert (tc["n_fold_scopes"], tc["n_lazy_windows"]) == \
        (jc["n_fold_scopes"], jc["n_lazy_windows"]) == (3, 0)


def test_cross_zone_combine_flagged_v3():
    """A fold in the BN254 zone of the Dilithium zone's GEMM: XLA fuses the
    two zones' ops (JAX V3); in the port the fold reads what a kernel of
    another zone wrote (V3)."""
    jplan, tplan, fused = _plans(64)
    m = jnp.uint32(Q)

    def jfn(x):
        with jax.named_scope("wzone_dilithium"), jax.named_scope("pzone_3limb"):
            diag = JG.tile_diagonals(x, None, jnp.asarray(jplan.fused_operand),
                                     jplan)
        with jax.named_scope("wzone_bn254"), jax.named_scope("pzone_3limb"):
            return JF.fold_diagonals_u32(diag, m)

    def tfn(x):
        with Z.workload_zone("dilithium"), Z.precision_zone(3):
            diag = TG.tile_diagonals(x, None, fused, tplan)
        with Z.workload_zone("bn254"), Z.precision_zone(3):
            return mont_fold(diag, Q)

    ja, ta = _zeros((2, 64))
    jrep = JV.validate_fn(jfn, ja, expect_eager=False)
    trep = TV.validate_fn(tfn, ta, expect_eager=False)
    _assert_same(jrep, trep)
    assert _codes(trep) == {"V3"}


def test_kernel_outside_a_zone_flagged_v3_v4():
    """Every K node carries exactly one workload and one precision zone."""
    _, tplan, fused = _plans(64)
    rep = TV.validate_fn(lambda x: TG.tile_diagonals(x, None, fused, tplan),
                         torch.zeros((2, 64), dtype=torch.int32),
                         expect_eager=False)
    assert _codes(rep) == {"V3", "V4"} and rep.zones == set()


def test_donation_in_a_multi_zone_program_flagged_v5():
    td, tb = (TWK.DilithiumEngine(256, device="cpu"),
              TWK.BN254Engine(64, device="cpu"))
    args = (torch.zeros((2, 256), dtype=torch.int32),
            torch.zeros((2, 64, 9), dtype=torch.int32))
    rep = TV.validate_fn(lambda a, b: (td.e2e(a), tb.evaluate(b)), *args,
                         donate_argnums=(0,))
    assert _codes(rep) == {"V5"}


# --- the co-scheduler's programs (V5) and the server's wiring --------------------


def test_disjoint_programs_across_workloads():
    cos = TCOS.SliceCoScheduler(device="cpu")
    dil = cos.capture("dilithium", 256, cos.operand_shape("dilithium", 256, 2))
    bn = cos.capture("bn254", 16, cos.operand_shape("bn254", 16, 2))
    assert TV.disjoint_programs([("dilithium", dil), ("bn254", bn)]) == []
    bn.static_in = dil.static_out.view(-1)[:1]       # one shared word
    assert {v[0] for v in TV.disjoint_programs(
        [("dilithium", dil), ("bn254", bn)])} == {"V5"}


def test_eager_run_that_writes_off_the_cpu_refused():
    """A function whose first tensor argument lies on the CPU but whose
    kernels write elsewhere (a closure over device tensors) is not taken as
    an eager CPU program: on the card its call order is not its completion
    order, so only its captured graph may be validated."""
    out = torch.empty(4, dtype=torch.int32, device="meta")

    def writes_off_cpu(a):
        with Z.workload_zone("dilithium"), Z.precision_zone(3):
            Z.record_launch("mont_fold", [a], out, n_out=4, n_diag=1,
                            modulus=Q)

    with pytest.raises(ValueError, match="captured graph"):
        TV.validate_fn(writes_off_cpu, torch.zeros((4, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="captured graph"):
        TV.fold_census(lambda: writes_off_cpu(torch.zeros(4)))


def _deferred_e2e(eng):
    """``eng.e2e`` with every pass's GEMM before any fold: the same kernel
    calls as the eager schedule (the census passes), out of order."""
    plan = eng.plan

    def e2e(a, *, planes=None, **_):
        _, fused = (planes or eng.device_planes())[0]
        a = a.to(torch.int64)
        with Z.workload_zone("dilithium"), Z.precision_zone(3):
            diags = []
            for t, (lo, hi) in enumerate(plan.tile_bounds(eng.d_tile)):
                with Z.scope(f"staging_pass_{t}"):
                    diags.append(TG.tile_diagonals(a[:, lo:hi], None,
                                                   fused[lo * 3:hi * 3], plan))
            y = torch.zeros((a.shape[0], plan.d), dtype=torch.int64)
            for t, diag in enumerate(diags):
                with Z.scope(f"staging_pass_{t}"), Z.scope("vpu_fold"):
                    y = TF.addmod(y, mont_fold(diag, Q), Q)
        return y

    return e2e


def _dilithium_batches(n_c=4, d=512):
    from repro_torch.core.scheduler import RectangularScheduler, TenantRequest
    rng = np.random.default_rng(3)
    reqs = [TenantRequest(i, "dilithium", d, 0.0,
                          rng.integers(0, Q, d, dtype=np.uint64)
                          .astype(np.uint32)) for i in range(n_c)]
    return RectangularScheduler(n_c=n_c).plan_batches(reqs)


def test_server_validation_marks_the_class_and_aborts_on_a_violation(
        monkeypatch):
    cos = TCOS.SliceCoScheduler(device="cpu")
    server = CryptoServer(ServeConfig(validate=True, n_c=4), coscheduler=cos)
    (batch,) = _dilithium_batches()
    server._validate_once(batch)
    assert ("dilithium", 512) in server._validated
    eng = cos.engine_for("dilithium", 512)
    monkeypatch.setattr(eng, "e2e", _deferred_e2e(eng))
    fresh = CryptoServer(ServeConfig(validate=True, n_c=4), coscheduler=cos)
    with pytest.raises(TV.ValidationError, match=r"\[V1\]"):
        fresh._validate_once(batch)
    assert ("dilithium", 512) not in fresh._validated


def test_serve_crypto_aborts_on_a_violation(monkeypatch):
    cos = TCOS.SliceCoScheduler(device="cpu")
    eng = cos.engine_for("dilithium", 256)
    monkeypatch.setattr(eng, "e2e", _deferred_e2e(eng))
    with pytest.raises(TV.ValidationError, match=r"\[V2\]"):
        serve_crypto(coscheduler=cos, validate=True, duration_s=0.005,
                     rate_hz=1024, seed=2, d_uniform=256)
    assert not cos.trace_counts            # nothing dispatched unvalidated


# --- zones and the launch log ----------------------------------------------------


def test_scopes_nest_into_a_path_and_tag_each_kernel_call():
    _, tplan, fused = _plans(64)
    a = torch.zeros((2, 64), dtype=torch.int64)
    with Z.launch_log() as log:
        with Z.workload_zone("dilithium"), Z.precision_zone(3), \
                Z.tenant_zone(7), Z.scope("channel_0"):
            assert Z.current_path() == \
                "wzone_dilithium/pzone_3limb/tzone_7/channel_0"
            diag = TG.tile_diagonals(a, None, fused, tplan)
        mont_fold(diag[:0], Q)                           # empty: no record
        mont_fold(diag, Q)
        assert log._held                                 # outputs held
    assert Z.current_path() == ""
    assert not log._held                                 # released at exit
    k1, k2 = log.records
    assert (k1.kernel, k1.path) == (
        "limb_matmul", "wzone_dilithium/pzone_3limb/tzone_7/channel_0/"
        "mxu_pointwise")
    assert k1.args == {"n": 2, "k": 192, "m": 64 * 5, "fp32": True}
    assert (k2.kernel, k2.path, k2.args) == (
        "mont_fold", "", {"n_out": 128, "n_diag": 5, "modulus": Q})
    assert k2.reads == ((diag.data_ptr(), diag.numel() * 4),)
    assert k1.writes[0][0] == diag.data_ptr()


def test_no_log_records_nothing():
    a = torch.zeros((2, 5), dtype=torch.int32)
    with Z.launch_log() as log:
        pass
    mont_fold(a, Q)
    assert log.records == []


# --- matching a launch log to a graph's nodes (synthetic graphs) -----------------

_K1_PATH = "wzone_dilithium/pzone_3limb/staging_pass_{t}/mxu_pointwise"
_K2_PATH = "wzone_dilithium/pzone_3limb/staging_pass_{t}/vpu_fold"


def _synthetic(passes=2):
    """Records and graph nodes of an eager two-pass program: per pass K1
    (buffers 0x1000·t + ...) then K2, with one PyTorch kernel (addmod)
    after each fold; nodes in topological order, a full-edge chain except
    the programmatic K1 → K2 edge each fold's launch leaves."""
    records, nodes, edges = [], [], []
    for t in range(passes):
        base = 0x100000 * (t + 1)
        k1 = Z.LaunchRecord("limb_matmul", _K1_PATH.format(t=t),
                            ((base, 64), (base + 0x1000, 64)),
                            ((base + 0x2000, 64),),
                            {"n": 2, "k": 32, "m": 8, "fp32": True})
        k2 = Z.LaunchRecord("mont_fold", _K2_PATH.format(t=t),
                            ((base + 0x2000, 64),), ((base + 0x3000, 8),),
                            {"n_out": 2, "n_diag": 4, "modulus": Q})
        for rec in (k1, k2):
            records.append(rec)
            nodes.append(GC.Node(rec.kernel, rec.args,
                                 tuple(a for a, _ in rec.reads + rec.writes)))
        nodes.append(GC.Node(None, {"type": "kernel"}))       # addmod
    for i in range(len(nodes) - 1):
        prog = nodes[i].kernel == "limb_matmul"               # K1 -> K2
        edges.append((i, i + 1, prog))
    return records, nodes, edges


def test_synthetic_graph_matches_its_log():
    records, nodes, edges = _synthetic()
    rep, _ = TV.check(records, nodes, edges, expected_passes=2)
    assert rep.ok, rep.violations
    assert (rep.n_dots, rep.n_folds, rep.n_barriers) == (2, 2, 1)


_CH_PATH = "wzone_bn254/pzone_4limb/channel_{c}/staging_pass_{t}/{leaf}"


def _interleaved_channels(passes=2, channels=2):
    """Records and graph nodes of an eager program of two channels whose
    passes interleave on one chain, as one stream captures them: per pass
    and channel K1 then K2 (a programmatic edge K1 -> K2, as K2's launch
    leaves) then an addmod, full edges elsewhere.  The only path from a
    channel's fold to its next pass's GEMM runs through the other
    channel's programmatic K1 -> K2 edge."""
    records, nodes = [], []
    for t in range(passes):
        for c in range(channels):
            base = 0x100000 * (1 + t * channels + c)
            k1 = Z.LaunchRecord(
                "limb_matmul", _CH_PATH.format(c=c, t=t, leaf="mxu_pointwise"),
                ((base, 64), (base + 0x1000, 64)), ((base + 0x2000, 64),),
                {"n": 2, "k": 32, "m": 8, "fp32": True})
            k2 = Z.LaunchRecord(
                "mont_fold", _CH_PATH.format(c=c, t=t, leaf="vpu_fold"),
                ((base + 0x2000, 64),), ((base + 0x3000, 8),),
                {"n_out": 2, "n_diag": 4, "modulus": Q})
            for rec in (k1, k2):
                records.append(rec)
                nodes.append(GC.Node(rec.kernel, rec.args, tuple(
                    a for a, _ in rec.reads + rec.writes)))
            nodes.append(GC.Node(None, {"type": "kernel"}))   # addmod
    edges = [(i, i + 1, nodes[i].kernel == "limb_matmul")
             for i in range(len(nodes) - 1)]
    return records, nodes, edges


def test_programmatic_edge_into_k2_orders_it():
    """A programmatic edge into K2 is an ordering edge (K2 waits for its
    predecessor), so a fold → next-GEMM path through one is a barrier; the
    same path through a programmatic edge into a K1 is none."""
    records, nodes, edges = _interleaved_channels()
    # channel 0's pass-0 fold (1) reaches its pass-1 GEMM (6) only through
    # channel 1's programmatic edge 3 -> 4 into K2
    assert (3, 4, True) in edges and nodes[4].kernel == "mont_fold"
    rep, _ = TV.check(records, nodes, edges, expected_passes=2)
    assert rep.ok, rep.violations
    assert (rep.n_dots, rep.n_folds, rep.n_barriers) == (4, 4, 2)
    # make the edge from channel 0's addmod into channel 1's K1 (2 -> 3)
    # programmatic: channel 0 loses its only barrier
    edges = [(s, d, True) if (s, d) == (2, 3) else (s, d, p)
             for s, d, p in edges]
    rep, _ = TV.check(records, nodes, edges, expected_passes=2)
    assert _codes(rep) == {"V2"} and rep.n_barriers == 1
    assert any("programmatic edge 2 -> 3 into limb_matmul" in v[1]
               for v in rep.violations)


def test_missing_node_flagged():
    records, nodes, edges = _synthetic()
    nodes[4] = GC.Node(None, {"type": "kernel"})       # pass 1's K2 gone
    rep, _ = TV.check(records, nodes, edges, expected_passes=2)
    assert _codes(rep) == {"match"}
    assert "has no node in the graph" in rep.violations[0][1]


def test_extra_node_flagged():
    records, nodes, edges = _synthetic()
    rep, _ = TV.check(records[:-1], nodes, edges, expected_passes=2)
    assert _codes(rep) == {"match"}
    assert "has no launch record" in rep.violations[0][1]


def test_programmatic_only_edge_into_k1_flagged_v2():
    """K1 executes no griddepcontrol.wait: a programmatic edge into it does
    not order it after the previous fold's consumer."""
    records, nodes, edges = _synthetic()
    edges = [(s, d, True) if d == 3 else (s, d, p) for s, d, p in edges]
    rep, _ = TV.check(records, nodes, edges, expected_passes=2)
    assert _codes(rep) == {"V2"}
    assert rep.n_barriers == 0


def test_validate_probe_checks_a_probes_log_against_its_graph():
    """``validate_probe`` reads what a ``GraphProbe`` holds (the capture's
    launch log and the reader's census) as ``validate_fn`` does on the
    card: here a probe of the synthetic program, then the same with a node
    its log lacks."""
    import types
    records, nodes, edges = _synthetic()
    log = types.SimpleNamespace(records=records,
                                scopes={"wzone_dilithium", "pzone_3limb"})
    stats = {"kernel_nodes": {"limb_matmul": 2, "mont_fold": 2}}
    probe = types.SimpleNamespace(
        log=log, census=GC.GraphCensus(nodes, edges, stats), read_s=0.5)
    rep = TV.validate_probe(probe, expected_passes=2)
    assert rep.ok, rep.violations
    assert (rep.n_dots, rep.n_folds, rep.n_barriers) == (2, 2, 1)
    assert rep.zones == {"wzone_dilithium"}
    assert rep.graph == dict(stats, read_s=0.5)
    log.records = records[:-1]
    assert _codes(TV.validate_probe(probe, expected_passes=2)) == {"match"}


def test_unreadable_kernel_nodes_flagged():
    records, nodes, edges = _synthetic()
    rep, _ = TV.check(records, nodes, edges, expected_passes=2,
                      graph={"matched_by": {"unreadable": 2}})
    assert _codes(rep) == {"match"}


def test_graph_reader_rows_become_nodes_and_a_summary():
    """The reader's rows (csrc/graph_census.cu) as the binding decodes them:
    a K1, a K2 and a K3 node, another kernel (whose parameters could not
    be read) and a memcpy node, one full and one programmatic edge."""
    info = np.zeros((5, GC.NODE_INTS), np.int32)
    info[0, [GC.T_KERNEL, GC.T_FP32, GC.T_N, GC.T_K, GC.T_M, GC.T_MATCH]] = \
        [1, 1, 8, 513, 1280, 1]
    info[1, [GC.T_KERNEL, GC.T_NDIAG, GC.T_N, GC.T_MODULUS, GC.T_MATCH]] = \
        [2, 5, 2048, Q, 1]
    info[2, [GC.T_KERNEL, GC.T_NDIAG, GC.T_N, GC.T_K, GC.T_M, GC.T_MODULUS,
             GC.T_MATCH]] = [3, 7, 8, 512, 256, 2**31 - 1, 1]
    info[3, GC.T_MATCH] = -1
    info[4, GC.T_TYPE] = 1
    ptrs = np.arange(15, dtype=np.uint64).reshape(5, 3)
    nodes = [GC._node(r, p) for r, p in zip(info, ptrs)]
    assert nodes[0] == GC.Node("limb_matmul", {"n": 8, "k": 513, "m": 1280,
                                               "fp32": True}, (0, 1, 2))
    assert nodes[1] == GC.Node("mont_fold", {"n_out": 2048, "n_diag": 5,
                                             "modulus": Q}, (3, 4))
    assert nodes[2].args["modulus"] == 2**31 - 1 and nodes[2].ptrs == (6, 7, 8)
    assert nodes[3] == GC.Node(None, {"type": "kernel"})
    assert nodes[4] == GC.Node(None, {"type": "memcpy"})
    edges = np.array([[0, 1, 1, 1], [1, 2, 0, 0]], np.int32)
    stats = GC.summary(info, edges)
    assert stats["kernel_nodes"] == {"limb_matmul": 1, "mont_fold": 1,
                                     "fused_ntt_tile": 1, "other": 1}
    assert stats["other_nodes"] == {"memcpy": 1}
    assert stats["matched_by"] == {"host_stub": 3, "unreadable": 1}
    assert stats["edges"] == {"full": 1, "programmatic": 1}


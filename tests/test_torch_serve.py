"""Offline multi-tenant replay: the PyTorch port (CPU) vs the JAX package.

Same Poisson trace and payloads through both ``serve_crypto`` functions;
every tenant row must match bit for bit.  Also the port's launch census,
and the co-scheduler's ladder / merge / gather routing against the JAX
co-scheduler's.
"""
import numpy as np
import pytest
import torch

from repro.core import field as JF
from repro.core.scheduler import RectangularScheduler as JRect
from repro.core.scheduler import TenantRequest as JReq
from repro.core.scheduler import coscheduler as JCOS
from repro.launch.serve import serve_crypto as j_serve_crypto
from repro.serve.client import attach_payloads as j_attach
from repro_torch import device as TD
from repro_torch.core.scheduler import PoissonTrace
from repro_torch.core.scheduler import RectangularScheduler as TRect
from repro_torch.core.scheduler import TenantRequest as TReq
from repro_torch.core.scheduler import coscheduler as TCOS
from repro_torch.launch.serve import serve_crypto
from repro_torch.serve.client import LoadGenerator, attach_payloads

# One JAX co-scheduler per configuration for the module, as
# tests/test_serve_runtime.py shares one: its compiled programs are reused.
J_COS = JCOS.SliceCoScheduler()
MIXED = dict(accum="int32_native", d_tile=171,
             reduction_by_workload={"dilithium": "lazy"})
J_MIXED = JCOS.SliceCoScheduler(**MIXED)
TRACE = dict(duration_s=0.01, rate_hz=1024, seed=5)


def _rows(results):
    out = {}
    for r in results:
        out.update(r.outputs)
    return out


def _assert_same_rows(port, ref):
    assert set(port) == set(ref) and ref
    for tid, row in ref.items():
        assert port[tid].dtype == np.uint32
        np.testing.assert_array_equal(port[tid], row)


def test_payloads_are_byte_identical_to_jax():
    kw = dict(rate_hz=2048, duration_s=0.01, seed=3)
    from repro.core.scheduler import PoissonTrace as JTrace
    jt = j_attach(JTrace(**kw).generate(), seed=3)
    tt = attach_payloads(PoissonTrace(**kw).generate(), seed=3)
    assert len(jt) == len(tt) > 0
    for a, b in zip(jt, tt):
        assert (a.tenant_id, a.workload, a.degree, a.arrival_time) == \
            (b.tenant_id, b.workload, b.degree, b.arrival_time)
        assert a.coeffs.dtype == b.coeffs.dtype
        np.testing.assert_array_equal(a.coeffs, b.coeffs)
    assert len(LoadGenerator(PoissonTrace(**kw), seed=3).trace) == len(tt)


def test_serve_crypto_matches_jax_per_tenant():
    j_res, j_ops, _ = j_serve_crypto(validate=False, coscheduler=J_COS,
                                     **TRACE)
    t_res, t_ops, _ = serve_crypto(device="cpu", **TRACE)
    assert t_ops == j_ops and len(t_res) == len(j_res)
    _assert_same_rows(_rows(t_res), _rows(j_res))
    assert {r.batch.workload for r in t_res} == {"dilithium", "bn254"}
    for tr, jr in zip(t_res, j_res):
        assert tr.stats == jr.stats


def test_serve_crypto_mixed_eager_lazy_matches_jax():
    kw = dict(TRACE, seed=11, d_uniform=256)
    j_res, _, _ = j_serve_crypto(validate=False, coscheduler=J_MIXED, **kw)
    cos = TCOS.SliceCoScheduler(device="cpu", **MIXED)
    t_res, _, _ = serve_crypto(coscheduler=cos, **kw)
    _assert_same_rows(_rows(t_res), _rows(j_res))
    dil = [r for r in t_res if r.batch.workload == "dilithium"]
    assert dil and all(r.stats["reduction"] == "lazy"
                       and r.stats["n_folds"] == 1 for r in dil)


def test_launch_census_passes_and_catches_a_tampered_profile(monkeypatch):
    cos = TCOS.SliceCoScheduler(device="cpu", **MIXED)
    serve_crypto(coscheduler=cos, validate=True, duration_s=0.005,
                 rate_hz=1024, seed=2, d_uniform=256)
    eng = cos.engine_for("dilithium", 256)
    assert TCOS.expected_kernel_calls(eng) == (2, 1)     # 2 passes, 1 window
    monkeypatch.setitem(eng.fold_profile, "n_folds", 2)
    fresh = TCOS.SliceCoScheduler(device="cpu", **MIXED)
    with pytest.raises(RuntimeError, match="launch census"):
        serve_crypto(coscheduler=fresh, validate=True, duration_s=0.005,
                     rate_hz=1024, seed=2, d_uniform=256)


def _requests(cls, n, d, seed):
    rng = np.random.default_rng(seed)
    return [cls(i, "dilithium", d - (i % 3), 0.0,
                rng.integers(0, JF.DILITHIUM_Q, d - (i % 3),
                             dtype=np.uint64).astype(np.uint32))
            for i in range(n)]


def test_ladder_merge_and_gather_routing_match_jax():
    """Ladder-padded, merged launches route rows back to the same tenants
    and batches as the JAX co-scheduler, with the same dispatch records and
    the same per-class shape counts."""
    ladder = (4, 8)
    jc = JCOS.SliceCoScheduler(row_ladder=ladder)
    tc = TCOS.SliceCoScheduler(row_ladder=ladder, device="cpu")
    j_b = JRect(n_c=3).plan_batches(_requests(JReq, 10, 64, 1))
    t_b = TRect(n_c=3).plan_batches(_requests(TReq, 10, 64, 1))
    assert [b.n_c for b in t_b] == [3, 3, 3, 1]
    j_out = jc.dispatch_mixed(j_b)
    flight = tc.launch_mixed(t_b)
    # 3 + 3 merge into the 8-row rung; the third batch overflows it and
    # merges with the last into the 4-row rung
    assert [g[0].operand_rows for g in flight.groups] == [6, 4]
    t_out = tc.gather(flight)
    for i, (jr, tr) in enumerate(zip(j_out, t_out)):
        assert tr.batch is t_b[i]
        np.testing.assert_array_equal(tr.rows, jr.rows)
        _assert_same_rows(tr.outputs, jr.outputs)
    keys = ("workload", "d_bucket", "n_batches", "live_rows",
            "launched_rows", "donated")
    assert [{k: r[k] for k in keys} for r in tc.drain_dispatch_log()] == \
        [{k: r[k] for k in keys} for r in jc.drain_dispatch_log()]
    assert tc.dispatch_log == type(tc.dispatch_log)()
    assert tc.trace_counts == jc.trace_counts == {("dilithium", 64): 2}
    for n in (1, 4, 5, 8, 9):
        assert tc.launch_rows(n) == jc.launch_rows(n)
    assert tc.operand_shape("bn254", 64, 3) == jc.operand_shape("bn254", 64, 3)
    assert tc.precompile([("dilithium", 64)], n_c=3) == 0   # rungs all seen


def test_coscheduler_surface_matches_jax():
    assert TCOS.default_row_ladder(128) == JCOS.default_row_ladder(128)
    assert TCOS.default_row_ladder(20, 4) == JCOS.default_row_ladder(20, 4)
    for bad in ((), (1, 8), (8, 8), (16, 8)):
        with pytest.raises(ValueError):
            TCOS.validate_row_ladder(bad)
        with pytest.raises(ValueError):
            JCOS.validate_row_ladder(bad)
    with pytest.raises(ValueError, match="kappa"):
        TCOS.SliceCoScheduler(device="cpu", kappa=2)
    with pytest.raises(ValueError, match="unknown workload"):
        TCOS.SliceCoScheduler(device="cpu",
                              reduction_by_workload={"rsa": "lazy"})
    cos = TCOS.SliceCoScheduler(device="cpu", donate=True, host=3,
                                reduction_by_workload={"dilithium": "lazy"},
                                kappa=2)
    assert (cos.reduction_for("dilithium"), cos.reduction_for("bn254")) == \
        ("lazy", "eager")
    assert cos.donate and cos.host == 3 and cos.merge_rows_max == 128
    assert cos.engine_for("bn254", 16).kappa is None
    assert cos.engine_for("dilithium", 64).kappa == 2
    assert cos.device_ids() == ("cpu",)
    planes = cos.device_planes_for("dilithium", 64)
    assert planes is cos.device_planes_for("dilithium", 64)
    assert planes[0][1].device == torch.device("cpu")


def test_device_resolution_without_cuda():
    assert TD.resolve_devices("cpu") == [torch.device("cpu")]
    assert TD.partition_devices(2, ["cpu"]) == [[torch.device("cpu")]] * 2
    with pytest.raises(ValueError, match="twice"):
        TD.resolve_devices(["cpu", "cpu"])
    with pytest.raises(ValueError):
        TD.resolve_devices([])
    with pytest.raises(ValueError):
        TD.partition_devices(0, ["cpu"])
    with pytest.raises(ValueError):
        TD.resolve_device("mps")

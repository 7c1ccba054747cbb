"""BN254 scalar-field transforms served exactly through ``CryptoServer`` on
the CPU: requests of the ``bn254_full`` class are field elements of F_r as
8 little-endian uint32 words, and every answer is the exact transform's
``(bucket, 8)`` words, against the benchmark's plain reference
(``ffbench/reference/bn254_fr_ntt.py``).  The card twin is
``tests/test_torch_bn254_served_card.py``.

The server has the paper's settings (n_c 8, max_age 5 ms, max_pending
1,024, ``fp32_mantissa``, eager, validator on); its co-scheduler merges up
to 8 rows, so the validator probes 8-row programs: a 128-row probe of the
18-channel d = 512 transform takes a minute on the CPU.
"""
import numpy as np
import pytest
import torch

from ffbench.reference import bn254_fr_ntt as REF
from repro_torch.core import montgomery as MG
from repro_torch.core import rns as R
from repro_torch.core import workloads as WK
from repro_torch.core import zones
from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
from repro_torch.core.scheduler.queue import TenantRequest
from repro_torch.core.scheduler.rectangular import StackedBatch, bucket_pow2
from repro_torch.obs import Tracer, host_spans
from repro_torch.serve.server import CryptoServer, ServeConfig

P = REF.R
WORDS = 8
PAPER = dict(n_c=8, max_age_s=0.005, max_pending=1024,
             accum="fp32_mantissa", reduction="eager", validate=True)
DEGREES = (64, 100, 128, 300)


def words_of(v: int) -> list[int]:
    return [(v >> (32 * k)) & 0xFFFFFFFF for k in range(WORDS)]


def element_rows(d: int, seed: int) -> np.ndarray:
    """(d, 8) uint32 words of field elements uniform in [0, r)."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(d)]
    return np.array([words_of(v) for v in vals], np.uint32)


def reference_row(coeffs: np.ndarray) -> np.ndarray:
    """The reference's transform of ``coeffs`` zero-padded to its bucket."""
    b = bucket_pow2(len(coeffs))
    x = torch.zeros((1, b, WORDS), dtype=torch.int64)
    x[0, :len(coeffs)] = torch.from_numpy(coeffs.astype(np.int64))
    return REF.transform(x, P)[0].numpy().astype(np.uint32)


def _server(cos, tracer):
    server = CryptoServer(ServeConfig(**PAPER), coscheduler=cos)
    server.attach_tracer(tracer)
    return server


@pytest.fixture(scope="module")
def served():
    """Seeded rows at degrees 64, 100, 128 and 300 and one d = 512 row of
    r − 1, served by one server with a Tracer attached, while the host
    ingest of raw integers (Python bigints) raises if anything calls it."""
    def no_bigints(*a, **k):
        raise AssertionError("bn254_full rows went through Python bigints")

    cos = SliceCoScheduler(device="cpu", merge_rows_max=8)
    tracer = Tracer()
    server = _server(cos, tracer)
    rows = [element_rows(d, seed=d) for d in DEGREES]
    rows.append(np.array([words_of(P - 1)] * 512, np.uint32))
    mp = pytest.MonkeyPatch()
    mp.setattr(R, "to_rns_np", no_bigints)
    try:
        handles = [server.submit(TenantRequest(i, "bn254_full", len(r), 0.0,
                                               coeffs=r), now=0.0)
                   for i, r in enumerate(rows)]
        server.drain(0.0)
    finally:
        mp.undo()
    return cos, server, tracer, rows, handles


def test_served_rows_equal_the_reference_word_for_word(served):
    _, _, _, rows, handles = served
    for coeffs, h in zip(rows, handles):
        assert h.done() and not h.rejected
        got = h.result()
        assert got.dtype == np.uint32
        assert got.shape == (bucket_pow2(len(coeffs)), WORDS)
        np.testing.assert_array_equal(got, reference_row(coeffs))


def test_stage_ops_counted_once_per_program(served):
    """Every program has its ops by stage; ingest and reduce do not
    depend on the bucket, the channels' transforms grow with its passes.
    The reduction and the words it writes are the ``rns_redc`` kernel's
    work: no ATen op of their own, one kernel call a program run."""
    cos, _, _, _, _ = served
    ops = cos.program_stats()["stage_ops"]
    keys = [f"bn254_full/d{b}" for b in (64, 128, 512)]
    assert sorted(ops) == sorted(keys)
    for k in keys:
        assert set(ops[k]) == {"ingest", "channels", "reduce"}
        assert ops[k]["ingest"] > 0 and ops[k]["channels"] > 0
        assert ops[k]["reduce"] == 0
    for stage in ("ingest", "reduce"):
        assert len({ops[k][stage] for k in keys}) == 1, stage
    assert ops["bn254_full/d512"]["channels"] > ops["bn254_full/d64"]["channels"]
    progs = [p for (w, _), cache in cos._programs.items()
             if w == "bn254_full" for p in cache.values()]
    assert progs and all(p.calls["rns_redc"] == 1 for p in progs)


def test_tracer_sees_the_launches(served):
    _, server, tracer, _, _ = served
    events = tracer.event_dicts()
    names = {e["name"] for e in events if e.get("cat") == "launch"}
    assert {"launch:bn254_full/d64", "launch:bn254_full/d128",
            "launch:bn254_full/d512"} <= names
    spans = {s[0] for s in host_spans(events)}
    assert {"sched.launch", "sched.stage", "sched.replay", "sched.gather",
            "serve.validate"} <= spans
    assert len(server.telemetry.dispatches) == 3


def test_launch_log_names_the_served_stages(served):
    """The served e2e opens the scopes of its stages, so a validator's
    launch log names them; the reduction writes the words."""
    cos = served[0]
    eng = cos.engine_for("bn254_full", 64)
    with zones.launch_log() as log:
        eng.serve(torch.zeros((1, 64, WORDS), dtype=torch.int32))
    assert {"wzone_bn254", "bn254_ingest", "vpu_montgomery"} <= log.scopes
    assert len(log.records) == 2 * 18     # one pass: a K1 and a K2 a channel


def test_every_class_has_a_device_and_bn254_full_shares_bn254s():
    cos = SliceCoScheduler(device="cpu")
    assert set(cos.assignment) == set(WK.CLASSES)
    assert cos.device_for("bn254_full") == cos.device_for("bn254")


def test_other_forms_launch_at_their_old_shapes():
    """``dilithium`` words and ``bn254`` residues (or raw integers, which
    its engine ingests) keep their operand and result shapes;
    ``bn254_full`` takes and gives words.  Each engine gives its class's
    shape."""
    cos = SliceCoScheduler(device="cpu")
    for workload, shape in (("dilithium", (8, 64)), ("bn254", (8, 64, 9)),
                            ("bn254_full", (8, 64, WORDS))):
        assert cos.operand_shape(workload, 64, 8) == shape
        assert cos.engine_for(workload, 64).operand_shape(8) == shape
    rng = np.random.default_rng(3)
    dil = rng.integers(0, 8380417, (8, 64), dtype=np.uint64).astype(np.uint32)
    raw = rng.integers(0, 2**31, (8, 64), dtype=np.uint64).astype(np.uint32)
    got = {}
    for workload, operand in (("dilithium", dil), ("bn254", raw)):
        reqs = [TenantRequest(i, workload, 64, 0.0) for i in range(8)]
        got[workload] = cos.dispatch(StackedBatch(workload, 64, reqs,
                                                  operand)).rows
    assert got["dilithium"].shape == (8, 64)
    assert got["bn254"].shape == (8, 64, 23)
    np.testing.assert_array_equal(
        got["dilithium"], cos.engine_for("dilithium", 64).oracle_np(dil))
    bn = cos.engine_for("bn254", 64)
    np.testing.assert_array_equal(got["bn254"],
                                  bn.e2e(bn.ingest(raw.astype(object))))


def test_words_to_rns_and_back():
    """Words of 256-bit integers become their residues in every channel,
    and the digits of an element turn back into its words."""
    chain = R.make_chain(18)
    rng = np.random.default_rng(7)
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(16)]
    vals += [0, P - 1, (1 << 256) - 1]
    w = torch.tensor([words_of(v) for v in vals], dtype=torch.int64)
    as_int32 = torch.from_numpy(w.numpy().astype(np.uint32).view(np.int32))
    res = R.words_to_rns(as_int32, chain)
    assert res.tolist() == [[v % m for m in chain.moduli] for v in vals]
    digits = torch.tensor([[(v % P) >> (12 * j) & 0xFFF
                            for j in range(chain.n_red_digits)]
                           for v in vals], dtype=torch.int64)
    words = MG.digits_to_words_u32(digits)[..., :chain.n_words]
    assert words.tolist() == [words_of(v % P) for v in vals]


def test_full_chain_is_exact_for_every_degree_up_to_2_19():
    """The 18-channel chain holds a transform of canonical inputs, which
    reaches d·(r − 1)², for d ≤ 2**19 and not beyond 2**20."""
    chain = R.make_chain(18)
    assert len(chain.moduli) == 18 and chain.M.bit_length() == 527
    assert (1 << 19) * (P - 1) ** 2 < chain.M <= (1 << 20) * (P - 1) ** 2
    # the 9-channel chain of the paper holds no full-range transform
    assert R.make_chain(9).M < 64 * (P - 1) ** 2

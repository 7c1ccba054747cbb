"""The co-scheduler's captured e2e programs (``repro_torch.core.scheduler.
program``) against the JAX co-scheduler's compiled ``jitted_for`` programs.

On the CPU a program's launch runs its slot's copies around an eager
``eng.serve`` on its static buffers, so these tests hold the program cache
(keys, captures, ``precompile``), the slot discipline (a depth-2 ring of one
program, a held slot against the program's next launch), the kernel
counters and the launch census to the JAX co-scheduler and to the engines'
fold profiles.  Every launch goes through the served path: a slot acquired,
its input written with ``merge_operands``, ``launch``, ``wait``.  Operands
are seeded numpy arrays handed to both packages.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.scheduler import RectangularScheduler as JRect
from repro.core.scheduler import TenantRequest as JReq
from repro.core.scheduler import coscheduler as JCOS
from repro.core.scheduler import rectangular as JRectMod
from repro_torch.core import field as TF
from repro_torch.core.scheduler import RectangularScheduler as TRect
from repro_torch.core.scheduler import TenantRequest as TReq
from repro_torch.core.scheduler import coscheduler as TCOS
from repro_torch.core.scheduler import program as P
from repro_torch.core.scheduler.rectangular import StackedBatch, merge_operands
from repro_torch.kernels.limb_matmul.kernel import COUNTER as K1
from repro_torch.kernels.mont_fold.kernel import COUNTER as K2
from repro_torch.serve import CryptoServer, ServeConfig

Q = TF.DILITHIUM_Q
MIXED = dict(accum="int32_native", d_tile=171,
             reduction_by_workload={"dilithium": "lazy"})
# name -> (co-scheduler keywords, workload, d): Dilithium d = 256 takes two
# staging passes under either accumulator (eager: a fold per pass; lazy: one
# window fold); BN254 at d = 16 runs nine channels and rns_to_field.
CONFIGS = {"dilithium-eager": ({}, "dilithium", 256),
           "dilithium-lazy": (MIXED, "dilithium", 256),
           "bn254": ({}, "bn254", 16)}
LADDER = (4, 8)
# Live heights per class; BN254 keeps to one (each JAX BN254 height is a
# fifteen-second compile on the CPU).
HEIGHTS = {"dilithium": (1, 3, 8), "bn254": (3,)}
_J_COS: dict = {}


def _j_cos(name):
    """One JAX co-scheduler per configuration for the module: its compiled
    programs are reused across the parametrised cases."""
    if name not in _J_COS:
        _J_COS[name] = JCOS.SliceCoScheduler(**CONFIGS[name][0])
    return _J_COS[name]


def _operand(rng, cos, workload, d, n):
    """n live rows of residues (uint32) for one launch of the class."""
    if workload == "dilithium":
        return rng.integers(0, Q, (n, d), dtype=np.uint64).astype(np.uint32)
    moduli = np.array(cos.engine_for(workload, d).chain.moduli, np.uint64)
    raw = rng.integers(0, 2**31, (n, d, len(moduli)), dtype=np.uint64)
    return (raw % moduli).astype(np.uint32)


def _u32(t):
    return t.numpy().view(np.uint32)


class _Holder:
    """What holds a launch slot (the co-scheduler's launch group)."""


def _launch(prog, operand, holder):
    """One launch of ``prog`` as the co-scheduler makes it: a slot held for
    ``holder``, ``operand`` merged into its input, launched and waited on.
    Returns the slot, still held."""
    slot = prog.acquire(holder)
    merge_operands([operand], out=slot.in_view)
    prog.launch(slot)
    slot.wait()
    return slot


@pytest.mark.parametrize("ladder", [None, LADDER], ids=["no-ladder", "ladder"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_program_rows_equal_jax_jitted_for(name, ladder):
    """Each live height, padded to its launched height as both
    co-schedulers pad it, through the port's program and JAX's jitted_for:
    the rows are equal bit for bit, and both caches hold one entry per
    launched height."""
    kw, workload, d = CONFIGS[name]
    jc = _j_cos(name)
    tc = TCOS.SliceCoScheduler(device="cpu", row_ladder=ladder, **kw)
    rng = np.random.default_rng(17)
    launched = set()
    for n in HEIGHTS[workload]:
        live = _operand(rng, tc, workload, d, n)
        shape = tc.operand_shape(workload, d, n)
        launched.add(shape[0])
        slot = _launch(tc.program_for(workload, d, shape), live, _Holder())
        want = np.asarray(jc.jitted_for(workload, d)(
            jnp.asarray(slot.in_view.copy()),
            jc.device_planes_for(workload, d)))
        np.testing.assert_array_equal(slot.out_view, want)
        assert not slot.in_view[n:].any()       # ladder pad rows are zero
    assert set(tc.jitted_for(workload, d)) == {
        tc.operand_shape(workload, d, h) for h in launched}
    assert tc.trace_counts == {(workload, d): len(launched)}


def _dilithium_trace(cls, seed):
    """Batches of requests over three degree buckets (64, 128, 256), as
    the Tier-1 scheduler stacks them."""
    rng = np.random.default_rng(seed)
    degrees = [40, 64, 100, 128, 200, 256, 33, 64, 128, 250, 70, 16, 256, 90]
    reqs = [cls(i, "dilithium", deg, 0.0,
                rng.integers(0, Q, deg, dtype=np.uint64).astype(np.uint32))
            for i, deg in enumerate(degrees)]
    return reqs


@pytest.mark.parametrize("ladder", [None, LADDER], ids=["no-ladder", "ladder"])
def test_trace_counts_and_precompile_match_jax(ladder):
    """The same trace through both co-schedulers (merged launch groups at
    several heights, three degree buckets): equal rows, equal trace counts;
    then precompile of the seen classes and a new one returns the same
    number of new programs on both sides, and a second precompile none."""
    jc = JCOS.SliceCoScheduler(row_ladder=ladder, merge_rows_max=8)
    tc = TCOS.SliceCoScheduler(row_ladder=ladder, merge_rows_max=8,
                               device="cpu")
    j_b = JRect(n_c=3).plan_batches(_dilithium_trace(JReq, 3))
    t_b = TRect(n_c=3).plan_batches(_dilithium_trace(TReq, 3))
    assert [b.n_c for b in t_b] == [b.n_c for b in j_b]
    for lo, hi in ((0, 2), (2, 3), (3, len(t_b))):
        for jr, tr in zip(jc.dispatch_mixed(j_b[lo:hi]),
                          tc.dispatch_mixed(t_b[lo:hi])):
            np.testing.assert_array_equal(tr.rows, jr.rows)
    assert tc.trace_counts == jc.trace_counts
    assert len(tc.trace_counts) == 3
    classes = [("dilithium", 64), ("dilithium", 128), ("dilithium", 512)]
    n_new = jc.precompile(classes, n_c=3)
    assert tc.precompile(classes, n_c=3) == n_new > 0
    assert tc.trace_counts == jc.trace_counts
    assert tc.precompile(classes, n_c=3) == 0
    assert tc.program_stats()["captures"] == sum(tc.trace_counts.values())


def _batches(seed, n_batches, n_c=3, d=64):
    rng = np.random.default_rng(seed)
    reqs = [TReq(i, "dilithium", d, 0.0,
                 rng.integers(0, Q, d, dtype=np.uint64).astype(np.uint32))
            for i in range(n_batches * n_c)]
    return TRect(n_c=n_c).plan_batches(reqs)


def _oracle(batch):
    from repro_torch.core import ntt as NTT
    w = NTT.ntt_matrix(batch.d_bucket, Q, negacyclic=True).astype(np.int64)
    return ((np.asarray(batch.operand, np.int64) @ w) % Q).astype(np.uint32)


@pytest.mark.parametrize("order", ["in-order", "reversed"])
def test_two_flights_of_one_program_keep_their_own_rows(order):
    """A depth-2 ring: two launches of one program (same class, same
    height) in the air before either is gathered.  Each flight returns its
    own rows, whichever is gathered first: the static output is copied out
    at launch, before the next run overwrites it."""
    cos = TCOS.SliceCoScheduler(device="cpu")
    first, second = _batches(1, 2)
    flights = [cos.launch_mixed([first]), cos.launch_mixed([second])]
    assert cos.trace_counts == {("dilithium", 64): 1}
    prog = cos.jitted_for("dilithium", 64)[(3, 64)]
    np.testing.assert_array_equal(_u32(prog.static_out), _oracle(second))
    pairs = list(zip(flights, (first, second)))
    if order == "reversed":
        pairs.reverse()
    for flight, batch in pairs:
        (res,) = cos.gather(flight)
        assert res.batch is batch
        np.testing.assert_array_equal(res.rows, _oracle(batch))


def test_the_static_output_is_the_programs_own():
    """The static output is overwritten by the program's next launch; a
    held slot's output keeps its rows after that launch, made on another
    slot.  An operand of the wrong shape is refused before it reaches a
    slot."""
    cos = TCOS.SliceCoScheduler(device="cpu")
    a, b = _batches(2, 2)
    prog = cos.program_for("dilithium", 64, (3, 64))
    holders = [_Holder(), _Holder()]
    slot_a = _launch(prog, a.operand, holders[0])
    slot_b = _launch(prog, b.operand, holders[1])
    assert slot_a is not slot_b and prog.slot_grows == 1
    assert slot_a.event is None and slot_a.graph is None  # the CPU's slots
    np.testing.assert_array_equal(slot_a.out_view, _oracle(a))
    np.testing.assert_array_equal(slot_b.out_view, _oracle(b))
    assert _u32(prog.static_out).tobytes() == slot_b.out_view.tobytes()
    with pytest.raises(ValueError, match="buffer"):
        merge_operands([a.operand[:, :32]], out=slot_a.in_view)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_counters_after_n_dispatches_equal_n_captured_counts(name):
    """After the programs are captured, n dispatches of one class raise the
    K1/K2 counters by n times the counts recorded at capture, which equal
    the fold profile's totals."""
    kw, workload, d = CONFIGS[name]
    cos = TCOS.SliceCoScheduler(device="cpu", **kw)
    shape = cos.operand_shape(workload, d, 2)
    prog = cos.program_for(workload, d, shape)
    want = TCOS.expected_kernel_calls(prog.eng)
    assert (prog.calls["limb_matmul"], prog.calls["mont_fold"]) == want
    assert prog.calls["fused_ntt_tile"] == 0
    assert prog.launches == {k: 0 for k in P.COUNTERS}   # the CPU launches none
    rng = np.random.default_rng(5)
    before = (K1.calls, K2.calls)
    n = 3
    for i in range(n):
        reqs = [TReq(2 * i + j, workload, d, 0.0) for j in range(2)]
        cos.dispatch(StackedBatch(workload, d, reqs,
                                  _operand(rng, cos, workload, d, 2)))
    assert (K1.calls - before[0], K2.calls - before[1]) == \
        (n * want[0], n * want[1])
    assert cos.trace_counts == {(workload, d): 1}


def test_a_replay_adds_the_captured_counts():
    """A replay calls no kernel wrapper; the program adds the counts its
    capture recorded, once per launch.  (A stand-in graph whose replay does
    nothing, and a stand-in event, take the slot's CUDA graph and event's
    place.)"""
    cos = TCOS.SliceCoScheduler(device="cpu")
    prog = cos.program_for("dilithium", 256, (2, 256))
    holder = _Holder()
    slot = prog.acquire(holder)
    slot.graph = types.SimpleNamespace(replay=lambda: None)
    slot.event = types.SimpleNamespace(record=lambda stream: None,
                                       synchronize=lambda: None)
    prog.launches = dict.fromkeys(P.COUNTERS, 0) | {"limb_matmul": 5,
                                                    "mont_fold": 7}
    before = {k: (c.calls, c.launches) for k, c in P.COUNTERS.items()}
    for _ in range(4):
        prog.launch(slot)
        assert slot.pending
        slot.wait()
    for k, c in P.COUNTERS.items():
        assert c.calls - before[k][0] == 4 * prog.calls[k]
        assert c.launches - before[k][1] == 4 * prog.launches[k]
    assert prog.calls["limb_matmul"] == prog.calls["mont_fold"] == 2


def test_validate_once_captures_a_probe_outside_the_cache():
    """The server's launch census captures a probe program at the merge cap
    and checks its recorded counts; the probe adds nothing to
    ``trace_counts``, the program cache or ``dispatch_log``, and its K1/K2
    calls are exactly the census's."""
    cos = TCOS.SliceCoScheduler(device="cpu", **MIXED)
    server = CryptoServer(ServeConfig(validate=True, n_c=4, **MIXED),
                          coscheduler=cos)
    (batch,) = _batches(3, 1, n_c=4, d=256)
    before = (K1.calls, K2.calls)
    server._validate_once(batch)
    server._validate_once(batch)                  # once per class
    assert (K1.calls - before[0], K2.calls - before[1]) == \
        TCOS.expected_kernel_calls(cos.engine_for("dilithium", 256)) == (2, 1)
    assert server._validated == {("dilithium", 256)}
    assert cos.trace_counts == {} and cos._programs == {}
    assert not cos.dispatch_log


def test_merge_operands_into_a_buffer():
    """Members concatenated along M into the launch's buffer, the rows below
    them zeroed, as ``np.concatenate`` plus zero padding and as the JAX
    package's ``merge_operands`` at the same height."""
    rng = np.random.default_rng(9)
    ops = [rng.integers(0, Q, (n, 8), dtype=np.uint64).astype(np.uint32)
           for n in (2, 3)]
    for rows in (5, 8):
        out = np.full((rows, 8), 7, np.uint32)
        assert merge_operands(ops, out=out) is out
        want = np.zeros((rows, 8), np.uint32)
        want[:5] = np.concatenate(ops)
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(out, JRectMod.merge_operands(ops, rows))
    with pytest.raises(ValueError, match="buffer"):
        merge_operands(ops, out=np.zeros((4, 8), np.uint32))
    with pytest.raises(ValueError, match="buffer"):
        merge_operands(ops, out=np.zeros((8, 9), np.uint32))

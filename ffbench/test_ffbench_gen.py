"""The generator: deterministic from the seed, no payload twice in a run,
the same work for every seed."""
import json
from pathlib import Path

import numpy as np
import pytest

from ffbench import gen

HERE = Path(__file__).resolve().parent
BIG = 2**31 + 977


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["mldsa_d256", "dilithium_mix"])
def test_requests_are_a_function_of_seed_stream_and_index(name):
    cfg = _config(name)
    a = gen.RequestSource(cfg, BIG, "window", chunk=64)
    b = gen.RequestSource(cfg, BIG, "window", chunk=64)
    b.prefetch(200)
    for i in (0, 63, 64, 199, 150):        # any order, any prefetch
        da, ra = a.get(i)
        db, rb = b.get(i)
        assert da == db and np.array_equal(ra, rb)
        assert ra.dtype == np.uint32 and len(ra) == da
        assert ra.max() < cfg["modulus"]
    c = gen.RequestSource(cfg, BIG + 1, "window", chunk=64)
    assert not np.array_equal(a.get(5)[1], c.get(5)[1])


def test_a_stream_of_given_degrees_draws_them_in_order():
    cfg = _config("dilithium_mix")
    degrees = [64, 128, 256, 512, 512, 100]
    src = gen.RequestSource(cfg, BIG, "prime", chunk=4, degrees=degrees)
    got = [src.get(i) for i in range(len(degrees))]
    assert [d for d, _ in got] == degrees
    assert [len(r) for _, r in got] == degrees
    assert len({r.tobytes() for _, r in got}) == len(degrees)


@pytest.mark.parametrize("name", ["mldsa_d256", "dilithium_mix"])
def test_no_payload_repeats_within_a_run(name):
    cfg = _config(name)
    rows = set()
    for stream in ("prime", "warmup", "window", "trace_window"):
        src = gen.RequestSource(cfg, BIG, stream, chunk=128)
        for i in range(300):
            rows.add(src.get(i)[1].tobytes())
    assert len(rows) == 4 * 300


def test_every_seed_draws_the_same_degrees_in_another_order():
    law = _config("dilithium_mix")["degrees"]
    n = 449 * 4
    a = gen.degree_block(law, n, np.random.default_rng(1))
    b = gen.degree_block(law, n, np.random.default_rng(2))
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert np.array_equal(np.bincount(a)[64:], np.full(449, 4))
    shares = {bk: np.mean([gen.bucket(d) == bk for d in a])
              for bk in gen.buckets(law)}
    assert gen.buckets(law) == [64, 128, 256, 512]
    assert shares[64] == pytest.approx(1 / 449)
    assert shares[512] == pytest.approx(256 / 449)


def test_poisson_arrivals_are_fixed_in_count_and_deterministic():
    a = gen.poisson_arrivals(5000.0, 2.0, BIG, "window")
    b = gen.poisson_arrivals(5000.0, 2.0, BIG, "window")
    c = gen.poisson_arrivals(5000.0, 2.0, BIG + 7, "window")
    assert len(a) == len(c) == 10000
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.all(np.diff(a) >= 0) and 0 <= a[0] and a[-1] < 2.0
    # exponential gaps: the mean gap is 1/rate, the sd about the same
    gaps = np.diff(a)
    assert gaps.mean() == pytest.approx(2e-4, rel=0.05)
    assert gaps.std() == pytest.approx(2e-4, rel=0.1)


def test_seeds_past_32_bits_are_taken_whole():
    assert gen.derive_seed(2**33 + 5, "x") != gen.derive_seed(5, "x")
    assert gen.derive_seed(2**31 + 1, "x", 3) == gen.derive_seed(
        2**31 + 1, "x", 3)

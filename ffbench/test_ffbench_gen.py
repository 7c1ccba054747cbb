"""The generator: deterministic from the seed, no payload twice in a run,
the same work for every seed."""
import hashlib
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


@pytest.mark.parametrize("name", ["mldsa_d256", "dilithium_mix", "bn254"])
def test_no_payload_repeats_within_a_run(name, bn254_config):
    cfg = bn254_config if name == "bn254" else _config(name)
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


# sha256 of chunk 0 of the window stream at seed BIG (each request's degree
# as int64, then its words), as the draw of one uint32 word a coefficient
# gives it; multi-word coefficients left it unchanged
DIGESTS = {
    "mldsa_d256":
        "f1b20d266ac1cb0b3cf2b8d1dffb3a342e52a799ca21d64078ce26fcc13256d8",
    "dilithium_mix":
        "11a06b747ee5a09f0e02d36dfd0b9eae7aa885bb562eee6b8402ab1844f6d65f",
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_one_word_draws_are_pinned(name):
    src = gen.RequestSource(_config(name), BIG, "window")
    h = hashlib.sha256()
    for i in range(gen.CHUNK):
        d, row = src.get(i)
        h.update(np.int64(d).tobytes())
        h.update(row.tobytes())
    assert h.hexdigest() == DIGESTS[name]


def _value(words) -> int:
    return sum(int(w) << (32 * k) for k, w in enumerate(words))


def test_word_draws_are_field_elements_of_the_seed_stream_and_index(
        bn254_config):
    r = int(bn254_config["modulus"])
    a = gen.RequestSource(bn254_config, BIG, "window", chunk=32)
    b = gen.RequestSource(bn254_config, BIG, "window", chunk=32)
    b.prefetch(100)
    for i in (0, 31, 32, 99, 70):
        da, ra = a.get(i)
        db, rb = b.get(i)
        assert da == db and np.array_equal(ra, rb)
        assert ra.dtype == np.uint32 and ra.shape == (da, 8)
        assert all(_value(c) < r for c in ra)
    c = gen.RequestSource(bn254_config, BIG + 1, "window", chunk=32)
    assert not np.array_equal(a.get(5)[1], c.get(5)[1])
    # uniform in [0, r): the top word below r's, the mean value r / 2
    coeffs = np.concatenate([a.get(i)[1] for i in range(32)])
    assert coeffs[:, 7].max() < (r >> 224) + 1
    mean = np.mean([_value(c) / r for c in coeffs])
    assert mean == pytest.approx(0.5, abs=0.03)


def test_words_are_little_endian():
    """[0, 3 * 2**31) in two words: the second word is the high one."""
    cfg = {"degrees": {"law": "fixed", "d": 64},
           "coefficients": {"law": "uniform", "low": 0,
                            "high": str(3 << 31), "words": 2}}
    src = gen.RequestSource(cfg, BIG, "window", chunk=16)
    x = np.concatenate([src.get(i)[1] for i in range(16)]).astype(np.int64)
    assert set(x[:, 1]) == {0, 1}
    assert x[x[:, 1] == 1, 0].max() < 1 << 31
    assert x[x[:, 1] == 0, 0].max() >= 1 << 31
    assert np.mean(x[:, 1]) == pytest.approx(1 / 3, abs=0.03)


def test_word_laws_that_do_not_fit_are_refused(bn254_config):
    bn254_config["coefficients"]["words"] = 9
    with pytest.raises(ValueError):
        gen.RequestSource(bn254_config, BIG, "window")
    bn254_config["coefficients"].update(words=8, low=1)
    with pytest.raises(ValueError):
        gen.RequestSource(bn254_config, BIG, "window")

"""Test-suite bootstrap.

The property tests use a small slice of the ``hypothesis`` API.  When the
real package is unavailable (the pinned accelerator image ships without it)
we register a deterministic miniature implementation under the same module
names so the tier-1 suite runs everywhere.  Draws are seeded per-test, and
interval strategies always emit their boundary values first, so each run
exercises an identical example set.
"""
from __future__ import annotations

import functools
import sys
import zlib


def _install_hypothesis_stub():
    import random
    import types

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def example(self, rng):
            return self._draw(rng)

    def integers(min_value, max_value):
        bounds = [min_value, max_value]

        def draw(rng):
            if bounds:
                return bounds.pop(0)
            return rng.randint(min_value, max_value)

        return _Strategy(draw)

    def lists(elements, min_size=0, max_size=10):
        def draw(rng):
            n = rng.randint(min_size, max_size)
            return [elements.example(rng) for _ in range(n)]

        return _Strategy(draw)

    def sampled_from(seq):
        seq = list(seq)

        def draw(rng):
            return rng.choice(seq)

        return _Strategy(draw)

    def booleans():
        return _Strategy(lambda rng: rng.random() < 0.5)

    def settings(max_examples=20, deadline=None, **_kw):
        def deco(fn):
            fn._hyp_settings = {"max_examples": max_examples}
            return fn

        return deco

    def given(*strategies):
        def deco(fn):
            # Zero-arg wrapper: the drawn values replace the test's
            # parameters, so pytest must not mistake them for fixtures.
            @functools.wraps(fn)
            def wrapper():
                cfg = getattr(wrapper, "_hyp_settings", None) or {}
                n = cfg.get("max_examples", 20)
                seed = zlib.crc32(fn.__qualname__.encode())
                rng = random.Random(seed)
                for _ in range(n):
                    vals = [s.example(rng) for s in strategies]
                    fn(*vals)

            del wrapper.__wrapped__
            return wrapper

        return deco

    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.integers = integers
    st_mod.lists = lists
    st_mod.sampled_from = sampled_from
    st_mod.booleans = booleans

    hyp_mod = types.ModuleType("hypothesis")
    hyp_mod.given = given
    hyp_mod.settings = settings
    hyp_mod.strategies = st_mod
    hyp_mod.__stub__ = True

    sys.modules["hypothesis"] = hyp_mod
    sys.modules["hypothesis.strategies"] = st_mod


try:  # pragma: no cover - exercised implicitly by every property test
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one); on the "
        "card, run the files that hold such tests and import no JAX")

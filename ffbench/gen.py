"""The benchmark's traffic generator: request sizes, coefficients and arrival
times, drawn from ``--seed`` and a stream name alone.

A configuration file gives the request's law (``degrees``, ``coefficients``);
a traffic file gives the loop (closed with a concurrency, or open with an
arrival law and a rate).  Nothing here reads the program's state, so two
versions of the program are offered the same requests.

Requests are drawn in chunks: chunk ``j`` of stream ``s`` depends on
``(seed, s, j)`` only, so request ``i`` is the same whatever the run's
timing, and no payload is used twice in a run.  Within a chunk the degrees
are an exact multiset (every degree of a uniform law equally often) in an
order drawn from the seed, so every seed asks for the same work.

The program's own generator (``repro_torch.core.scheduler.queue.PoissonTrace``
and ``repro_torch.serve.client.attach_payloads``) draws the same laws; this is
the yardstick's copy, which later changes to the program cannot move.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

CHUNK = 8192


def derive_seed(seed: int, *keys) -> int:
    """A 63-bit seed for one (stream, chunk, ...) from the run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32]
    for k in keys:
        words.append(zlib.crc32(k.encode()) if isinstance(k, str) else int(k))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def degree_block(law: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` degrees of ``law``: a fixed degree, or every degree of
    ``[low, high]`` equally often (as near as ``n`` allows) in a random
    order."""
    if law["law"] == "fixed":
        return np.full(n, int(law["d"]), np.int64)
    if law["law"] == "uniform":
        lo, hi = int(law["low"]), int(law["high"])
        return rng.permutation(lo + np.arange(n, dtype=np.int64) % (hi - lo + 1))
    raise ValueError(f"unknown degree law {law['law']!r}")


def max_degree(law: dict) -> int:
    return int(law["d"] if law["law"] == "fixed" else law["high"])


def bucket(d: int, floor: int = 64) -> int:
    """The power-of-two size a degree-``d`` request is zero-padded to."""
    return max(floor, 1 << (int(d) - 1).bit_length())


def buckets(law: dict) -> list[int]:
    """Every bucket the law can ask for."""
    if law["law"] == "fixed":
        return [bucket(law["d"])]
    return sorted({bucket(d) for d in range(int(law["low"]),
                                            int(law["high"]) + 1)})


class RequestSource:
    """Request ``i`` of one stream: its degree and its coefficients (a uint32
    row of that length).  ``device`` is where the coefficients are drawn
    (in a few large calls); they are kept on the host, where requests are
    made, each chunk's rows end to end.  ``degrees``, where given, are the
    stream's degrees in order, in place of the configuration's law."""

    def __init__(self, config: dict, seed: int, stream: str, device="cpu",
                 chunk: int = CHUNK, degrees=None):
        self.law = config["degrees"]
        coeff = config["coefficients"]
        if coeff["law"] != "uniform":
            raise ValueError(f"unknown coefficient law {coeff['law']!r}")
        self.low, self.high = int(coeff["low"]), int(coeff["high"])
        self.degrees = (None if degrees is None
                        else np.asarray(degrees, np.int64))
        self.seed, self.stream = seed, stream
        self.device = torch.device(device)
        self.chunk = chunk
        self._chunks: dict[int, tuple] = {}
        self.drawn_late = 0       # chunks drawn after prefetch (in a window)

    def _degrees(self, j: int) -> np.ndarray:
        if self.degrees is not None:
            return self.degrees[j * self.chunk:(j + 1) * self.chunk]
        rng = np.random.default_rng(derive_seed(self.seed, self.stream, j,
                                                "degrees"))
        return degree_block(self.law, self.chunk, rng)

    def _draw(self, j: int):
        degrees = self._degrees(j)
        offsets = np.zeros(len(degrees) + 1, np.int64)
        np.cumsum(degrees, out=offsets[1:])
        gen = torch.Generator(self.device)
        gen.manual_seed(derive_seed(self.seed, self.stream, j, "coeffs"))
        pay = torch.randint(self.low, self.high, (int(offsets[-1]),),
                            generator=gen, device=self.device,
                            dtype=torch.int32)
        self._chunks[j] = (degrees, offsets,
                           pay.cpu().numpy().view(np.uint32))

    def prefetch(self, n: int):
        """Draw every chunk that requests ``0 .. n-1`` fall in."""
        for j in range((n + self.chunk - 1) // self.chunk):
            if j not in self._chunks:
                self._draw(j)

    def get(self, i: int) -> tuple[int, np.ndarray]:
        """Request ``i``: its degree and its coefficients."""
        j, k = divmod(i, self.chunk)
        if j not in self._chunks:
            self.drawn_late += 1
            self._draw(j)
        degrees, offsets, pay = self._chunks[j]
        return int(degrees[k]), pay[offsets[k]:offsets[k + 1]]


def poisson_arrivals(rate_hz: float, seconds: float, seed: int,
                     stream: str) -> np.ndarray:
    """Arrival offsets (s) of a Poisson process of ``rate_hz`` over
    ``[0, seconds)``, conditioned on its mean count: ``round(rate·seconds)``
    arrivals placed uniformly, so every seed offers the same load."""
    n = int(round(rate_hz * seconds))
    rng = np.random.default_rng(derive_seed(seed, stream, "arrivals"))
    return np.sort(rng.uniform(0.0, seconds, n))

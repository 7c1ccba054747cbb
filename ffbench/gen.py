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

A coefficient is one uint32 word, or, where the coefficient law gives
``"words": k``, a field element of k little-endian uint32 words (``high``
may then be a decimal string), drawn by rejection from the same generator.

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


def element_shape(config: dict) -> tuple:
    """The shape of one coefficient: ``()`` for a word, ``(k,)`` for a field
    element of ``k`` words."""
    words = config.get("coefficients", {}).get("words")
    return () if words is None else (int(words),)


def top_bits(high: int, k: int) -> int:
    """The bits of the top of ``k`` words that ``[0, high)`` uses."""
    bits = (high - 1).bit_length() - 32 * (k - 1)
    if not 0 < bits <= 32:
        raise ValueError(f"{k} words do not fit [0, {high}) tightly")
    return bits


def uniform_words(high: int, k: int, n: int, gen: torch.Generator,
                  device) -> torch.Tensor:
    """``n`` integers uniform in ``[0, high)`` as an (n, k) int64 tensor of
    little-endian 32-bit words: k words drawn, the top one masked to the
    bits ``high - 1`` needs there, and the draws not below ``high`` drawn
    again from the same generator until none is left."""
    top = (1 << top_bits(high, k)) - 1
    limit = torch.tensor([(high >> (32 * w)) & 0xFFFFFFFF for w in range(k)],
                         dtype=torch.int64, device=device)
    out = torch.empty((n, k), dtype=torch.int64, device=device)
    todo = torch.arange(n, device=device)
    while len(todo):
        x = torch.randint(0, 1 << 32, (len(todo), k), generator=gen,
                          device=device, dtype=torch.int64)
        x[:, -1] &= top
        below = torch.zeros(len(todo), dtype=torch.bool, device=device)
        equal = torch.ones(len(todo), dtype=torch.bool, device=device)
        for w in range(k - 1, -1, -1):
            below |= equal & (x[:, w] < limit[w])
            equal &= x[:, w] == limit[w]
        out[todo[below]] = x[below]
        todo = todo[~below]
    return out


class RequestSource:
    """Request ``i`` of one stream: its degree and its coefficients (a uint32
    array of shape ``(degree,) + element_shape(config)``).  ``device`` is
    where the coefficients are drawn (in a few large calls); they are kept
    on the host, where requests are made, each chunk's rows end to end.
    ``degrees``, where given, are the stream's degrees in order, in place of
    the configuration's law."""

    def __init__(self, config: dict, seed: int, stream: str, device="cpu",
                 chunk: int = CHUNK, degrees=None):
        self.law = config["degrees"]
        coeff = config["coefficients"]
        if coeff["law"] != "uniform":
            raise ValueError(f"unknown coefficient law {coeff['law']!r}")
        self.low, self.high = int(coeff["low"]), int(coeff["high"])
        self.words = int(coeff["words"]) if "words" in coeff else None
        if self.words is not None:
            top_bits(self.high, self.words)
            if self.low != 0:
                raise ValueError("a law of words draws from [0, high)")
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
        n = int(offsets[-1])
        if self.words is None:
            pay = torch.randint(self.low, self.high, (n,), generator=gen,
                                device=self.device, dtype=torch.int32)
            pay = pay.cpu().numpy().view(np.uint32)
        else:
            pay = uniform_words(self.high, self.words, n, gen, self.device)
            pay = pay.cpu().numpy().astype(np.uint32)
        self._chunks[j] = (degrees, offsets, pay)

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

"""Host-side prime / root-of-unity generation for the ERNS channel chain.

Everything in this module runs on the host with Python bignums (exactly how a
TPU deployment stages constants from the host VM). Device code never calls
into here at trace time except through precomputed numpy arrays.
"""
from __future__ import annotations

import functools

# Deterministic Miller-Rabin witnesses: correct for all n < 3.3e24.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def ntt_friendly_primes(count: int, two_adicity: int, max_bits: int = 31) -> tuple[int, ...]:
    """Largest ``count`` primes m < 2**max_bits with m ≡ 1 (mod 2**two_adicity).

    two_adicity bounds the largest power-of-two transform length the channel
    supports (negacyclic d up to 2**(two_adicity-1)).
    """
    step = 1 << two_adicity
    found: list[int] = []
    # Largest k·2^a + 1 below 2^max_bits.
    k = ((1 << max_bits) - 2) // step
    while len(found) < count and k > 0:
        cand = k * step + 1
        if is_prime(cand):
            found.append(cand)
        k -= 1
    if len(found) < count:
        raise ValueError(f"not enough {max_bits}-bit primes with 2-adicity {two_adicity}")
    return tuple(found)


def primitive_root_of_unity(m: int, order: int) -> int:
    """A primitive ``order``-th root of unity mod prime m (order | m-1)."""
    if (m - 1) % order != 0:
        raise ValueError(f"order {order} does not divide {m}-1")
    # Factor `order` (a power of two times small factors in our usage).
    factors = _distinct_prime_factors(order)
    cofactor = (m - 1) // order
    g = 2
    while True:
        w = pow(g, cofactor, m)
        if w != 1 and all(pow(w, order // q, m) != 1 for q in factors):
            return w
        g += 1
        if g > 10_000:
            raise RuntimeError("failed to find primitive root")


def _distinct_prime_factors(n: int) -> list[int]:
    out, d = [], 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out

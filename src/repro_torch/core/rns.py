"""Explicit Residue Number System (ERNS) chain for BN254 (paper §6.2).

Eight 31-bit NTT-friendly base channels plus one redundant channel for
Shenoy–Kumaresan exact base extension.  Each channel runs its own
matrix-form transform (limb_gemm); per-coefficient results re-enter the
field through a Montgomery reduction whose base-extension matrix-vector
products are the >2,100 limb-level operations the paper counts.

CRT recovery — and hence the F_p result — is exact whenever the true integer
value stays below M = Π m_i (≈ 2**248 for the 9-residue chain); the
18-channel chain (``bn254_full``) makes full-range d≤256 products exact.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import field as F
from repro_torch.core import primes as P
from repro_torch.core import wordarith as W

TWO_ADICITY = 17  # supports negacyclic transforms up to d = 2**16


@dataclasses.dataclass(frozen=True)
class RnsChain:
    """Host-precomputed ERNS constants (numpy; see :meth:`tensors`)."""

    p: int                       # the target field prime (BN254 Fr)
    base: tuple                  # n base moduli
    redundant: int               # auxiliary modulus m_r
    M: int                       # Π base
    inv_Mi_mod_mi: np.ndarray    # (n,) uint32 — (M/m_i)^{-1} mod m_i
    Mi_mod_mr: np.ndarray        # (n,) uint32 — (M/m_i) mod m_r
    M_inv_mod_mr: int            # M^{-1} mod m_r
    # Montgomery-corrected CRT matrices (digit-12):
    Ti_digits: np.ndarray        # (n, nd) uint32 — (M/m_i · β^nred mod p)
    V_digits: np.ndarray         # (nd,) uint32 — (-M · β^nred) mod p
    p_digits: np.ndarray         # (nred,) uint32
    p_prime: int                 # -p^{-1} mod β
    n_red_digits: int            # Montgomery digit count for p
    # device -> int64 tensors of the array constants, uploaded once per
    # device (an upload per dispatch would stall the stream: a copy from
    # pageable host memory synchronises)
    _device_consts: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        return len(self.base)

    @property
    def moduli(self) -> tuple:
        return self.base + (self.redundant,)

    def tensors(self, device) -> dict:
        """The chain's constants on ``device``, uploaded once per device.
        Under a fake tensor mode (a plan over a mesh) they are made as that
        mode's constants each call and not kept: a cached real tensor does
        not enter a fake program, nor a fake one a real program."""
        device = torch.device(device)
        fake = torch._guards.detect_fake_mode() is not None
        consts = None if fake else self._device_consts.get(device)
        if consts is None:
            def up(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=device)
            consts = {"base": up(self.base),
                      "inv_Mi_mod_mi": up(self.inv_Mi_mod_mi),
                      "Ti_digits": up(self.Ti_digits),
                      "V_digits": up(self.V_digits)[None, :]}
            if not fake:
                self._device_consts[device] = consts
        return consts


@functools.lru_cache(maxsize=8)
def make_chain(n_channels: int = 9, p: int = F.BN254_FR) -> RnsChain:
    """Build the chain: n_channels-1 base moduli + 1 redundant."""
    ms = P.ntt_friendly_primes(n_channels, TWO_ADICITY)
    base, m_r = ms[:-1], ms[-1]
    M = 1
    for m in base:
        M *= m

    inv_mi = np.array([pow(M // m, -1, m) for m in base], np.uint32)
    mi_mr = np.array([(M // m) % m_r for m in base], np.uint32)
    minv_mr = pow(M % m_r, -1, m_r)

    nred = (p.bit_length() + W.BETA_BITS - 1) // W.BETA_BITS + 1  # slack digit
    beta_pow = pow(1 << W.BETA_BITS, nred, p)
    nd = nred + 2
    ti = np.stack([W.int_to_digits((M // m) * beta_pow % p, nd) for m in base])
    v = W.int_to_digits((-(M * beta_pow)) % p, nd)  # ≡ -M·β^nred (mod p), ≥ 0
    p_digits = W.int_to_digits(p, nred)
    p_prime = (-pow(p, -1, 1 << W.BETA_BITS)) % (1 << W.BETA_BITS)

    return RnsChain(
        p=p, base=base, redundant=m_r, M=M,
        inv_Mi_mod_mi=inv_mi, Mi_mod_mr=mi_mr, M_inv_mod_mr=minv_mr,
        Ti_digits=ti, V_digits=v, p_digits=p_digits, p_prime=p_prime,
        n_red_digits=nred,
    )


# --- Host conversions ---------------------------------------------------------


def to_rns_np(values, chain: RnsChain) -> np.ndarray:
    """Python-int/object array [...] -> (..., n+1) uint32 residues."""
    vals = np.asarray(values, object)
    out = np.zeros(vals.shape + (chain.n + 1,), np.uint32)
    for i, m in enumerate(chain.moduli):
        out[..., i] = (vals % m).astype(np.uint32)
    return out


def from_rns_np(res: np.ndarray, chain: RnsChain) -> np.ndarray:
    """Exact host CRT over the base channels (ignores redundant): -> ints."""
    res = np.asarray(res)
    out = np.zeros(res.shape[:-1], object)
    for i, m in enumerate(chain.base):
        mi = chain.M // m
        out = out + res[..., i].astype(object) * (int(chain.inv_Mi_mod_mi[i]) * mi)
    return out % chain.M


# --- Device: Shenoy–Kumaresan α + Montgomery reduction to F_p -----------------


def sk_alpha(residues: torch.Tensor, chain: RnsChain):
    """Exact CRT overflow count α for values < M (uses the redundant channel).

    residues: (..., n+1) — base channels then redundant.
    Returns (xi (..., n) int64, alpha (...,) int64 with alpha < n).
    """
    c = chain.tensors(residues.device)
    residues = residues.to(torch.int64)
    mr = chain.redundant
    xi = F.mulmod(residues[..., : chain.n], c["inv_Mi_mod_mi"], c["base"])
    # Σ ξ_i (M/m_i) mod m_r
    acc = torch.zeros(residues.shape[:-1], dtype=torch.int64,
                      device=residues.device)
    for i in range(chain.n):
        t = F.mulmod(xi[..., i] % mr, int(chain.Mi_mod_mr[i]), mr)
        acc = F.addmod(acc, t, mr)
    diff = F.submod(acc, residues[..., chain.n] % mr, mr)
    alpha = F.mulmod(diff, chain.M_inv_mod_mr, mr)
    return xi, alpha


def rns_to_field(residues: torch.Tensor, chain: RnsChain) -> torch.Tensor:
    """(..., n+1) residues of X < M  ->  (..., nred) int64 digit-12 of X mod p.

    Pipeline: SK α → Montgomery-corrected CRT accumulation (base-extension
    matrix-vector products in digit-12) → digit-12 Montgomery REDC → canonical
    residue digits of X mod p.
    """
    from repro_torch.core import montgomery as MG  # local import to avoid cycle
    c = chain.tensors(residues.device)
    xi, alpha = sk_alpha(residues, chain)
    nd = chain.Ti_digits.shape[1]
    acc = W.scalar_conv_accumulate(xi, c["Ti_digits"], nd + 3)
    # -α·U ≡ α·V (mod p) with V = (-M·β^nred) mod p ≥ 0 keeps Y non-negative:
    # Y = Σ ξ_i T_i + α·V ≡ X·β^nred (mod p), Y < 8·2^31·p + 8p ≈ 2^288.
    comp = W.scalar_conv_accumulate(alpha[..., None], c["V_digits"], nd + 3)
    acc = acc + comp
    y_digits = W.normalize_digits(acc)
    return MG.redc_digits(y_digits, chain)

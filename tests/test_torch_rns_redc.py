"""The ``rns_redc`` wrapper (``repro_torch.kernels.rns_redc``) on the CPU:
its plain path against the port's plain ``rns_to_field`` (and
``digits_to_words_u32``) and against the JAX package's, bit for bit, in
both forms, at the 9- and 18-channel chains; an emulation of the CUDA
kernel's 32-bit arithmetic (``csrc/rns_redc.cu``) against the same, with
every intermediate held to the bound the kernel relies on; the wrapper's
checks and its counter.  The card twin is
``tests/test_torch_rns_redc_card.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import montgomery as JMG
from repro.core import rns as JR
from repro_torch.core import montgomery as TMG
from repro_torch.core import rns as TR
from repro_torch.core import wordarith as TW
from repro_torch.core import workloads as TWK
from repro_torch.kernels.rns_redc import kernel as KRN
from repro_torch.kernels.rns_redc.ops import rns_redc
from repro_torch.kernels.rns_redc.ref import edge_residues

P = TR.F.BN254_FR
CHANNELS = (9, 18)
D_MAX = 2**19          # the 18-channel chain is exact for every d <= 2**19


def edge_values(chain, n_random: int = 24, seed: int = 7) -> list[int]:
    """Integers whose residues the tests reduce: uniform below M, 0, 1,
    M − 1, p − 1, p, and d·(r − 1)² at d = 2**19 (the 18-channel chain's
    bound; above M for the 9-channel chain, whose residues then stand for
    that integer mod M and are reduced all the same)."""
    rng = np.random.default_rng(seed + chain.n)
    nbytes = (chain.M.bit_length() + 7) // 8 + 1
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % chain.M
            for _ in range(n_random)]
    return vals + [0, 1, chain.M - 1, P - 1, P, D_MAX * (P - 1) ** 2]


def residues_of(vals, chain) -> torch.Tensor:
    return torch.from_numpy(TR.to_rns_np(np.array(vals, object), chain)
                            .astype(np.int64))


def transformed_rows(n_channels: int, d: int = 16) -> torch.Tensor:
    """(2, d, C) residues of the engine's transform of an all-(r − 1)
    coefficient row and of a row of seeded coefficients."""
    eng = TWK.BN254Engine(d, n_channels=n_channels, device="cpu")
    rng = np.random.default_rng(d)
    coeffs = np.array([[P - 1] * d,
                       [int.from_bytes(rng.bytes(32), "little") % P
                        for _ in range(d)]], object)
    return eng.evaluate(eng.ingest(coeffs))


def all_inputs(chain) -> torch.Tensor:
    """(k, C) residues: the edge values, then the transformed rows'."""
    return torch.cat([residues_of(edge_values(chain), chain),
                      transformed_rows(chain.n + 1).reshape(-1, chain.n + 1)])


# --- the CUDA kernel's arithmetic, emulated --------------------------------------

U32 = 2**32
BETA_BITS, MASK = 12, (1 << 12) - 1
NCOL = 27


def _u32(x: int) -> int:
    assert 0 <= x < U32, x      # what the kernel holds in a uint32
    return x


def _barrett(x: int, m: int) -> int:
    assert 0 <= x < 2**64 and 2 < m < 2**31
    mu = (2**64 - 1) // m
    r = x - ((x * mu) >> 64) * m
    assert 0 <= r < 2 * m       # one conditional subtract is enough
    return r - m if r >= m else r


def emulate_kernel(res: list[int], chain, words: bool) -> list[int]:
    """One element through ``rns_redc_kernel``'s steps as written, Python
    integers checked against 32 bits wherever the kernel uses uint32."""
    c = KRN.constants(chain).astype(np.int64).tolist()
    n = chain.n
    m, c = c[:n + 1], c[n + 1:]
    inv_mi, mi_mr, c = c[:n], c[n:2 * n], c[2 * n:]
    m_inv_mr, p_prime, c = c[0], c[1], c[2:]
    T = [c[i * 25:(i + 1) * 25] for i in range(n)]
    V, P_d = c[n * 25:n * 25 + 25], c[n * 25 + 25:]
    assert len(P_d) == 23
    xi = [_barrett(_barrett(res[i], m[i]) * inv_mi[i], m[i]) for i in range(n)]
    s = sum(_barrett(x * mi_mr[i], m[n]) for i, x in enumerate(xi))
    acc, rr = _barrett(s, m[n]), _barrett(res[n], m[n])
    diff = acc - rr if acc >= rr else acc + m[n] - rr
    alpha = _barrett(diff * m_inv_mr, m[n])
    t = [0] * NCOL
    for i in range(n + 1):
        x, k = (xi[i], T[i]) if i < n else (alpha, V)
        for j in range(25):
            for off in range(3):
                t[j + off] = _u32(t[j + off] + ((x >> (12 * off)) & MASK) * k[j])
    assert max(t) < 2**30
    for _ in range(23):
        q = (t[0] * p_prime) & MASK
        carry = _u32(t[0] + q * P_d[0]) >> BETA_BITS
        t = [_u32(t[j] + (q * P_d[j] if j < 23 else 0))
             for j in range(1, NCOL)] + [0]
        t[0] = _u32(t[0] + carry)
        assert max(t) < 2**31
    d, e, carry, borrow = [], [], 0, 0
    for j in range(23):
        v = _u32(t[j] + carry)
        d.append(v & MASK)
        carry = v >> BETA_BITS
        x = d[j] - P_d[j] - borrow
        borrow = int(x < 0)
        e.append(x + (borrow << BETA_BITS))
    assert carry == 0 and max(t[23:]) == 0
    assert TW.digits_to_int(np.array(d, np.int64)) < 2 * P   # the REDC bound
    d = e if borrow == 0 else d
    if not words:
        return d
    out = []
    for k in range(8):
        w = 0
        for j in range(23):
            b = BETA_BITS * j - 32 * k
            if 0 <= b < 32:
                w |= (d[j] << b) & 0xFFFFFFFF
            elif -BETA_BITS < b < 0:
                w |= d[j] >> -b
        out.append(w)
    return out


# --- tests -------------------------------------------------------------------------


@pytest.fixture(scope="module", params=CHANNELS)
def case(request):
    """(torch chain, JAX chain, residues) of one channel count."""
    chain = TR.make_chain(request.param)
    return chain, JR.make_chain(request.param), all_inputs(chain)


def test_digits_equal_the_plain_reduction_and_jax(case):
    chain, jchain, res = case
    got = rns_redc(res, chain, form="digits")
    assert got.dtype == torch.int64 and got.shape == (len(res), 23)
    assert torch.equal(got, TR.rns_to_field(res, chain))
    want = JR.rns_to_field(jnp.asarray(res.numpy().astype(np.uint32)), jchain)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_words_equal_the_packed_plain_reduction_and_jax(case):
    chain, jchain, res = case
    got = rns_redc(res, chain, form="words")
    assert got.dtype == torch.int64 and got.shape == (len(res), 8)
    plain = TR.rns_to_field(res, chain)
    assert torch.equal(got, TMG.digits_to_words_u32(plain)[..., :8])
    jdig = JR.rns_to_field(jnp.asarray(res.numpy().astype(np.uint32)), jchain)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JMG.digits_to_words_u32(jdig))[..., :8])


def test_inside_the_envelope_the_result_is_x_mod_p(case):
    """Every edge value below M comes back as itself mod p, in both forms
    (for the 18-channel chain that includes d·(r − 1)² at d = 2**19)."""
    chain, _, _ = case
    vals = [v for v in edge_values(chain) if v < chain.M]
    assert (D_MAX * (P - 1) ** 2 < chain.M) == (chain.n == 17)
    res = residues_of(vals, chain)
    digits = rns_redc(res, chain, form="digits").numpy()
    np.testing.assert_array_equal(TW.digits_to_int_batch(digits),
                                  np.array([v % P for v in vals], object))
    words = rns_redc(res, chain, form="words").numpy()
    assert words.tolist() == [[(v % P >> (32 * k)) & 0xFFFFFFFF
                               for k in range(8)] for v in vals]


def test_kernel_arithmetic_emulated(case):
    """The kernel's steps (Barrett ξ and α, uint32 digit-12 columns, the
    deferred-carry REDC, one carry pass) give the plain digits and words on
    every input, and no uint32 intermediate reaches its bound."""
    chain, _, res = case
    digits = TR.rns_to_field(res, chain)
    words = TMG.digits_to_words_u32(digits)[..., :8]
    for row, want_d, want_w in zip(res.tolist(), digits.tolist(),
                                   words.tolist()):
        assert emulate_kernel(row, chain, words=False) == want_d
        assert emulate_kernel(row, chain, words=True) == want_w


def test_the_column_and_redc_bounds_hold_for_any_input():
    """The bounds the kernel's comment states, from the constants: a column
    of Y below 2**30, a deferred-carry column below 2**31."""
    for n_channels in CHANNELS:
        chain = TR.make_chain(n_channels)
        most = 3 * (chain.n + 1) * MASK * MASK
        assert most < 2**30
        assert most + 23 * MASK * int(max(chain.p_digits)) + 2**20 < 2**31
        assert max(chain.moduli) < 2**31


def test_the_constants_pack_as_the_c_entry_reads_them():
    for n_channels in CHANNELS:
        chain = TR.make_chain(n_channels)
        c = KRN.constants(chain)
        n = chain.n
        assert c.dtype == np.uint32 and c.size == 28 * n + 51
        assert c[:n + 1].tolist() == list(chain.moduli)
        assert all(m % 2 == 1 for m in chain.moduli)


def test_the_wrapper_raises_on_what_the_kernel_does_not_take():
    chain = TR.make_chain(18)
    res = residues_of([5, 6], chain)
    with pytest.raises(TypeError, match="int64"):
        rns_redc(res.to(torch.int32), chain)
    wide = torch.zeros((2, 2 * (chain.n + 1)), dtype=torch.int64)
    with pytest.raises(ValueError, match="contiguous"):
        rns_redc(wide[:, ::2], chain)
    with pytest.raises(ValueError, match="9- and 18-channel"):
        rns_redc(residues_of([5], TR.make_chain(5)), TR.make_chain(5))
    with pytest.raises(ValueError, match="channels on the last axis"):
        rns_redc(res[:, :9].contiguous(), chain)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rns_redc(torch.empty(res.shape, dtype=torch.int64, device="meta"),
                 chain)
    with pytest.raises(ValueError, match="form"):
        rns_redc(res, chain, form="bytes")


def test_the_counter_counts_calls():
    chain = TR.make_chain(9)
    res = residues_of([1, 2, 3], chain)
    KRN.COUNTER.reset()
    rns_redc(res, chain)
    rns_redc(res, chain, form="words")
    rns_redc(res[:0], chain)
    assert (KRN.COUNTER.calls, KRN.COUNTER.launches) == (3, 0)


@pytest.mark.parametrize("n_channels", CHANNELS)
def test_the_engine_reduces_through_the_wrapper(n_channels):
    """``BN254Engine.reduce`` and ``e2e_words`` call the wrapper once each,
    under ``vpu_montgomery``, with no ATen op of their own."""
    from repro_torch.core import zones
    eng = TWK.BN254Engine(16, n_channels=n_channels, device="cpu")
    y = transformed_rows(n_channels)
    KRN.COUNTER.reset()
    assert torch.equal(eng.reduce(y), TR.rns_to_field(y, eng.chain))
    words = torch.randint(0, 2**31, (1, 16, 8), dtype=torch.int64)
    with zones.launch_log() as log:
        out = eng.e2e_words(words)
    assert out.shape == (1, 16, 8)
    assert KRN.COUNTER.calls == 2
    assert "vpu_montgomery" in log.scopes
    assert {r.kernel for r in log.records} == {"limb_matmul", "mont_fold"}


@pytest.mark.parametrize("shape", [(8, 16, 18), (1, 8, 9)],
                         ids=lambda s: "x".join(map(str, s)))
def test_the_card_check_inputs_open_with_the_edges(shape):
    """``edge_residues``, the card checks' inputs: each residue below its
    modulus, the first row opening with the edge elements below M, the same
    seed the same tensor; reduced by the wrapper as by the plain chain."""
    chain = TR.make_chain(shape[-1])
    x = edge_residues(shape, np.random.default_rng(3))
    assert x.shape == shape and x.dtype == torch.int64
    assert torch.equal(x, edge_residues(shape, np.random.default_rng(3)))
    assert bool((x >= 0).all())
    assert bool((x < torch.tensor(chain.moduli, dtype=torch.int64)).all())
    edges = [v for v in (0, 1, chain.M - 1, P - 1, P, D_MAX * (P - 1) ** 2)
             if v < chain.M]
    first = TR.from_rns_np(x[0, :len(edges)].numpy(), chain).tolist()
    assert first == edges
    assert torch.equal(rns_redc(x, chain, form="words"),
                       TMG.digits_to_words_u32(TR.rns_to_field(x, chain))
                       [..., :chain.n_words])

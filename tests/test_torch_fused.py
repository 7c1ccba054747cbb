"""The fused staging pass (K3) and the single-tenant fused transform of the
PyTorch port vs the JAX package.

On this CPU-only machine ``fused_ntt_tile`` runs its plain PyTorch version
(a CPU tensor takes it; a CUDA tensor would launch the CUDA kernel).  The
Pallas kernel runs in interpret mode, as ``tests/test_kernels.py`` runs it.
Exact comparisons (tolerance 0).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import field as JF
from repro.core import limb_gemm as JG
from repro.core import ntt as JNTT
from repro.core import rns as JR
from repro.kernels import fused_ntt_tile as j_fused_ntt_tile
from repro.kernels import fused_operand_3d as j_fused_operand_3d
from repro.kernels import pallas_fused_transform
from repro_torch.core import convert
from repro_torch.core import field as TF
from repro_torch.core import limb_gemm as TG
from repro_torch.core import rns as TR
from repro_torch.core import workloads as TWK
from repro_torch.kernels import (build, fused_ntt_tile, fused_operand_3d,
                                 fused_transform)
from repro_torch.kernels.fused_ntt_tile.kernel import COUNTER as K3
from repro_torch.kernels.fused_ntt_tile.ref import fused_ntt_tile_ref

Q = JF.DILITHIUM_Q
BN_M = JR.make_chain(9).moduli[0]
RNG = np.random.default_rng(11)


def _operands(n, k, d, n_diag):
    a = RNG.integers(0, 256, (n, k), dtype=np.uint8)
    b3 = RNG.integers(-128, 128, (k, d, n_diag)).astype(np.int8)
    return a, b3


@pytest.mark.parametrize("n,k,d,n_diag,m,accum", [
    (8, 384, 256, 5, Q, "int32_native"),
    (8, 384, 256, 5, Q, "fp32_mantissa"),
    (4, 256, 64, 7, BN_M, "fp32_mantissa"),    # a BN254 channel pass
    (4, 256, 64, 7, BN_M, "int32_native"),
    (3, 100, 70, 5, Q, "int32_native"),        # ragged N, K and D
    (8, 1, 64, 5, Q, "fp32_mantissa"),         # K = 1
    (8, 1, 64, 5, Q, "int32_native"),
    (4, 200, 40, 1, Q, "fp32_mantissa"),       # one diagonal
    (4, 200, 40, 1, Q, "int32_native"),
    (4, 200, 40, 8, (1 << 31) - 99, "fp32_mantissa"),   # eight diagonals
    (4, 200, 40, 8, (1 << 31) - 99, "int32_native"),
])
def test_fused_ntt_tile_matches_pallas(n, k, d, n_diag, m, accum):
    a, b3 = _operands(n, k, d, n_diag)
    want = np.asarray(j_fused_ntt_tile(jnp.asarray(a), jnp.asarray(b3),
                                       modulus=m, accum=accum))
    got = fused_ntt_tile(torch.from_numpy(a), torch.from_numpy(b3), modulus=m,
                         accum=accum)
    assert got.dtype == torch.int32 and got.shape == (n, d)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_fused_ntt_tile_folds_wrapped_int32_diagonals():
    """Past the window the int32 model wraps mod 2**32 before the fold, as
    K1 does: the diagonal is the wrapped (negative) int32, floor-modded."""
    k, m = 1 << 17, (1 << 31) - 99
    a = torch.full((1, k), 255, dtype=torch.uint8)
    b3 = torch.full((k, 2, 1), 127, dtype=torch.int8)
    wrapped = (255 * 127 * k + 2**31) % 2**32 - 2**31
    assert wrapped < 0
    got = fused_ntt_tile(a, b3, modulus=m)
    assert got.tolist() == [[wrapped % m, wrapped % m]]


def test_fused_ntt_tile_matches_pallas_at_the_window_edge():
    """Every product 255·(-128) and K = 513: each diagonal sits at the edge
    of the fp32 model's 2**24 window, in both models."""
    a = np.full((8, 513), 255, dtype=np.uint8)
    b3 = np.full((513, 16, 5), -128, dtype=np.int8)
    for accum in ("fp32_mantissa", "int32_native"):
        want = np.asarray(j_fused_ntt_tile(jnp.asarray(a), jnp.asarray(b3),
                                           modulus=Q, accum=accum))
        got = fused_ntt_tile(torch.from_numpy(a), torch.from_numpy(b3),
                             modulus=Q, accum=accum)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def _split_k_fold(a, b3, modulus, accum, cluster):
    """The CUDA kernel's order of summation, in plain torch.  Rank r of the
    cluster sums K slice r (ceil(K / cluster) k each) in 4 k groups.
    fp32_mantissa: group g runs over the slice-local k ≡ g mod 4 in order, a
    float32 multiply-add a step (each product of a u8 and an s8 is exact in
    float32, so a multiply then an add is the FFMA's result).  int32_native:
    group g takes the k quads with slice-local k // 4 ≡ g mod 4, summed as
    dp4a does, wrapping in int32 (uint32 carried in int64).  A block adds
    its groups in order and every output adds the ranks in order, in the
    accumulator's type; then the cast to int32 and the fold."""
    n, k = a.shape
    _, d, n_diag = b3.shape
    b2 = b3.reshape(k, d * n_diag)
    slice_ = -(-k // cluster)
    fp32 = accum == "fp32_mantissa"
    total = None
    for r in range(cluster):
        lo, hi = min(k, r * slice_), min(k, (r + 1) * slice_)
        local = torch.arange(hi - lo)
        block = None
        for g in range(4):
            ks = lo + local[(local % 4 == g) if fp32 else (local // 4 % 4 == g)]
            if fp32:
                part = torch.zeros((n, d * n_diag), dtype=torch.float32)
                for kk in ks.tolist():
                    part = part + (a[:, kk, None].to(torch.float32)
                                   * b2[kk].to(torch.float32))
            else:
                part = (a[:, ks].to(torch.int64) @ b2[ks].to(torch.int64)) % 2**32
            block = part if block is None else block + part
            if not fp32:
                block %= 2**32
        total = block if total is None else total + block
        if not fp32:
            total %= 2**32
    if fp32:
        diags = total.to(torch.int32)
    else:
        diags = (total - (total >= 2**31).to(torch.int64) * 2**32).to(torch.int32)
    return TF.fold_diagonals(diags.reshape(n, d, n_diag), modulus)


@pytest.mark.parametrize("accum", ["fp32_mantissa", "int32_native"])
def test_split_k_order_matches_plain_version(accum):
    """The kernel's split-K order (slices over a cluster of 1, 2, 4 or 8,
    k groups in a block) gives the plain version's bits: inside the 2**24
    window (random operands, a ragged K, every diagonal at the window's
    edge) and, under int32_native, for a sum that wraps to a negative
    int32."""
    edge = (torch.full((8, 513), 255, dtype=torch.uint8),
            torch.full((513, 16, 5), -128, dtype=torch.int8))
    cases = [tuple(map(torch.from_numpy, _operands(8, 513, 32, 5))),
             tuple(map(torch.from_numpy, _operands(3, 37, 10, 7))), edge]
    if accum == "int32_native":
        k = 70000
        cases.append((torch.full((2, k), 255, dtype=torch.uint8),
                      torch.full((k, 4, 1), 127, dtype=torch.int8)))
        wrapped = (255 * 127 * k + 2**31) % 2**32 - 2**31
        assert wrapped < 0
        want = fused_ntt_tile_ref(*cases[-1], Q, accum)
        assert int(want[0, 0]) == wrapped % Q
    for a, b3 in cases:
        for m in (Q, (1 << 31) - 99):
            want = fused_ntt_tile_ref(a, b3, m, accum)
            for cluster in (1, 2, 4, 8):
                got = _split_k_fold(a, b3, m, accum, cluster)
                assert torch.equal(got, want), (a.shape, b3.shape, m, cluster)


def _plans(d, accum):
    w = JNTT.ntt_matrix(d, Q, negacyclic=True)
    jp = JG.make_channel_plan(w, Q, data_limbs=3, tw_limbs=3, accum=accum)
    return w, jp, convert.channel_plan_from_numpy(dataclasses.asdict(jp))


@pytest.mark.parametrize("accum,passes", [("fp32_mantissa", 2),
                                          ("int32_native", 1)])
def test_fused_transform_matches_pallas_fused_transform(accum, passes):
    w, jp, tp = _plans(256, accum)
    a = RNG.integers(0, Q, (4, 256), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(pallas_fused_transform(jnp.asarray(a), jp))
    K3.reset()
    got = fused_transform(torch.from_numpy(a.astype(np.int64)), tp)
    assert got.dtype == torch.int64 and got.shape == (4, 256)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  JNTT.matrix_ntt_oracle_np(a, w, Q))
    assert (K3.calls, K3.launches) == (passes, 0)


def test_fused_transform_bn254_matches_engine():
    """Nine BN254 channels through the fused transform, then rns_to_field:
    the engine's e2e (K1 + K2 per pass), bit for bit."""
    eng = TWK.BN254Engine(64, device="cpu")
    coeffs = np.array([[int.from_bytes(RNG.bytes(16), "little")
                        for _ in range(64)] for _ in range(3)], object)
    a_res = eng.ingest(coeffs)
    K3.reset()
    y = torch.stack([fused_transform(a_res[..., ci], plan, planes=planes)
                     for ci, (plan, planes) in
                     enumerate(zip(eng.plans, eng.device_planes()))], dim=-1)
    assert K3.calls == eng.n_channels * eng.n_passes
    assert torch.equal(y, eng.evaluate(a_res))
    assert torch.equal(TR.rns_to_field(y, eng.chain), eng.e2e(a_res))


def test_fused_operand_3d_layout_matches_jax():
    _, jp, tp = _plans(64, "fp32_mantissa")
    got = fused_operand_3d(tp)
    assert got.shape == (64 * 3, 64, 5)
    assert got.tobytes() == np.asarray(j_fused_operand_3d(jp)).tobytes()


def test_fused_ntt_tile_rejects_bad_inputs():
    a, b3 = _operands(2, 16, 8, 5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b3)
    with pytest.raises(TypeError):
        fused_ntt_tile(ta.to(torch.int32), tb, modulus=Q)
    with pytest.raises(ValueError):
        fused_ntt_tile(ta, tb[:4], modulus=Q)
    with pytest.raises(ValueError):
        fused_ntt_tile(ta, tb.reshape(16, 40), modulus=Q)
    with pytest.raises(ValueError):
        fused_ntt_tile(ta, torch.zeros((16, 8, 9), dtype=torch.int8),
                       modulus=Q)
    with pytest.raises(ValueError):
        fused_ntt_tile(ta, tb, modulus=2**31)
    with pytest.raises(ValueError):
        fused_ntt_tile(ta, tb, modulus=1)
    with pytest.raises(ValueError):
        fused_ntt_tile(ta, tb, modulus=Q, accum="int64")
    with pytest.raises(ValueError):
        fused_ntt_tile(ta.to("meta"), tb.to("meta"), modulus=Q)


def test_fused_counter_counts_calls_not_launches_on_cpu():
    K3.reset()
    a, b3 = _operands(2, 16, 8, 5)
    fused_ntt_tile(torch.from_numpy(a), torch.from_numpy(b3), modulus=Q)
    assert (K3.calls, K3.launches) == (1, 0)


def test_fused_transform_needs_the_fused_operand():
    w = JNTT.ntt_matrix(64, Q, negacyclic=True)
    planar = TG.make_channel_plan(w, Q, data_limbs=3, tw_limbs=3,
                                  fuse_below=0)
    assert planar.fused_operand is None
    with pytest.raises(ValueError, match="fused operand"):
        fused_transform(torch.zeros((1, 64), dtype=torch.int64), planar)
    with pytest.raises(ValueError, match="fused operand"):
        fused_operand_3d(planar)


def test_replay_path_does_not_take_k3():
    """The staged transform and the engines stay on K1 + K2."""
    K3.reset()
    eng = TWK.DilithiumEngine(256, device="cpu")
    eng.e2e(RNG.integers(0, Q, (2, 256), dtype=np.uint64).astype(np.uint32))
    assert K3.calls == 0


def test_kernel_library_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """K2 and K3 include fold.cuh, K1 and K3 accum.cuh, all three
    launch.cuh, and all three and the graph reader instances.cuh: an edit
    to a header names a new library, so it is rebuilt."""
    assert set(build.headers()) == {"accum.cuh", "fold.cuh", "instances.cuh",
                                    "launch.cuh"}
    assert "fused_ntt_tile.cu" in build.SOURCES
    assert "fused_ntt_tile_launch" in build._PROTOTYPES
    for p in build.CSRC.glob("*.cu*"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path()
    with open(tmp_path / "fold.cuh", "a") as f:
        f.write("\n")
    assert build.library_path() != before

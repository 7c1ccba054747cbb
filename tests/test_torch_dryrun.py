"""The dry run's crypto cells (``repro_torch.launch.dryrun``) and the cost
model (``repro_torch.launch.graph_cost``) on the CPU.

The cell's step equals the JAX package's (``staged_transform_traced`` /
``staged_transform_scan`` per channel, then ``rns_to_field`` for BN254) bit
for bit on the same seeded numpy inputs; every cell's K1/K2 records equal
its fold profile; ``node_cost`` reproduces the bounds of ``PERF.md``'s
kernel table; the op census counts exact bytes and finds the per-plane
copies; ``roofline_terms`` keeps the JAX key names.  Nothing here times
anything: the cost model's numbers are counts and bounds from shapes.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import limb_gemm as JG
from repro.core import rns as JR
from repro.launch import hlo_analysis as JHA
from repro_torch.core import limb_gemm as TG
from repro_torch.core import limbs as L
from repro_torch.core import rns as TR
from repro_torch.core.scheduler.program import GraphProbe
from repro_torch.kernels.graph_census import GraphCensus, Node
from repro_torch.kernels.limb_matmul.ops import limb_matmul
from repro_torch.kernels.mont_fold.ops import mont_fold
from repro_torch.launch import dryrun as D
from repro_torch.launch import graph_cost as GC

ROWS, D_TEST = 8, 64
MODES = [dict(reduction="eager"), dict(reduction="lazy", kappa=2)]
FORMS = [False, True]


@pytest.fixture
def test_shape(monkeypatch):
    """A cell at the test size: 8 rows, d = 64."""
    monkeypatch.setitem(D.CRYPTO_SHAPES, "test", dict(rows_per_core=ROWS,
                                                      d=D_TEST))
    return "test"


def _jax_step(workload, a, w, *, scan, **kw):
    """The JAX package's cell step (src/repro/launch/dryrun.py:45-112) on
    numpy inputs, run eagerly: the transform per channel, then
    ``rns_to_field`` for BN254."""
    fn = JG.staged_transform_scan if scan else JG.staged_transform_traced
    limbs = D.LIMBS[workload]
    if workload == "dilithium":
        y = fn(jnp.asarray(a), jnp.asarray(w), modulus=D.DILITHIUM_Q,
               data_limbs=limbs, **kw)
        return np.asarray(y), None
    chain = JR.make_chain(9)
    y = jnp.stack([fn(jnp.asarray(a[..., c]), jnp.asarray(w[c]), modulus=m,
                      data_limbs=limbs, **kw)
                   for c, m in enumerate(chain.moduli)], axis=-1)
    return np.asarray(y), y


@pytest.fixture(scope="module")
def jax_digits():
    """JAX's ``rns_to_field`` of the BN254 test cell's channels, once: the
    channel outputs are the same in every mode and form."""
    a, w = D.cell_inputs("bn254", ROWS, D_TEST)
    _, y = _jax_step("bn254", a, w, scan=False)
    return np.asarray(JR.rns_to_field(y, JR.make_chain(9)))


@pytest.mark.parametrize("scan", FORMS, ids=["traced", "scan"])
@pytest.mark.parametrize("mode", MODES, ids=["eager", "lazy_k2"])
@pytest.mark.parametrize("workload", ["dilithium", "bn254"])
def test_step_equals_jax(workload, mode, scan, jax_digits):
    a, w = D.cell_inputs(workload, ROWS, D_TEST)
    want, _ = _jax_step(workload, a, w, scan=scan, **mode)
    step = D.make_step(workload, scan_staging=scan, **mode)
    got = step(torch.as_tensor(a.astype(np.int64)), torch.as_tensor(w))
    y = got if workload == "dilithium" else got[0]
    assert y.dtype == torch.int64
    assert np.array_equal(y.numpy().astype(np.uint32), want)
    assert np.array_equal(y.numpy(), D.channel_oracle(a, w, workload))
    if workload == "bn254":
        assert np.array_equal(got[1].numpy().astype(np.uint32), jax_digits)


def test_cell_inputs_are_seeded_and_in_range():
    for workload, c, limbs in (("dilithium", 1, 3), ("bn254", 9, 4)):
        a, w = D.cell_inputs(workload, ROWS, 32, seed=3)
        a2, w2 = D.cell_inputs(workload, ROWS, 32, seed=3)
        assert np.array_equal(a, a2) and np.array_equal(w, w2)
        assert a.dtype == np.uint32 and w.dtype == np.int8
        want = (ROWS, 32) if c == 1 else (ROWS, 32, c)
        assert a.shape == want
        assert w.shape == ((32, 32, limbs) if c == 1 else (c, 32, 32, limbs))
        for ch, m in enumerate(D.moduli(workload)):
            col = a if c == 1 else a[..., ch]
            assert int(col.max()) < m


@pytest.mark.parametrize("m", [D.DILITHIUM_Q, TR.make_chain(9).moduli[0]],
                         ids=["one_product", "split_halves"])
def test_oracle_equals_bignum(m):
    rng = np.random.default_rng(4)
    a = rng.integers(0, m, (3, 40), dtype=np.uint64)
    w = rng.integers(0, m, (40, 24), dtype=np.uint64)
    want = (a.astype(object) @ w.astype(object)) % m
    assert np.array_equal(D.oracle_mod_np(a, w, m), want.astype(np.int64))


# --- K1/K2 records against the fold profile -----------------------------------

@pytest.mark.parametrize("arch, shape, k1, k2", [
    ("aegis_dilithium", "serve_256", 18, 2),
    ("aegis_dilithium", "serve_8k", 432, 48),
    ("aegis_bn254", "serve_256", 288, 18),
    ("aegis_bn254", "serve_8k", 9216, 576),
])
@pytest.mark.parametrize("scan", FORMS, ids=["traced", "scan"])
def test_cell_profile_of_every_cell(arch, shape, k1, k2, scan):
    """The cells' K1/K2 calls: passes × La·Lw K1 and a K2 per pass, per
    channel (d_max 171 for Dilithium, 128 for BN254; the scan form pads
    nothing when eager)."""
    prof = D.cell_profile(D.WORKLOADS[arch], D.CRYPTO_SHAPES[shape]["d"],
                          scan_staging=scan)
    assert prof["launches"] == {"limb_matmul": k1, "mont_fold": k2}
    assert prof["n_folds"] == k2


@pytest.mark.parametrize("scan", FORMS, ids=["traced", "scan"])
@pytest.mark.parametrize("mode", MODES, ids=["eager", "lazy_k2"])
@pytest.mark.parametrize("arch", ["aegis_dilithium", "aegis_bn254"])
def test_cpu_cell_records_equal_fold_profile(test_shape, arch, mode, scan):
    rec = D.run_cell(arch, test_shape, device="cpu", scan_staging=scan,
                     **mode)
    nodes = rec["kernel_nodes"]
    assert {k: nodes[k] for k in ("limb_matmul", "mont_fold")} == \
        rec["fold_profile"]["launches"]
    assert nodes["fused_ntt_tile"] == 0 and nodes["other"] is None
    assert rec["status"] == "ok" and rec["exact"] and rec["v_codes"] == []
    assert (rec["rows"], rec["d"], rec["mesh"]) == (ROWS, D_TEST, "1")
    assert rec["device_ms"] is None          # not measured on the CPU


def test_serve_256_cells_run_on_the_cpu(tmp_path, capsys):
    """The CLI at serve_256 with --device cpu: one record per cell, each
    with the JAX record's keys."""
    D.main(["--arch", "all", "--shape", "serve_256", "--device", "cpu",
            "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["aegis_bn254__serve_256__1.json",
                     "aegis_dilithium__serve_256__1.json"]
    for name in files:
        rec = json.loads((tmp_path / name).read_text())
        for key in ("arch", "shape", "status", "rows", "d", "workload",
                    "accum", "reduction", "kappa", "scan_staging",
                    "roofline", "capture_s", "input_bytes",
                    "predicted_device_ms", "v_codes", "kernel_nodes"):
            assert key in rec, key
        assert rec["status"] == "ok"
        assert rec["roofline"]["dominant"] == "memory"
    out = capsys.readouterr().out
    assert out.count("[ok     ]") == 2 and "device=not measured" in out


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.run_cell("aegis_dilithium", "serve_256")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.main(["--shape", "serve_256"])


def test_unknown_cell_refused():
    with pytest.raises(SystemExit):
        D.main(["--arch", "olmo_9b", "--device", "cpu"])
    with pytest.raises(SystemExit):
        D.main(["--arch", "olmo_1b", "--shape", "serve_9k"])


# --- the cost model -----------------------------------------------------------

def _sig(x: float, table: str) -> bool:
    """``x`` printed to the significant digits of ``table`` reads ``table``."""
    digits = len(table.replace(".", "").lstrip("0"))
    return float(f"{x:.{digits}g}") == float(table)


# PERF.md §6, the kernel table's bound column (and K3's FFMA bound).
PERF_BOUNDS = [
    ("limb_matmul", dict(n=8, k=513, m=1280), "0.000209"),
    ("limb_matmul", dict(n=8, k=513, m=2560), "0.000418"),
    ("limb_matmul", dict(n=8, k=256, m=448), "0.000039"),
    ("limb_matmul", dict(n=1, k=8356, m=1), "0.0000050"),
    ("limb_matmul", dict(n=1, k=33419, m=1), "0.0000200"),
    ("mont_fold", dict(n_out=8 * 256, n_diag=5), "0.0000147"),
    ("mont_fold", dict(n_out=8 * 512, n_diag=5), "0.0000293"),
    ("mont_fold", dict(n_out=8 * 64, n_diag=7), "0.0000049"),
    ("fused_ntt_tile", dict(n=128, k=768, d=256, n_diag=5), "0.000362"),
    ("fused_ntt_tile", dict(n=128, k=513, d=256, n_diag=5), "0.000255"),
    ("fused_ntt_tile", dict(n=128, k=512, d=256, n_diag=7), "0.000333"),
    ("fused_ntt_tile", dict(n=8, k=6144, d=2048, n_diag=5), "0.0188"),
]


@pytest.mark.parametrize("kernel, args, table", PERF_BOUNDS,
                         ids=[f"{k}-{i}" for i, (k, _, _) in
                              enumerate(PERF_BOUNDS)])
def test_node_cost_reproduces_perf_bounds(kernel, args, table):
    ms, by = GC.bound_s(GC.node_cost(kernel, dict(args, fp32=False)),
                        "NVIDIA H100 80GB HBM3")
    assert by == "bytes" and _sig(ms * 1e3, table)


def test_node_cost_k1_bytes_and_ffma_bounds():
    c = GC.node_cost("limb_matmul", dict(n=8, k=513, m=1280, fp32=False))
    assert c == {"bytes": 701704, "tensor_ops": 2 * 8 * 513 * 1280,
                 "cuda_core_ops": 0, "bf16_ops": 0}
    assert GC.node_cost("limb_matmul", dict(n=8, k=513, m=1280, fp32=True)) \
        == {"bytes": 701704, "tensor_ops": 0,
            "cuda_core_ops": 2 * 8 * 513 * 1280, "bf16_ops": 0}
    assert _sig(GC.bound_s(c, "H100")[0] * 1e3, "0.000209")
    for args, table in ((dict(n=128, k=513, d=256, n_diag=5), "0.00253"),
                        (dict(n=128, k=512, d=256, n_diag=7), "0.00354")):
        ms, by = GC.bound_s(GC.node_cost("fused_ntt_tile",
                                         dict(args, fp32=True)), "H100")
        assert by == "operations" and _sig(ms * 1e3, table)


def test_node_cost_refuses_an_unknown_kernel_and_card():
    with pytest.raises(ValueError):
        GC.node_cost("empty", {})
    with pytest.raises(ValueError):
        GC.bandwidth("A100")


def test_op_census_counts_exact_bytes_on_a_toy_function():
    x = torch.arange(32, dtype=torch.int32).reshape(4, 8)
    y = torch.ones((4, 8), dtype=torch.int32)

    def toy(x, y):
        z = x + y                    # 3 × 128 B, 32 operations
        t = z.t()                    # a view: nothing
        c = t.contiguous()           # a copy: 128 B read, 128 B written
        s = c.sum()                  # 128 B read, 8 B written, 32 operations
        return s, c.to(torch.int64)  # a convert: 128 + 256 B, 32 operations

    census = GC.op_census(toy, x, y)
    assert census.out[0] == int((x + y).sum())
    by_op = census.by_op()
    assert by_op["aten.add.Tensor"] == {"calls": 1, "bytes": 384,
                                        "tensor_ops": 0, "cuda_core_ops": 32,
                                        "bf16_ops": 0}
    assert by_op["aten.clone.default"]["bytes"] == 256
    assert by_op["aten.clone.default"]["cuda_core_ops"] == 0
    assert by_op["aten.sum.default"]["bytes"] == 136
    assert by_op["aten._to_copy.default"]["bytes"] == 384
    assert census.aten() == {"bytes": 384 + 256 + 136 + 384, "tensor_ops": 0,
                             "cuda_core_ops": 32 + 32 + 32, "bf16_ops": 0}
    assert "aten.t.default" not in by_op
    assert census.kernel_args() == []


def test_op_census_leaves_the_kernels_to_the_launch_log():
    """On the CPU a wrapper runs its plain version as ATen ops; the walk
    leaves them out, and the launch log gives the kernel once."""
    a = torch.randint(0, 256, (8, 64), dtype=torch.uint8)
    b = torch.randint(-128, 128, (64, 35), dtype=torch.int8)
    census = GC.op_census(lambda: mont_fold(
        limb_matmul(a, b, accum="fp32_mantissa").view(8, 7, 5), 8380417))
    assert census.ops == []
    assert census.kernel_args() == [
        ("limb_matmul", {"n": 8, "k": 64, "m": 35, "fp32": True}),
        ("mont_fold", {"n_out": 56, "n_diag": 5, "modulus": 8380417})]
    cost = GC.log_cost(census, card="H100")
    assert cost["kernel_nodes"] == {"limb_matmul": 1, "mont_fold": 1,
                                    "fused_ntt_tile": 0, "other": None}
    assert cost["cost"] == GC.add(
        GC.node_cost("limb_matmul", dict(n=8, k=64, m=35, fp32=True)),
        GC.node_cost("mont_fold", dict(n_out=56, n_diag=5)))


def test_op_census_finds_the_per_plane_copies():
    """A per-plane transform copies A's limb plane and W's plane for each of
    the La·Lw limb pairs of every pass (core/limb_gemm.py, tile_diagonals):
    La·Lw copies of (N, tile) u8 and La·Lw of (tile, d) s8 per pass."""
    rows, d, tile, limbs = 8, 64, 32, 3
    a, w = D.cell_inputs("dilithium", rows, d)
    census = GC.op_census(TG.staged_transform_traced,
                          torch.as_tensor(a.astype(np.int64)),
                          torch.as_tensor(w), modulus=D.DILITHIUM_Q,
                          data_limbs=limbs, d_max=tile)
    passes = d // tile
    clones = [c["bytes"] for name, c in census.ops
              if name == "aten.clone.default"]
    assert clones.count(2 * rows * tile) == passes * limbs * limbs
    assert clones.count(2 * tile * d) == passes * limbs * limbs
    assert len(clones) == 2 * passes * limbs * limbs
    k1 = [args for kernel, args in census.kernel_args()
          if kernel == "limb_matmul"]
    assert len(k1) == passes * limbs * limbs


def test_roofline_terms_carry_the_jax_key_names():
    c = GC.cost(3_350_000, 1_979_000, 67_000)
    port = GC.roofline_terms(c, card="NVIDIA H100 80GB HBM3")
    jax_keys = set(JHA.roofline_terms({"flops": 1.0, "bytes accessed": 1.0},
                                      0, n_chips=1))
    assert jax_keys <= set(port)
    # a one-card program has no collective term
    assert port["collective_bytes_total"] == 0
    assert port["t_collective_s"] == 0
    assert port["bytes_per_chip"] == 3_350_000
    assert port["flops_per_chip"] == 1_979_000 + 67_000
    assert port["t_memory_s"] == pytest.approx(1e-6)
    assert port["t_compute_s"] == pytest.approx(2e-9)
    assert port["dominant"] == "memory"
    assert GC.roofline_terms(GC.cost(1, 0, 67_000_000), card="H100")[
        "dominant"] == "compute"


def test_program_cost_prices_the_graph_nodes_and_the_warmup_ops():
    """``program_cost`` on a probe's census (built here by hand, as the
    graph reader would return it): K nodes by ``node_cost``, the other
    kernel nodes counted, the warm-up's ATen ops added."""
    x = torch.ones((4, 8), dtype=torch.int32)
    census = GC.OpCensus()
    with census:
        x + x
    probe = GraphProbe.__new__(GraphProbe)
    probe.warmup_mode = census
    k1 = dict(n=8, k=64, m=35, fp32=True)
    nodes = [Node("limb_matmul", k1, (1, 2, 3)),
             Node(None, {"type": "kernel"}),
             Node("mont_fold", dict(n_out=56, n_diag=5, modulus=7), (3, 4))]
    probe.census = GraphCensus(nodes, [], {"kernel_nodes": {
        "limb_matmul": 1, "mont_fold": 1, "fused_ntt_tile": 0, "other": 1}})
    got = GC.program_cost(probe, card="H100")
    assert got["kernel_nodes"] == {"limb_matmul": 1, "mont_fold": 1,
                                   "fused_ntt_tile": 0, "other": 1}
    assert got["aten_ops"] == 1
    want = GC.add(GC.node_cost("limb_matmul", k1),
                  GC.node_cost("mont_fold", dict(n_out=56, n_diag=5)),
                  GC.cost(384, 0, 32))
    assert got["cost"] == want
    assert got["predicted_device_s"] == pytest.approx(sum(
        GC.bound_s(c, "H100")[0] for c in (
            GC.node_cost("limb_matmul", k1),
            GC.node_cost("mont_fold", dict(n_out=56, n_diag=5)),
            GC.cost(384, 0, 32))))
    probe.warmup_mode = None
    with pytest.raises(ValueError, match="OpCensus"):
        GC.program_cost(probe, card="H100")


def test_signed_digit_planes_recompose_to_the_oracle_matrix():
    """The oracle's W is the planes' signed value mod m, the matrix the
    transform multiplies by."""
    _, w = D.cell_inputs("dilithium", 1, 16)
    vals = L.signed_digits_value(w)
    assert vals.min() < 0 < vals.max()
    back = L.signed_digits(L.balanced_residue(vals % D.DILITHIUM_Q,
                                              D.DILITHIUM_Q), 3)
    assert np.array_equal(L.signed_digits_value(back) % D.DILITHIUM_Q,
                          vals % D.DILITHIUM_Q)

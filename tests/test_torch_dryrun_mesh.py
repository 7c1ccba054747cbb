"""The dry run's crypto cells planned on a mesh (``repro_torch.launch.dryrun``
``plan_crypto_cell``, ``run_share``, ``run_cell`` with ``multi_pod``) on the
CPU, against the JAX package's ``run_cell``.

JAX's ``_crypto_cell`` lowers ``rows_per_core`` × devices rows, sharded over
the data axes, against twiddle planes sharded over ``model`` on their output
columns, and records one device's program.  The port plans the same cell
over a fake process group and runs rank 0's block for real (the ``share``).
Held here: ``aegis_dilithium serve_256`` on 16 × 16 and 2 × 16 × 16 against
JAX's ``run_cell`` run live (a subprocess with JAX's 512 host devices):
rows, the per-device shapes of ``a``, the plane shard and the output, and
argument and output bytes at the port's element sizes (``a`` and the
residues int64 where JAX's are uint32), no collective; ``aegis_bn254
serve_256`` against JAX's figures written below; the plan's cost equal to
the census of the same block run for real; the work split over a small mesh
without repeating the kernels' work; the share's outputs against the oracle;
and no record naming a mesh it was not planned on.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch import dryrun as D
from repro_torch.launch import graph_cost as GC
from repro_torch.launch import mesh as MESH
from repro_torch.launch import shardings as SH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTION = {False: "16x16", True: "2x16x16"}

JAX_SCRIPT = r"""
import json
from repro.launch import dryrun as D
from repro.launch.mesh import make_production_mesh
out = {}
for multi in (False, True):
    rec = D.run_cell("aegis_dilithium", "serve_256", multi_pod=multi)
    lowered, _ = D._crypto_cell("aegis_dilithium", "serve_256",
                                make_production_mesh(multi_pod=multi))
    compiled = lowered.compile()
    args = lowered.args_info[0]
    rec["shards"] = [list(s.shard_shape(a.shape)) for s, a in
                     zip(compiled.input_shardings[0], args)]
    rec["out_shard"] = list(compiled.output_shardings.shard_shape(
        lowered.out_info.shape))
    out[str(multi)] = rec
print(json.dumps(out))
"""

# JAX's aegis_bn254 serve_256 on both production meshes (the same per
# device), from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "from repro.launch import \
#   dryrun as D; print(D.run_cell('aegis_bn254', 'serve_256', \
#   multi_pod=False)['memory'])"      (and multi_pod=True)
# with the shard shapes of its compiled input and output shardings.  Its
# compile takes ~20 s here, so the figures are written down.
JAX_BN254 = {"argument_size_in_bytes": 1327104,
             "output_size_in_bytes": 188416,
             "shards": [[128, 256, 9], [9, 256, 16, 4]],
             "out_shard": [128, 16, 23]}
# the bytes of an element: JAX's uint32 residues are int64 in the port
JAX_ITEM, PORT_ITEM = {"a": 4, "w": 1, "out": 4}, {"a": 8, "w": 1, "out": 8}


@pytest.fixture(scope="module")
def jax_dilithium() -> dict:
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT],
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH="src",
                                  JAX_PLATFORMS="cpu"), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture
def test_shape(monkeypatch):
    """A cell at the test size: 8 rows a device, d = 64."""
    monkeypatch.setitem(D.CRYPTO_SHAPES, "test", dict(rows_per_core=8, d=64))
    return "test"


def _bytes(shapes: dict, item: dict) -> dict:
    """Argument and output bytes of per-device shapes at ``item`` bytes an
    element."""
    return {"argument_size_in_bytes": sum(math.prod(shapes[k]) * item[k]
                                          for k in ("a", "w")),
            "output_size_in_bytes": math.prod(shapes["out"]) * item["out"]}


def _check_against_jax(rec: dict, jax_rec: dict, multi: bool):
    """``rec`` planned on JAX's mesh: JAX's rows and per-device shapes, and
    JAX's bytes at the port's element sizes; no collective."""
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == PRODUCTION[multi] and rec["multi_pod"] is multi
    assert rec["rows"] == 8 * (512 if multi else 256)
    jax_shapes = {"a": jax_rec["shards"][0], "w": jax_rec["shards"][1],
                  "out": jax_rec["out_shard"]}
    assert rec["shapes"] == jax_shapes
    # JAX's own figure is its shapes at its element sizes ...
    assert _bytes(jax_shapes, JAX_ITEM) == {
        k: jax_rec["memory"][k] for k in ("argument_size_in_bytes",
                                          "output_size_in_bytes")}
    # ... and the port's is the same shapes at the port's
    want = _bytes(jax_shapes, PORT_ITEM)
    assert {k: rec["memory"][k] for k in want} == want
    assert rec["collectives_naive"]["count"] == 0
    assert rec["collectives_naive"]["total"] == 0
    assert rec["roofline"]["n_chips"] == (512 if multi else 256)
    assert rec["roofline"]["collective_bytes_total"] == 0


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_dilithium_serve_256_against_jax(jax_dilithium, multi):
    jax_rec = jax_dilithium[str(multi)]
    assert jax_rec["collectives_naive"]["total"] == 0
    rec = D.run_cell("aegis_dilithium", "serve_256", multi_pod=multi,
                     device="cpu")
    assert rec["rows"] == jax_rec["rows"]
    _check_against_jax(rec, jax_rec, multi)
    share = rec["share"]
    assert share["exact"] and share["rows"] == 128 and share["cols"] == 16
    assert share["shapes"] == {"a": [128, 256], "w": [256, 16, 3]}
    assert share["kernel_nodes"]["limb_matmul"] == 18
    assert share["kernel_nodes"]["mont_fold"] == 2


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_bn254_serve_256_against_jax(multi):
    rec = D.run_cell("aegis_bn254", "serve_256", multi_pod=multi,
                     device="cpu")
    _check_against_jax(rec, {**JAX_BN254, "memory": JAX_BN254}, multi)
    assert rec["memory"]["argument_size_in_bytes"] == 2506752
    assert rec["memory"]["output_size_in_bytes"] == 2 * 188416
    share = rec["share"]
    assert share["exact"] and share["cols"] == 16
    assert {k: share["kernel_nodes"][k] for k in (D.K1, D.K2)} == \
        rec["fold_profile"]["launches"] == {D.K1: 288, D.K2: 18}


MODES = [dict(), dict(reduction="lazy", kappa=2, scan_staging=True)]


@pytest.mark.parametrize("mode", MODES, ids=["eager_traced", "lazy_scan"])
@pytest.mark.parametrize("arch", ["aegis_dilithium", "aegis_bn254"])
def test_plan_prices_the_block_as_its_run(test_shape, arch, mode):
    """The plan over a (2, 4) mesh prices one device exactly as the op
    census prices that device's block run for real: the same ATen ops on
    the same shapes, and the K1/K2 calls from the launch log alone (their
    plain versions' ops priced by neither); its K1/K2 calls a device are
    the fold profile's."""
    mesh = MESH.make_mesh((2, 4), ("data", "model"), ["cpu"])
    plan = D.plan_crypto_cell(arch, test_shape, mesh, **mode)
    share = D.run_share(arch, test_shape, mesh, device="cpu", **mode)
    assert plan["status"] == "ok", plan.get("error")
    assert plan["mesh"] == "2x4" and plan["rows"] == 64
    assert plan["shapes"]["a"][0] == share["rows"] == 32
    assert plan["shapes"]["w"] == share["shapes"]["w"]
    assert share["cols"] == 16 and share["exact"]
    assert plan["cost_by_kernel"] == share["cost_by_kernel"]
    assert plan["kernel_nodes"] == share["kernel_nodes"]
    assert {k: plan["kernel_nodes"][k] for k in (D.K1, D.K2)} == \
        plan["fold_profile"]["launches"]
    assert not any("mm" in name for name in plan["aten_top"])
    assert plan["collectives_naive"]["count"] == 0


@pytest.mark.parametrize("arch", ["aegis_dilithium", "aegis_bn254"])
def test_redundancy_on_a_small_mesh(test_shape, tmp_path, arch):
    """A (2, 4) plan against its 1 × 1 plan, per row: the kernels' work
    splits over the devices exactly; the whole is within 5 % of it, the
    rest the limb split of a device's rows, which every ``model`` shard
    repeats (``a`` is replicated over ``model``, as in JAX)."""
    mesh = MESH.make_mesh((2, 4), ("data", "model"), ["cpu"])
    one = D.plan_crypto_cell(arch, test_shape, D.ONE_MESH)
    rec = D.plan_crypto_cell(arch, test_shape, mesh)
    assert one["mesh"] == "1x1" and one["rows"] == 8
    assert one["shapes"]["w"] == list(D.block_shapes(
        D.WORKLOADS[arch], test_shape, D.ONE_MESH)["global"]["w"])
    for name, r in (("one", one), ("single", rec)):
        (tmp_path / f"{arch}__{test_shape}__{name}.json").write_text(
            json.dumps(r))
    cell = D.redundancy(tmp_path)[f"{arch}/{test_shape}"]
    ratio = cell["single"]["ratio"]
    assert 1.0 <= ratio <= 1.05

    def kernel_ops(r):
        return sum(r["cost_by_kernel"][k]["cuda_core_ops"]
                   for k in (D.K1, D.K2)) / r["rows"]
    assert kernel_ops(rec) * mesh.size == kernel_ops(one)


@pytest.mark.parametrize("scan", [False, True], ids=["traced", "scan"])
def test_transform_of_a_column_block_equals_jax_sliced(scan):
    """The staged transform of a block of output columns of the planes, as
    a mesh device runs it, equals the JAX package's transform of the whole
    planes, those columns, bit for bit."""
    import jax.numpy as jnp
    import torch
    from repro.core import limb_gemm as JG
    from repro_torch.core import limb_gemm as TG
    a, w = D.cell_inputs("dilithium", 8, 64)
    kw = dict(modulus=D.DILITHIUM_Q, data_limbs=3)
    jfn = JG.staged_transform_scan if scan else JG.staged_transform_traced
    tfn = TG.staged_transform_scan if scan else TG.staged_transform_traced
    want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(w), **kw))[:, 16:32]
    got = tfn(torch.as_tensor(a.astype(np.int64)),
              torch.as_tensor(w[:, 16:32].copy()), **kw)
    assert got.shape == (8, 16)
    assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_share_checks_its_outputs(test_shape, monkeypatch):
    """The share's outputs are held against the oracle: a wrong oracle
    makes it raise."""
    mesh = MESH.make_mesh((2, 4), ("data", "model"), ["cpu"])
    good = D.channel_oracle
    monkeypatch.setattr(D, "channel_oracle",
                        lambda a, w, workload: good(a, w, workload) + 1)
    with pytest.raises(AssertionError, match="differ from"):
        D.run_share("aegis_dilithium", test_shape, mesh, device="cpu")


def test_share_inputs_are_a_block_of_the_seeded_draw():
    """``cell_inputs`` with ``cols`` draws the block's shapes from the same
    generator; ``cols`` = d is the whole cell."""
    a, w = D.cell_inputs("bn254", 8, 32, cols=4)
    assert a.shape == (8, 32, 9) and w.shape == (9, 32, 4, 4)
    whole = D.cell_inputs("bn254", 8, 32)
    same = D.cell_inputs("bn254", 8, 32, cols=32)
    assert all(np.array_equal(x, y) for x, y in zip(whole, same))


def test_records_name_only_the_mesh_they_were_planned_on(test_shape,
                                                         tmp_path):
    """The CLI at the test size: the one-device cell is ``"1"`` with one
    device's rows; each mesh record's rows, block shapes and ``n_chips``
    are that mesh's; the share is the same block on both; ``--mesh one`` is
    1 × 1; a share from another block is refused."""
    D.main(["--arch", "aegis_dilithium", "--shape", test_shape,
            "--device", "cpu", "--out", str(tmp_path)])
    D.main(["--arch", "aegis_dilithium", "--shape", test_shape,
            "--device", "cpu", "--mesh", "both", "--out", str(tmp_path)])
    D.main(["--arch", "aegis_dilithium", "--shape", test_shape,
            "--device", "cpu", "--mesh", "one", "--out", str(tmp_path)])
    recs = {p.name.rsplit("__", 1)[1][:-5]: json.loads(p.read_text())
            for p in tmp_path.iterdir()}
    assert sorted(recs) == ["1", "multi", "one", "single"]
    assert (recs["1"]["mesh"], recs["1"]["rows"]) == ("1", 8)
    assert "memory" not in recs["1"] and "share" not in recs["1"]
    for tag, multi in (("single", False), ("multi", True)):
        rec = recs[tag]
        mesh = MESH.make_production_mesh(multi_pod=multi)
        assert rec["status"] == "ok"
        assert rec["mesh"] == "x".join(map(str, mesh.devices.shape))
        assert rec["rows"] == 8 * mesh.size
        assert rec["roofline"]["n_chips"] == mesh.size
        assert rec["shapes"]["a"] == list(SH.local_shape(
            (rec["rows"], 64), D.crypto_specs("dilithium", mesh)["a"], mesh))
        assert rec["share"]["shapes"]["a"] == rec["shapes"]["a"]
        assert rec["share"]["exact"]
    assert recs["one"]["mesh"] == "1x1" and recs["one"]["rows"] == 8
    assert all("mesh_rows" not in r for r in recs.values())
    other = dict(recs["single"]["share"], shapes={"a": [64, 64],
                                                   "w": [64, 4, 3]})
    with pytest.raises(ValueError, match="not this cell's block"):
        D.run_cell("aegis_dilithium", test_shape, multi_pod=False,
                   device="cpu", share=other)


def test_a_plan_runs_no_kernel_on_a_device():
    """Planning touches no device: a K1 wrapper given fake tensors is
    recorded by the launch log without an address and not held; the
    sharded census prices none of its plain version's ops and counts its
    output alone as live."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core import zones
    from repro_torch.kernels.limb_matmul.kernel import COUNTER
    from repro_torch.kernels.limb_matmul.ops import limb_matmul
    launches = COUNTER.launches
    mesh = MESH.make_mesh((2, 2), ("data", "model"), ["cpu"])
    census = GC.ShardedOpCensus()
    with D.fake_world(mesh), FakeTensorMode():
        a = torch.empty((8, 16), dtype=torch.uint8)
        b = torch.empty((16, 4), dtype=torch.int8)
        with census:
            out = limb_matmul(a, b, accum="fp32_mantissa")
        assert census.log is not None and census.peak == out.numel() * 4
    (rec,) = census.log.records
    assert rec.reads[0][0] is None and rec.writes[0][0] is None
    assert census.log._held == []
    assert census.ops == [] and COUNTER.launches == launches
    assert not zones.in_kernel_call()

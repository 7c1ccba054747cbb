"""The configuration ``bn254_full_mix`` and its cell ``zk.bn254full.closed512``:
the file holds the planned configuration (the fixture ``bn254_config``)
on every key they share, and the cell resolves by name to it, to the
traffic ``closed512`` and to the closed loop's metrics."""
import json
from pathlib import Path

from ffbench import gen, harness, work

HERE = Path(__file__).resolve().parent
CELL = "zk.bn254full.closed512"
METRICS = {
    "end_to_end": {"ops_per_s", "setup_s"},
    "per_layer": {"serve.rows_per_launch", "sched.service_ms_per_launch",
                  "transform_roofline", "device.idle_share.closed",
                  "host.gc_ms.closed"},
}


def test_file_holds_the_planned_configuration(bn254_config):
    cfg = json.loads((HERE / "configs" / "bn254_full_mix.json").read_text())
    shared = set(cfg) & set(bn254_config)
    assert shared == set(bn254_config)
    for key in shared:
        assert cfg[key] == bn254_config[key], key
    assert cfg["mixture"] == [["bn254_full", 1.0]]
    assert cfg["mixture_source"] == [["dilithium", 0.5], ["bn254", 0.5]]
    assert cfg["guarantees"] and cfg["assumed"]


def test_cell_resolves_by_name():
    cell = harness.Cell(CELL)
    assert cell.entry["config"] == "bn254_full_mix"
    assert cell.entry["traffic"] == "closed512"
    assert cell.entry["chips"] == 1
    assert cell.traffic == json.loads(
        (HERE / "traffic" / "closed512.json").read_text())
    assert cell.config["workload"] == "bn254_full"
    assert gen.element_shape(cell.config) == (8,)
    assert gen.buckets(cell.config["degrees"]) == [64, 128, 256, 512]
    assert work.launch_shape(cell.config) == {
        "limbs": 4, "channels": 18, "element_bytes": 32}
    for kind, names in METRICS.items():
        assert {m["name"] for m in cell.metrics(kind)} == names
        for name in names:
            assert callable(cell.reader(name))


def test_benchmark_entry_names_the_file_and_its_one_cut():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entry, = [c for c in bench["configs"] if c["name"] == "bn254_full_mix"]
    assert entry["file"] == "ffbench/configs/bn254_full_mix.json"
    assert entry["reduced"] == ["mixture"]
    cells = [w for w in bench["workloads"] if w["config"] == "bn254_full_mix"]
    assert [w["name"] for w in cells] == [CELL]

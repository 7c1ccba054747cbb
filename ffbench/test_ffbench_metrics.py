"""Metric readers on synthetic records, the least-work count, the trace
reader, and BENCHMARK.json's shape."""
import json
import math
import re
from pathlib import Path

import pytest
import torch

from ffbench import devtrace, harness, work
from ffbench.stats import percentile

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL_METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def _rec(loop):
    return {
        "loop": loop, "seconds": 2.0, "setup_s": 12.5,
        "served_in_window": 30000,
        "latencies_s": [0.001 * k for k in range(1, 101)][::-1],
        "lags_s": [0.0001 * k for k in range(100)],
        "queue_waits_s": [0.002 * k for k in range(1, 21)] + [None],
        "launches": [(256, 8, 8)] * 3 + [(64, 2, 8)],
        "service_s": 0.004,
        "gc_s": 0.15,
        "trace": {"window_s": 3.0, "busy_s": 0.3, "program_s": 0.01,
                  "least_s": 0.0001},
    }


WANT = {
    ("closed", "ops_per_s"): 15000.0,
    ("closed", "setup_s"): 12.5,
    ("open", "setup_s"): 12.5,
    ("open", "p50_ms"): 50.0,
    ("open", "p95_ms"): 95.0,
    ("open", "gen.lag_ms.p99"): 9.8,
    ("open", "serve.queue_ms.p50"): 20.0,
    ("open", "serve.queue_ms.p95"): 38.0,
    ("closed", "serve.rows_per_launch"): 6.5,
    ("closed", "sched.service_ms_per_launch"): 1.0,
    ("closed", "transform_roofline"): 1.0,
    ("closed", "device.idle_share.closed"): 90.0,
    ("open", "device.idle_share.open"): 90.0,
    ("open", "host.gc_ms.open"): 150.0,
    ("closed", "host.gc_ms.closed"): 150.0,
}


@pytest.mark.parametrize("loop,name", sorted(WANT))
def test_reader_gives_the_value(loop, name):
    read = harness.Cell("mldsa.closed512").reader(name)
    assert read(_rec(loop)) == pytest.approx(WANT[(loop, name)])


@pytest.mark.parametrize("name", ALL_METRICS)
def test_every_metric_has_a_reader_that_finds_nothing_in_an_empty_record(
        name):
    read = harness.Cell("mldsa.closed512").reader(name)
    empty = {"loop": "none", "seconds": 1.0, "setup_s": 1.0,
             "served_in_window": 0, "latencies_s": [], "lags_s": [],
             "queue_waits_s": [], "launches": [], "service_s": 0.0}
    value = read(empty)
    assert value is None or (name == "setup_s" and value == 1.0)


def test_a_share_never_reads_zero_without_device_time():
    read = harness.Cell("mldsa.closed512").reader("transform_roofline")
    rec = _rec("closed")
    rec["trace"]["program_s"] = 0.0
    assert read(rec) is None


def test_unanswered_requests_rank_above_every_answer():
    lat = [0.001] * 94 + [math.inf] * 6
    assert percentile(lat, 50) == 0.001
    assert percentile(lat, 95) == math.inf
    assert percentile([], 95) is None


def test_least_work_of_one_d256_launch_of_8_rows():
    limbs = work.limbs_for(8380417)
    assert limbs == 3
    # 8 rows in and out at 4 bytes a word, and the 256 x 256 matrix at 3 bytes
    assert work.launch_bytes(256, 8, limbs) == 8 * 256 * 4 * 2 + 256 * 256 * 3
    assert work.launch_bytes(256, 8, limbs) == 212992
    # 256 x 256 products a row, 3 x 3 byte products each, 2 ops a product
    assert work.launch_ops(256, 8, limbs) == 8 * 256 * 256 * 9 * 2
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    assert work.launch_least_s(256, 8, limbs, peak) == pytest.approx(
        212992 / 3.35e12)                  # bytes bound: 63.6 ns
    assert 9437184 / 1.979e15 < 212992 / 3.35e12


def test_least_work_of_one_bn254_d512_launch_of_8_rows(bn254_config):
    shape = work.launch_shape(bn254_config)
    # 31-bit channels at 4 bytes, 18 of them; elements of 8 words in and out
    assert shape == {"limbs": 4, "channels": 18, "element_bytes": 32}
    # 8 rows in and out at 32 bytes an element, 18 matrices 512 x 512 at 4
    assert work.launch_bytes(512, 8, **shape) == (8 * 512 * 32 * 2
                                                  + 18 * 512 * 512 * 4)
    assert work.launch_bytes(512, 8, **shape) == 19136512
    # 512 x 512 products a row and channel, 4 x 4 byte products, 2 ops each
    assert work.launch_ops(512, 8, 4, 18) == 18 * 8 * 512 * 512 * 16 * 2
    assert work.launch_ops(512, 8, 4, 18) == 1207959552
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    assert work.launch_least_s(512, 8, peak=peak, **shape) == pytest.approx(
        19136512 / 3.35e12)                # bytes bound: 5.71 us
    assert 1207959552 / 1.979e15 < 19136512 / 3.35e12


@pytest.mark.parametrize("name", ["mldsa_d256", "dilithium_mix"])
def test_a_configuration_without_work_is_counted_as_before(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    shape = work.launch_shape(cfg)
    assert shape == {"limbs": 3, "channels": 1, "element_bytes": 4}
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    for d, rows in ((64, 1), (256, 8), (512, 128)):
        assert work.launch_least_s(d, rows, peak=peak, **shape) == max(
            (2 * rows * d * 4 + d * d * 3) / peak["hbm_bytes_per_s"],
            2 * 3 * 3 * rows * d * d / peak["int8_ops_per_s"])


def _ev(name, start, end, device="cuda", annotation=False):
    return (name, device == "cuda", annotation, start, end)


def test_trace_reader_unions_busy_time_and_labels_idle_gaps():
    events = [
        _ev(devtrace.WINDOW, 1000.0, 2000.0, device="cpu"),
        _ev("void limb_matmul_kernel<float, true>", 900.0, 1100.0),
        _ev("void limb_matmul_kernel<float, true>", 1050.0, 1150.0),
        _ev("Memcpy HtoD (Pinned -> Device)", 1300.0, 1400.0),
        _ev("void mont_fold_kernel<5>", 1400.0, 1450.0),
        _ev("void at::native::elementwise_kernel<128, 4>", 1460.0, 1470.0),
        _ev("Memcpy DtoH (Device -> Pinned)", 1470.0, 1500.0),
        _ev("outside", 2100.0, 2200.0),
        _ev("annotation", 1000.0, 2000.0, annotation=True),
    ]
    # host spans in ns on the loop's clock; the window starts at 5e6 ns
    spans = [("submit", 5.0e6, 5.0e6 + 300e3), ("sleep", 5.0e6 + 300e3,
                                                5.0e6 + 1000e3)]
    s = devtrace.read_events(events, spans, 5.0e6)
    assert s["window_s"] == pytest.approx(1e-3)
    # 1000-1150, 1300-1450, 1460-1500
    assert s["busy_s"] == pytest.approx(340e-6)
    # the same but the copies between host and device: every kernel counts,
    # K1, K2 and the program's ATen kernel alike
    assert s["program_s"] == pytest.approx(210e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["submit"] == pytest.approx(150e-6)     # 1150-1300
    assert gaps["sleep"] == pytest.approx(510e-6)      # 1450-1460, 1500-2000
    assert s["device_ops"][0][0].startswith("void limb_matmul")


def test_benchmark_json_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ffbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]] + ALL_METRICS)
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in BENCH[kind]]
        assert len(seen) == len(set(seen))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("ffbench/")


def _reports(cell, kind):
    return {m["name"] for m in BENCH[kind]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_its_layer_metrics_move(cell):
    e2e = _reports(cell, "end_to_end")
    layer = [m for m in BENCH["per_layer"]
             if "workloads" not in m or cell in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])

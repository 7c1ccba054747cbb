"""The harness end to end on the CPU: a run is correct; the same run with
the timed path broken underneath is not; files added under a copy of the
benchmark are found by name.  The card's look is skipped (``device="cpu"``:
the program's plain versions); the card's own run is ``test_cell_on_card``."""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from ffbench import harness

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SEED = 2**31 + 4242
SECONDS = 0.3


def _run(cell="mldsa.closed512", root=ROOT, trace=False):
    result, _ = harness.run(cell, SEED, SECONDS, trace, device="cpu",
                            root=root)
    return result


def test_a_cpu_run_is_correct_and_reports_its_metrics():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] == r["checks"]["compared_rows"]["value"] > 0
    assert set(r["metrics"]) == {"ops_per_s", "setup_s"}
    assert list(r)[-1] == "checks"


def test_setup_s_ends_with_the_warm_up_not_the_payload_draw(monkeypatch):
    """The window's requests, drawn by the load generator after the warm-up,
    are outside ``setup_s`` and reported beside it; the draw is the same."""
    from ffbench import gen
    prefetch, drawn = gen.RequestSource.prefetch, []

    def slow(self, n):
        drawn.append((self.stream, self.seed, n, harness.clock()))
        time.sleep(0.5)
        return prefetch(self, n)
    monkeypatch.setattr(gen.RequestSource, "prefetch", slow)
    t_start = harness.clock()
    result, _ = harness.run("mldsa.closed512", SEED, SECONDS, False,
                            device="cpu", t_start=t_start)
    assert result["correct"] is True
    notes = result["notes"]
    parts = notes["setup_parts_s"]
    setup = result["metrics"]["setup_s"]["value"]
    assert setup == pytest.approx(
        parts["import"] + parts["server"] + parts["warm_up"], abs=1e-3)
    (stream, seed, n, t_sleep), = drawn
    assert t_sleep - t_start >= setup            # the sleep came after it
    assert parts["payloads"] >= 0.5 and parts["collect"] >= 0
    traffic = harness.Cell("mldsa.closed512").traffic
    assert (stream, seed) == ("window", SEED)
    assert n == notes["payload_requests_drawn"] == harness._pool_size(
        traffic, SECONDS, notes["warm_up_rate"])


# requests drawn before the window, by traffic, window seconds and the last
# warm-up round's rate: a closed loop's twice the rate's share plus one a
# client, an open loop's schedule plus one
POOLS = [("closed512", 40.0, 2261.0, 181_392),
         ("closed512", 43.5, 22_956.0, 1_997_684),
         ("poisson80_dmix", 40.0, 18_302.0, 384_001),
         ("poisson80_mldsa", 43.5, 0.0, 452_401)]


@pytest.mark.parametrize("traffic,seconds,rate,pool", POOLS)
def test_the_pool_size_is_pinned(traffic, seconds, rate, pool):
    law = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    assert harness._pool_size(law, seconds, rate) == pool


@pytest.fixture
def broken(monkeypatch):
    """Break the timed path underneath the harness, one way per test."""
    from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
    from repro_torch.serve.batcher import ContinuousBatcher

    def apply(kind):
        if kind == "unchanged":          # each row returned as it came in
            gather = SliceCoScheduler.gather

            def unchanged(self, flight):
                out = gather(self, flight)
                for dr in out:
                    dr.rows = np.array(dr.batch.operand[:len(dr.rows)],
                                       np.uint32)
                return out
            monkeypatch.setattr(SliceCoScheduler, "gather", unchanged)
        elif kind == "half_left_out":    # every other request never queued
            add = ContinuousBatcher.add
            seen = []

            def half(self, req, now):
                seen.append(req)
                return [] if len(seen) % 2 == 0 else add(self, req, now)
            monkeypatch.setattr(ContinuousBatcher, "add", half)
        elif kind == "one_answer_altered":   # once, inside the window
            gather, drive = SliceCoScheduler.gather, harness.drive
            window, done = [], []

            def in_window(loop, traffic, seconds, seed, stream):
                window.append(stream == "window")
                return drive(loop, traffic, seconds, seed, stream)

            def altered(self, flight):
                out = gather(self, flight)
                if window and window[-1] and not done and out:
                    out[0].rows = out[0].rows.copy()
                    out[0].rows[0, 0] ^= 1
                    done.append(1)
                return out
            monkeypatch.setattr(SliceCoScheduler, "gather", altered)
            monkeypatch.setattr(harness, "drive", in_window)
    return apply


@pytest.mark.parametrize("kind", ["unchanged", "half_left_out",
                                  "one_answer_altered"])
def test_a_broken_timed_path_comes_out_not_correct(broken, kind):
    broken(kind)
    r = _run()
    assert r["correct"] is False
    c = r["checks"]
    if kind == "half_left_out":
        assert c["missing_rows"]["value"] > 0
    else:
        assert c["wrong_rows"]["value"] >= 1
    if kind == "one_answer_altered":
        assert c["wrong_rows"]["value"] == 1


def test_files_added_to_a_copy_are_found_by_name(tmp_path):
    shutil.copytree(HERE, tmp_path / "ffbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    fb = tmp_path / "ffbench"
    cfg = json.loads((fb / "configs" / "mldsa_d256.json").read_text())
    cfg.update(name="ntt64", degrees={"law": "fixed", "d": 64})
    (fb / "configs" / "ntt64.json").write_text(json.dumps(cfg))
    (fb / "traffic" / "closed16.json").write_text(json.dumps(
        {"loop": "closed", "concurrency": 16}))
    (fb / "metrics" / "launch.count.py").write_text(
        "def read(rec):\n    return float(len(rec['launches']))\n")
    bench["configs"].append({"name": "ntt64", "source": "https://example.org",
                             "file": "ffbench/configs/ntt64.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "ntt64.closed16", "config": "ntt64",
                               "traffic": "closed16", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "launch.count", "unit": "launches",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["ntt64.closed16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell("ntt64.closed16", tmp_path)
    assert cell.config["degrees"]["d"] == 64
    assert cell.traffic["concurrency"] == 16
    r = _run("ntt64.closed16", root=tmp_path)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"setup_s", "launch.count"}
    assert r["metrics"]["launch.count"]["value"] > 0


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copytree(HERE, tmp_path / "ffbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "ffbench/run.py", "--workload",
                        "mldsa.closed512", "--seed", str(SEED), "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.chip
def test_cell_on_card(cuda_device):
    """One short run of the first cell on the card, as the driver runs it."""
    p = subprocess.run([sys.executable, "ffbench/run.py", "--workload",
                        "mldsa.closed512", "--seed", str(SEED), "--seconds",
                        "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_reads_every_row_wrong(cell):
    from ffbench import control
    (r,) = control.readings(cell, [SEED], 48, "cpu")
    assert r["wrong_rows"] == 48


@pytest.mark.chip
def test_control_on_card_at_the_cells_size(cuda_device):
    from ffbench import control
    # a 40 s run of the cell answers 779,213-920,703 rows
    for r in control.readings("mldsa.closed512", [SEED, SEED + 1, SEED + 2],
                              900_000, cuda_device):
        assert r["wrong_rows"] > 0

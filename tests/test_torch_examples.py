"""The port's crypto examples (``repro_torch.examples``) on the CPU.

Each example's ``main(["--device", "cpu", ...])`` runs at its smallest size
with every check it makes (each raises on a failure); quickstart's Table-1
rows on the CPU equal the JAX package's key for key; importing an example
runs nothing; without CUDA the default device raises.
"""
import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import accumulator as JACC
from repro_torch.examples import EXAMPLES

ROOT = Path(__file__).resolve().parents[1]

# Each example at its smallest size: the trace long enough to serve a
# Dilithium request, which the isolation checks need.
ARGS = {
    "quickstart": [],
    "mixed_workload": [],
    "multi_tenant_sequencer": ["--duration", "0.01"],
    "online_serving": ["--duration", "0.01"],
    "cluster_serving": ["--hosts", "2", "--duration", "0.01"],
}


def _main(name):
    return importlib.import_module(f"repro_torch.examples.{name}").main


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, capsys):
    summary = _main(name)(["--device", "cpu", *ARGS[name]])
    assert summary["ok"] and summary["device"] == "cpu"
    out = capsys.readouterr().out
    assert "✓" in out or "rate-limited" in out


def test_quickstart_table1_rows_equal_jax(capsys):
    summary = _main("quickstart")(["--device", "cpu"])
    assert summary["table1"] == JACC.table1_rows()
    assert summary["validated_from"] == "log" and summary["n_barriers"] == 1
    assert "plain version's row on the CPU" in capsys.readouterr().out


def test_mixed_workload_flags_the_cross_zone_read():
    summary = _main("mixed_workload")(["--device", "cpu"])
    assert summary["cross_zone_codes"] == ["V3"] and summary["separated_ok"]
    assert sorted(set(summary["workloads"])) == ["bn254", "dilithium"]


def test_cluster_hot_tenant_collapses_onto_one_host():
    summary = _main("cluster_serving")(["--device", "cpu", *ARGS[
        "cluster_serving"]])
    hot = summary["hot_per_host_requests"]
    assert sorted(hot)[:-1] == [0] * (len(hot) - 1) and max(hot) > 0
    assert sum(summary["per_host_requests"]) == summary["served"]


def test_importing_the_examples_runs_nothing():
    """A fresh interpreter imports every example: nothing printed, no
    kernel called."""
    code = (
        "import importlib\n"
        "from repro_torch.examples import EXAMPLES\n"
        "from repro_torch.kernels.limb_matmul.kernel import COUNTER\n"
        "for name in EXAMPLES:\n"
        "    importlib.import_module('repro_torch.examples.' + name)\n"
        "assert COUNTER.calls == 0\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _main(name)(ARGS[name])

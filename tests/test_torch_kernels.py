"""Kernel wrappers of the PyTorch port vs the JAX package's Pallas kernels.

On this CPU-only machine each wrapper runs its kernel's plain PyTorch
version (a CPU tensor takes it; a CUDA tensor would launch the CUDA kernel).
The Pallas kernels run in interpret mode, as ``tests/test_kernels.py`` runs
them.  Exact comparisons (tolerance 0).  Also: the port imports neither JAX
nor the JAX package, and nothing falls back to the CPU when CUDA is asked
for and absent.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import field as JF
from repro.core import rns as JR
from repro.kernels import limb_matmul as j_limb_matmul
from repro.kernels import mont_fold as j_mont_fold
from repro_torch.kernels import build
from repro_torch.kernels import limb_matmul, mont_fold, mont_fold_window_fn
from repro_torch.kernels.limb_matmul.kernel import COUNTER as K1
from repro_torch.kernels.mont_fold.kernel import COUNTER as K2

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(42)


def _operands(n, k, m):
    a = RNG.integers(0, 256, (n, k), dtype=np.uint8)
    b = RNG.integers(-128, 128, (k, m)).astype(np.int8)
    return a, b


@pytest.mark.parametrize("n,k,m", [
    (8, 512, 1792),    # BN254 staging pass (dt=128, La=4, d=256, 7 diagonals)
    (16, 513, 1280),   # Dilithium pass 1 (dt=171, La=3, d=256, 5 diagonals)
    (3, 100, 70),      # ragged small
    (128, 256, 128),   # ladder top rung
])
def test_limb_matmul_int32_matches_pallas(n, k, m):
    a, b = _operands(n, k, m)
    want = np.asarray(j_limb_matmul(jnp.asarray(a), jnp.asarray(b),
                                    accum="int32_native"))
    got = limb_matmul(torch.from_numpy(a), torch.from_numpy(b),
                      accum="int32_native")
    assert got.dtype == torch.int32 and got.shape == (n, m)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,k,m", [(8, 256, 384), (8, 513, 1280)])
def test_limb_matmul_fp32_matches_pallas(n, k, m):
    # K ≤ 513 keeps every partial sum inside the 2**24 window -> exact
    a, b = _operands(n, k, m)
    want = np.asarray(j_limb_matmul(jnp.asarray(a), jnp.asarray(b),
                                    accum="fp32_mantissa"))
    got = limb_matmul(torch.from_numpy(a), torch.from_numpy(b),
                      accum="fp32_mantissa")
    np.testing.assert_array_equal(got.numpy(), want)


def test_limb_matmul_int32_wraps_like_int32():
    """Past the window the int32 model wraps mod 2**32 (the plain version
    takes the sum exactly in float64 and wraps it through int64)."""
    k = 1 << 17
    a = torch.full((1, k), 255, dtype=torch.uint8)
    b = torch.full((k, 2), 127, dtype=torch.int8)
    exact = 255 * 127 * k
    wrapped = (exact + 2**31) % 2**32 - 2**31
    got = limb_matmul(a, b, accum="int32_native")
    assert got.tolist() == [[wrapped, wrapped]]


MONT_CASES = [
    (8, 256, 7, 2013265921, -(2**24), 2**24),
    (5, 300, 5, JF.DILITHIUM_Q, -(2**24), 2**24),
    (16, 64, 7, (1 << 31) - 99, -(2**24), 2**24),
    (8, 64, 5, JF.DILITHIUM_Q, -(2**31) + 1, 2**31 - 1),   # κ-summed windows
    (8, 64, 7, (1 << 31) - 99, -(2**31), 0),               # all negative
]


@pytest.mark.parametrize("n,d,n_diag,m,lo,hi", MONT_CASES)
def test_mont_fold_matches_pallas(n, d, n_diag, m, lo, hi):
    diags = RNG.integers(lo, hi, (n, d, n_diag)).astype(np.int32)
    want = np.asarray(j_mont_fold(jnp.asarray(diags), m))
    got = mont_fold(torch.from_numpy(diags), m)
    assert got.dtype == torch.int32 and got.shape == (n, d)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("m", JR.make_chain(9).moduli)
def test_mont_fold_bn254_channels_match_pallas(m):
    diags = RNG.integers(-(2**24), 2**24, (4, 64, 7)).astype(np.int32)
    want = np.asarray(j_mont_fold(jnp.asarray(diags), m))
    fold = mont_fold_window_fn()
    np.testing.assert_array_equal(
        fold(torch.from_numpy(diags), m).numpy().astype(np.uint32), want)


def test_wrappers_count_calls_not_launches_on_cpu():
    K1.reset()
    K2.reset()
    a, b = _operands(2, 16, 8)
    limb_matmul(torch.from_numpy(a), torch.from_numpy(b))
    mont_fold(torch.zeros((2, 3, 5), dtype=torch.int32), 17)
    assert (K1.calls, K1.launches, K2.calls, K2.launches) == (1, 0, 1, 0)


def test_wrappers_reject_bad_inputs():
    a, b = _operands(2, 16, 8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(TypeError):
        limb_matmul(ta.to(torch.int32), tb)
    with pytest.raises(ValueError):
        limb_matmul(ta, tb[:4])
    with pytest.raises(ValueError):
        limb_matmul(ta, tb, accum="int64")
    with pytest.raises(ValueError):
        limb_matmul(ta.to("meta"), tb.to("meta"))
    with pytest.raises(TypeError):
        mont_fold(torch.zeros((2, 5), dtype=torch.int64), 17)
    with pytest.raises(ValueError):
        mont_fold(torch.zeros((2, 9), dtype=torch.int32), 17)
    with pytest.raises(ValueError):
        mont_fold(torch.zeros((2, 5), dtype=torch.int32), 2**31)


def test_kernel_build_is_keyed_by_sources_and_needs_nvcc(monkeypatch):
    path = build.library_path()
    assert path.parent == ROOT / "build" / "repro_torch"
    assert path == build.library_path()           # deterministic
    for name in build.SOURCES:
        assert (build.CSRC / name).is_file()
    if not path.exists():
        # no nvcc on a CPU-only machine: the build raises, nothing falls back
        monkeypatch.setattr(build.shutil, "which", lambda _: None)
        monkeypatch.setattr(build.os.path, "exists", lambda _: False)
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build()


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module and chip_smoke import without JAX or the
    JAX package (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_no_cpu_fallback_without_cuda():
    """Without a CUDA device, the default device raises: nothing silently
    runs the plain versions instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
    from repro_torch.core.workloads import DilithiumEngine
    from repro_torch.launch.serve import serve_crypto
    from repro_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SliceCoScheduler()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_crypto(duration_s=0.001)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DilithiumEngine(64)
    # the training entry points
    from repro_torch.configs import smoke_config
    from repro_torch.examples import train_lm
    from repro_torch.launch.train import build
    from repro_torch.models.steps import init_train_state
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(smoke_config("olmo_1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(smoke_config("olmo_1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--steps", "1"])
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")

"""Build and bind the CUDA kernels of ``repro_torch/csrc``.

Each ``.cu`` file has a plain C interface; the ``.cuh`` headers beside them
hold device code that two kernels share.  ``graph_census.cu`` is host code
in the same library: the reader of captured CUDA graphs that the structural
validator uses.  At first use every source is
compiled by its own ``nvcc`` process (all started together) for ``sm_90a``,
the objects are linked into one shared library under ``build/repro_torch/``
at the repository root, and the library is loaded with ``ctypes``.  The
compiler's resource report (``-Xptxas -v``) is kept beside the library.  The file
name carries a hash of the sources, headers and flags, so a stale library is
never loaded.  Nothing here runs at import time, and nothing falls back: a
missing ``nvcc`` or a failed build raises.

Every kernel wrapper launches through :func:`launch`: the C entries are
resolved once, at the first launch, and each later call is one dictionary
lookup, the device index of the operands, PyTorch's current stream on that
device and the ctypes call.  The C entry makes that device current only when
it is not (``csrc/launch.cuh``) and returns ``cudaGetLastError()`` after the
launch; :func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("limb_matmul.cu", "mont_fold.cu", "fused_ntt_tile.cu", "empty.cu",
           "graph_census.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
# Compile-only flags: each kernel's registers, spills and shared memory go
# to the build's report (ptxas_report).
REPORT_FLAGS = ("-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entries: name -> argtypes (pointers and the stream as void*, ints as int).
# Every *_launch entry ends with the device index and the stream.
_PROTOTYPES = {
    "limb_matmul_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "limb_matmul_blocks": (_I, _I),
    "mont_fold_launch": (_P, _P, _I, _I, _I, _I, _P),
    "mont_fold_blocks": (_I,),
    "fused_ntt_tile_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "fused_ntt_tile_grid": (_I, _I, _I, _I, _P, _I, _P),
    "empty_launch": (_I, _P),
    "graph_census_size": (_P, _P),
    "graph_census_read": (_P, _I, _I, _P, _P, _P, _P, _I),
}

_lock = threading.Lock()
_entries = None     # name -> ctypes function, set once by entries()

# PyTorch's current stream on a device, as the integer handle a C entry
# takes.  The raw getter returns it without building a torch.cuda.Stream.
current_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


@dataclasses.dataclass
class KernelCounter:
    """Per-kernel counters.  ``calls`` counts every kernel call on any
    device; ``launches`` counts CUDA launches only, and proves that a run on
    the card went through the kernel.  A wrapper adds to them where it runs;
    a replayed program (``core/scheduler/program.py``) adds the counts
    its capture recorded, so both count kernel executions enqueued."""

    calls: int = 0
    launches: int = 0

    def reset(self):
        self.calls = 0
        self.launches = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels of repro_torch build on a machine "
                           "with the CUDA toolkit")
    return nvcc


def headers() -> tuple[str, ...]:
    """The shared ``.cuh`` headers the sources include."""
    return tuple(sorted(p.name for p in CSRC.glob("*.cuh")))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + REPORT_FLAGS).encode())
    for name in SOURCES + headers():
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def ptxas_log_path() -> Path:
    """The compiler's resource report (``-Xptxas -v``) of the library."""
    return library_path().with_suffix(".ptxas.txt")


def ptxas_report(pattern: str = "") -> list[dict]:
    """Registers, spill bytes and static shared memory of every kernel whose
    mangled name contains ``pattern``, parsed from the build's ``-Xptxas
    -v`` report (builds the library on first use)."""
    build()
    kernels, cur = [], None
    for line in ptxas_log_path().read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            cur = {"kernel": m.group(1), "registers": None,
                   "spill_stores": None, "spill_loads": None, "smem": 0}
            if pattern in cur["kernel"]:
                kernels.append(cur)
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                            line):
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m.group(1))
            if s := re.search(r"(\d+) bytes smem", line):
                cur["smem"] = int(s.group(1))
    return kernels


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the sources (one nvcc each, in parallel) and link the shared
    library, unless the library for these exact sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *REPORT_FLAGS, "-c", str(CSRC / name),
                   "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors, logs = [], []
        for cmd, _, p in procs:
            log, _ = p.communicate()
            logs.append(log)
            if p.returncode != 0:
                errors.append(f"{' '.join(cmd)} failed ({p.returncode}):\n{log}")
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp_lib = Path(tmp) / out.name
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
              *(str(obj) for _, obj, _ in procs)])
        report = Path(tmp) / ptxas_log_path().name
        report.write_text("".join(logs))
        os.replace(report, ptxas_log_path())
        os.replace(tmp_lib, out)     # atomic: a reader never sees half a file
    return out


def entries() -> dict:
    """The C entries of the kernel library (built on first use), argtypes
    set: name -> ctypes function."""
    global _entries
    with _lock:
        if _entries is None:
            lib = ctypes.CDLL(str(build()))
            fns = {}
            for name, argtypes in _PROTOTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                fns[name] = fn
            _entries = fns
    return _entries


def check(code: int, what: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{code}")


def pointers(name: str, *tensors: torch.Tensor) -> list[int]:
    """The data pointers of ``tensors`` for the C entry ``name``, which
    reads each one as a dense row-major array.  A tensor that is not
    contiguous (a transpose, a strided slice, a Fortran-ordered copy)
    raises here, before any C call: its pointer would hand the kernel the
    wrong elements."""
    for i, t in enumerate(tensors):
        if not t.is_contiguous():
            raise ValueError(
                f"{name}: operand {i} (shape {tuple(t.shape)}, strides "
                f"{t.stride()}) is not contiguous; the kernel reads it "
                f"row-major")
    return [t.data_ptr() for t in tensors]


def empty_call(device: torch.device):
    """A function that launches the empty kernel (``csrc/empty.cu``, one
    block of one thread) on ``device``'s current stream: the launch floor
    that measurements set a kernel's device time against.  No counter sees
    it."""
    fn = entries()["empty_launch"]

    def call():
        check(fn(device.index, current_stream(device.index)), "empty_launch")

    return call


def launch(name: str, like: torch.Tensor, *args):
    """Call the C entry ``name`` with ``args``, then the device index of
    ``like`` and PyTorch's current stream on that device; raise on a
    non-zero ``cudaError_t``.  The caller has checked its operands; ``like``
    is one of them, and a tensor that is not on a CUDA device raises here."""
    index = like.get_device()
    if index < 0:
        raise ValueError(f"{name}: a CUDA launch needs CUDA tensors, got one "
                         f"on {like.device}")
    fn = (_entries or entries())[name]
    check(fn(*args, index, current_stream(index)), name)

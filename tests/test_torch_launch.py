"""The launch path of the port's CUDA kernels, checked on the CPU.

ctypes converts each argument by the prototype in ``build._PROTOTYPES``; a
prototype that disagrees with its C signature shows only on the card, as a
truncated pointer or a shifted argument.  So the C signatures in
``csrc/*.cu`` are parsed here and held against the prototypes, and each
``*_cuda`` wrapper's call is held against its prototype's arity.  The
pure-Python part of :func:`build.launch` (device index, stream, the entry
resolved once, the error check) runs with a stand-in entry.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core.rns import make_chain
from repro_torch.kernels import build
from repro_torch.kernels.fused_ntt_tile import kernel as k3
from repro_torch.kernels.limb_matmul import kernel as k1
from repro_torch.kernels.mont_fold import kernel as k2
from repro_torch.kernels.rns_redc import kernel as kr

_C_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _c_signatures() -> dict:
    """name -> [each parameter as written] for every ``extern "C"`` entry."""
    sigs = {}
    for path in sorted(build.CSRC.glob("*.cu")):
        for name, params in _C_ENTRY.findall(path.read_text()):
            sigs[name] = [" ".join(p.split()) for p in params.split(",")]
    return sigs


def _ctype(param: str):
    """The ctypes type a C parameter needs: void* for every pointer, int for
    an int.  Anything else has no mapping here and fails."""
    if "*" in param:
        return build.ctypes.c_void_p
    assert param.split()[:-1] == ["int"], f"no ctypes mapping for {param!r}"
    return build.ctypes.c_int


def test_c_entries_and_prototypes_name_the_same_functions():
    assert set(_c_signatures()) == set(build._PROTOTYPES)


@pytest.mark.parametrize("name", sorted(build._PROTOTYPES))
def test_prototype_matches_c_signature(name):
    params = _c_signatures()[name]
    assert tuple(build._PROTOTYPES[name]) == tuple(map(_ctype, params)), (
        name, params)


@pytest.mark.parametrize("name", sorted(n for n in build._PROTOTYPES
                                        if n.endswith("_launch")))
def test_launch_entries_end_with_device_and_stream(name):
    *_, device, stream = _c_signatures()[name]
    assert (device, stream) == ("int device", "void* stream")


class _Entry:
    """Stands in for a ctypes function: records its arguments."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


class _OnDevice:
    """A tensor stand-in that reports CUDA device ``index``."""

    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


@pytest.fixture
def stand_in(monkeypatch):
    """build.launch with a stand-in entry table and stream: loading the
    library again would fail the test."""
    entry = _Entry()
    monkeypatch.setattr(build, "_entries", {"limb_matmul_launch": entry})
    monkeypatch.setattr(build, "current_stream", lambda index: 4096 + index)

    def no_reload():
        raise AssertionError("the entries were resolved again")

    monkeypatch.setattr(build, "entries", no_reload)
    return entry


def test_launch_appends_device_index_and_its_current_stream(stand_in):
    build.launch("limb_matmul_launch", _OnDevice(1), 11, 22, 33)
    build.launch("limb_matmul_launch", _OnDevice(0), 44)
    assert stand_in.calls == [(11, 22, 33, 1, 4097), (44, 0, 4096)]


def test_launch_raises_on_a_cuda_error(stand_in):
    stand_in.code = 700          # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match="limb_matmul_launch.*700"):
        build.launch("limb_matmul_launch", _OnDevice(0))


def test_launch_refuses_a_cpu_tensor_before_any_entry(stand_in):
    with pytest.raises(ValueError, match="CUDA tensors"):
        build.launch("limb_matmul_launch", torch.zeros(1))
    assert stand_in.calls == []


def test_current_stream_is_torchs_raw_getter_when_present():
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    assert callable(build.current_stream)
    if raw is not None:
        assert build.current_stream is raw


_RNG = np.random.default_rng(7)
_A = torch.from_numpy(_RNG.integers(0, 256, (3, 20), dtype=np.uint8))
_B = torch.from_numpy(_RNG.integers(-128, 128, (20, 10)).astype(np.int8))
_B3 = _B.view(20, 2, 5)
_D = torch.zeros((3, 4, 5), dtype=torch.int32)
_R = torch.zeros((3, 4, 18), dtype=torch.int64)
_CHAIN = make_chain(18)
_WRAPPERS = {
    "limb_matmul_launch": (k1, lambda: k1.limb_matmul_cuda(_A, _B, "int32_native")),
    "mont_fold_launch": (k2, lambda: k2.mont_fold_cuda(_D, 17)),
    "fused_ntt_tile_launch": (k3, lambda: k3.fused_ntt_tile_cuda(
        _A, _B3, 17, "fp32_mantissa")),
    "rns_redc_launch": (kr, lambda: kr.rns_redc_cuda(_R, _CHAIN, True)),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrapper_call_fills_its_prototype(name, monkeypatch):
    """A wrapper passes its pointers and ints in the prototype's order;
    build.launch adds the last two (device index, stream)."""
    module, call = _WRAPPERS[name]
    seen = []
    monkeypatch.setattr(build, "launch",
                        lambda entry, like, *args: seen.append((entry, args)))
    before = module.COUNTER.launches
    call()
    (entry, args), = seen
    assert entry == name
    assert len(args) + 2 == len(build._PROTOTYPES[name])
    for value, ctype in zip(args, build._PROTOTYPES[name]):
        assert isinstance(value, int), (name, value)
        if ctype is build.ctypes.c_int:
            assert -2**31 <= value < 2**31
    assert module.COUNTER.launches == before + 1


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrapper_on_cpu_tensors_raises_and_counts_nothing(name):
    """The *_cuda wrappers launch or raise: a CPU tensor is refused, and no
    launch is counted."""
    module, call = _WRAPPERS[name]
    before = module.COUNTER.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert module.COUNTER.launches == before


def _fortran(t):
    """The same values in the reversed (column-major) layout."""
    dims = tuple(reversed(range(t.dim())))
    return t.permute(dims).contiguous().permute(dims)


def _strided(t):
    """The same values as a strided slice: every other element of the last
    axis of a tensor twice as wide."""
    return torch.stack([t, t], dim=-1)[..., 0]


# wrapper entry -> (its operands, a call on given operands)
_OPERANDS = {
    "limb_matmul_launch": ((_A, _B), lambda a, b: k1.limb_matmul_cuda(
        a, b, "int32_native")),
    "mont_fold_launch": ((_D,), lambda d: k2.mont_fold_cuda(d, 17)),
    "fused_ntt_tile_launch": ((_A, _B3), lambda a, b3: k3.fused_ntt_tile_cuda(
        a, b3, 17, "fp32_mantissa")),
    "rns_redc_launch": ((_R,), lambda r: kr.rns_redc_cuda(r, _CHAIN, False)),
}


@pytest.fixture
def entries_on_card(monkeypatch):
    """Every launch entry replaced by a stand-in, reached through the real
    build.launch as if the operands were on cuda:0."""
    table = {name: _Entry() for name in _OPERANDS}
    monkeypatch.setattr(build, "_entries", table)
    monkeypatch.setattr(build, "current_stream", lambda index: 4096 + index)
    real = build.launch
    monkeypatch.setattr(build, "launch", lambda name, like, *args: real(
        name, _OnDevice(0), *args))
    return table


@pytest.mark.parametrize("layout", [_fortran, _strided],
                         ids=["transposed", "strided"])
@pytest.mark.parametrize("name,which", [(n, i) for n in sorted(_OPERANDS)
                                        for i in range(len(_OPERANDS[n][0]))])
def test_wrapper_refuses_a_non_contiguous_operand(entries_on_card, name,
                                                  which, layout):
    """A raw launcher hands data_ptr() to a kernel that reads row-major: an
    operand in another layout raises, naming the entry, before any C call."""
    operands, call = _OPERANDS[name]
    args = list(operands)
    args[which] = layout(args[which])
    assert torch.equal(args[which], operands[which])
    assert not args[which].is_contiguous()
    with pytest.raises(ValueError, match=f"{name}.*not contiguous"):
        call(*args)
    assert all(not e.calls for e in entries_on_card.values())


@pytest.mark.parametrize("name", sorted(_OPERANDS))
def test_wrapper_passes_contiguous_operands_to_the_entry(entries_on_card,
                                                         name):
    operands, call = _OPERANDS[name]
    call(*operands)
    (args,) = entries_on_card[name].calls
    assert args[:len(operands)] == tuple(t.data_ptr() for t in operands)
    assert args[-2:] == (0, 4096)


def test_launch_grid_reads_the_c_entry_through_its_out_pointer(monkeypatch):
    """K3's launch geometry comes from ``fused_ntt_tile_grid``, which takes
    the operand's card and writes blocks, cluster size and variant through
    its last pointer.  A CPU operand has no card and raises."""
    seen = []

    def grid_entry(n, k, d, n_diag, b3_ptr, device, out_ptr):
        seen.append((n, k, d, n_diag, b3_ptr, device))
        out = (build.ctypes.c_int * 3).from_address(out_ptr)
        out[0], out[1], out[2] = 256, 4, 1
        return 0

    class OnCard1:   # the two calls launch_grid makes of an operand on cuda:1
        def data_ptr(self):
            return _B3.data_ptr()

        def get_device(self):
            return 1

    monkeypatch.setattr(build, "entries",
                        lambda: {"fused_ntt_tile_grid": grid_entry})
    got = k3.launch_grid(8, 6144, 2048, 5, OnCard1())
    assert got == {"blocks": 256, "cluster": 4, "variant": "bulk"}
    assert seen == [(8, 6144, 2048, 5, _B3.data_ptr(), 1)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        k3.launch_grid(8, 6144, 2048, 5, _B3)
    assert len(seen) == 1


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121fused_ntt_tile_kernelIjLi5ELb1EEEvPKhPKaPiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121fused_ntt_tile_kernelIjLi5ELb1EEEvPKhPKaPiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 616 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116mont_fold_kernelILi5EEEvPKiPjij' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116mont_fold_kernelILi5EEEvPKiPjij
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 24 registers, 1024 bytes smem, 380 bytes cmem[0]
"""


def test_ptxas_report_parses_each_kernel(tmp_path, monkeypatch):
    log = tmp_path / "lib.ptxas.txt"
    log.write_text(_PTXAS_LOG)
    monkeypatch.setattr(build, "build", lambda: None)
    monkeypatch.setattr(build, "ptxas_log_path", lambda: log)
    k3_rows = build.ptxas_report("fused_ntt_tile_kernel")
    assert [(r["registers"], r["spill_stores"], r["spill_loads"], r["smem"])
            for r in k3_rows] == [(80, 0, 0, 0)]
    everything = build.ptxas_report()
    assert [(r["registers"], r["spill_stores"], r["spill_loads"], r["smem"])
            for r in everything] == [(80, 0, 0, 0), (24, 4, 12, 1024)]

"""The ``rns_redc`` CUDA kernel against its plain version on the card, bit
for bit, in both forms, at the served shapes of the 18-channel chain
((8, d, 18) for d = 64, 128, 256, 512 and (128, 512, 18)) and at
(8, 256, 9), with edge elements in the first rows; one launch a call; the
kernel captured in a CUDA graph and replayed on new residues; a served
``bn254_full`` program's reduce stage empty of ATen ops and one
kernel launch a run.  Needs a CUDA device and the kernel library's
toolchain; skips without a device.  Run on the card with
``PYTHONPATH=src python3 -m pytest -q -m chip
tests/test_torch_rns_redc_card.py``.  The CPU half is
``tests/test_torch_rns_redc.py``; this file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import rns as R
from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
from repro_torch.kernels.rns_redc import kernel as KRN
from repro_torch.kernels.rns_redc.ops import rns_redc
from repro_torch.kernels.rns_redc.ref import edge_residues, rns_redc_ref

SHAPES = [(8, 64, 18), (8, 128, 18), (8, 256, 18), (8, 512, 18),
          (128, 512, 18), (8, 256, 9)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.device("cuda")


def residues(shape, seed: int) -> torch.Tensor:
    """The kernel's check inputs (edge elements first) from ``seed``."""
    return edge_residues(shape, np.random.default_rng(seed))


@pytest.mark.chip
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("form", ["digits", "words"])
def test_kernel_equals_the_plain_version(cuda_device, shape, form):
    chain = R.make_chain(shape[-1])
    x = residues(shape, seed=sum(shape))
    xd = x.to(cuda_device)
    KRN.COUNTER.reset()
    got = rns_redc(xd, chain, form=form)
    torch.cuda.synchronize(cuda_device)
    assert (KRN.COUNTER.calls, KRN.COUNTER.launches) == (1, 1)
    assert got.is_cuda and got.dtype == torch.int64
    plain_card = rns_redc_ref(xd, chain, form)
    assert torch.equal(got, plain_card)
    if shape[0] == 8:
        assert torch.equal(got.cpu(), rns_redc_ref(x, chain, form))


@pytest.mark.chip
def test_kernel_in_a_captured_graph_reads_its_new_input(cuda_device):
    """The served path captures the kernel: a replay on new residues gives
    their reduction."""
    chain = R.make_chain(18)
    a, b = residues((8, 128, 18), 1), residues((8, 128, 18), 2)
    static = a.to(cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        rns_redc(static, chain, form="words")       # warm-up
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rns_redc(static, chain, form="words")
    static.copy_(b.to(cuda_device))
    graph.replay()
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(out.cpu(), rns_redc_ref(b, chain, "words"))


@pytest.mark.chip
@pytest.mark.parametrize("d", [64, 512])
def test_served_program_reduces_in_one_kernel(cuda_device, d):
    """A ``bn254_full`` program on the card: its reduction and its words
    are the kernel's (no ATen op of the reduce stage), one
    ``rns_redc`` launch a run."""
    cos = SliceCoScheduler(device=cuda_device)
    prog = cos.program_for("bn254_full", d,
                           cos.operand_shape("bn254_full", d, 8))
    assert prog.stage_ops["reduce"] == 0
    assert prog.stage_ops["ingest"] > 0 and prog.stage_ops["channels"] > 0
    assert prog.launches["rns_redc"] == 1
    assert prog.calls["rns_redc"] == 1

"""``--device-parallel`` over every card: the device spec a cluster
partitions.

The JAX package's ``ClusterServer`` partitions every device of the process
(``partition_devices(cfg.n_hosts)``).  The port's entry points default to
``device="cuda"``, which :func:`repro_torch.device.resolve_devices` reads as
the current card alone; under ``device_parallel`` the default (or None)
means every CUDA device, while ``"cuda:N"``, a list and ``"cpu"`` keep their
meaning.  Four cards are stood in for by the device count alone: the
partition and the co-schedulers name devices and touch none until their
first dispatch.
"""
import pytest
import torch

from repro_torch import device as D
from repro_torch.cluster import ClusterConfig, ClusterServer
from repro_torch.device import partition_devices
from repro_torch.launch import serve as S

CUDA = [torch.device("cuda", i) for i in range(4)]


@pytest.fixture
def four_cards(monkeypatch):
    monkeypatch.setattr(D, "_cuda_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("spec", [None, "cuda", torch.device("cuda")],
                         ids=["none", "cuda", "torch_device_cuda"])
def test_default_spec_partitions_every_card(four_cards, spec):
    cluster = ClusterServer(ClusterConfig(n_hosts=2, device_parallel=True,
                                          device=spec))
    assert cluster.device_partition == [CUDA[:2], CUDA[2:]]
    assert [srv.cos.devices for srv in cluster.hosts] == [CUDA[:2], CUDA[2:]]


def test_default_config_partitions_every_card(four_cards):
    cluster = ClusterServer(ClusterConfig(n_hosts=2, device_parallel=True))
    assert cluster.device_partition == [CUDA[:2], CUDA[2:]]


@pytest.mark.parametrize("spec, want", [
    ("cuda:1", [[CUDA[1]], [CUDA[1]]]),
    (["cuda:3", "cuda:1"], [[CUDA[3]], [CUDA[1]]]),
    ("cpu", [[torch.device("cpu")]] * 2),
], ids=["one_card", "list", "cpu"])
def test_named_devices_keep_their_meaning(four_cards, spec, want):
    cluster = ClusterServer(ClusterConfig(n_hosts=2, device_parallel=True,
                                          device=spec))
    assert cluster.device_partition == want


def test_one_card_is_unchanged(monkeypatch):
    """With one card, every spec of it partitions to that card."""
    monkeypatch.setattr(D, "_cuda_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for spec in (None, "cuda", "cuda:0"):
        assert partition_devices(2, spec) == [[CUDA[0]], [CUDA[0]]]


def test_resolve_devices_keeps_the_current_card(four_cards):
    """Outside the partition a bare ``"cuda"`` is still one card."""
    assert D.resolve_devices("cuda") == [CUDA[0]]
    assert D.resolve_devices(None) == CUDA


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv, want", [
    ([], [CUDA[:2], CUDA[2:]]),
    (["--device", "cuda"], [CUDA[:2], CUDA[2:]]),
    (["--device", "cuda:1"], [[CUDA[1]], [CUDA[1]]]),
    (["--device", "cpu"], [[torch.device("cpu")]] * 2),
], ids=["default", "cuda", "one_card", "cpu"])
def test_cli_resolves_the_same_way(four_cards, monkeypatch, argv, want):
    """The CLI's ``--device-parallel`` builds the cluster that
    ``ClusterServer`` partitions as above (the run is stopped once the
    cluster exists)."""
    import repro_torch.cluster as C
    built = []

    class Recording(ClusterServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)
            raise _Stop

    monkeypatch.setattr(C, "ClusterServer", Recording)
    with pytest.raises(_Stop):
        S.main(["--mode", "crypto-online", "--hosts", "2",
                "--device-parallel", "--duration", "0.001", *argv])
    assert built[0].device_partition == want


def test_cli_help_documents_every_card(capsys):
    with pytest.raises(SystemExit):
        S.main(["--help"])
    help_text = " ".join(capsys.readouterr().out.split())
    assert "the default 'cuda' means every card" in help_text

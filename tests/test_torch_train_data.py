"""The port's synthetic LM stream (``repro_torch.data``, a copy of the JAX
package's numpy pipeline) against ``repro.data`` bit for bit: ``batch_at``,
iteration, ``restore``, ``reshard``, host shards and the frontend's
``embeds``; then the counterparts of ``tests/test_training_substrate.py``'s
``test_stream_*`` and the move to a device."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMStream as JStream
from repro_torch.data import DataConfig, SyntheticLMStream, batch_to_device

CONFIGS = [dict(seq_len=32, global_batch=8, vocab_size=100, seed=3),
           dict(seq_len=128, global_batch=4, vocab_size=50304, seed=0),
           dict(seq_len=17, global_batch=6, vocab_size=7, seed=12345),
           dict(seq_len=16, global_batch=4, vocab_size=256, seed=1,
                frontend_len=8, d_model=64)]


def _pair(kw, **stream_kw):
    return (SyntheticLMStream(DataConfig(**kw), **stream_kw),
            JStream(JDataConfig(**kw), **stream_kw))


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: f"s{kw['seq_len']}"
                         f"b{kw['global_batch']}v{kw['vocab_size']}")
def test_stream_matches_jax_bit_for_bit(kw):
    port, jax_stream = _pair(kw)
    for step in (0, 1, 7, 1000, 2**31 + 5):
        _equal(port.batch_at(step), jax_stream.batch_at(step))
    for _ in range(3):
        _equal(next(port), next(jax_stream))
    assert port.state() == jax_stream.state()


def test_restore_and_reshard_match_jax():
    kw = CONFIGS[0]
    port, jax_stream = _pair(kw)
    state = {"step": 5, "seed": 3, "host_id": 0, "n_hosts": 1}
    port.restore(state)
    jax_stream.restore(state)
    _equal(next(port), next(jax_stream))
    for host in range(2):
        p2, j2 = port.reshard(host, 2), jax_stream.reshard(host, 2)
        assert p2.state() == j2.state() and p2.local_batch == 4
        _equal(next(p2), next(j2))


def test_host_shards_match_jax():
    kw = dict(seq_len=16, global_batch=8, vocab_size=50, seed=1)
    for host in range(4):
        port, jax_stream = _pair(kw, host_id=host, n_hosts=4)
        _equal(next(port), next(jax_stream))
        assert port.state() == jax_stream.state()


def test_frontend_embeds_match_jax():
    port, jax_stream = _pair(CONFIGS[-1])
    got, want = port.batch_at(2), jax_stream.batch_at(2)
    assert got["embeds"].shape == (4, 8, 64)
    assert got["embeds"].dtype == np.float32
    _equal(got, want)


def test_stream_deterministic_and_restorable():
    cfg = DataConfig(seq_len=32, global_batch=8, vocab_size=100, seed=3)
    s1 = SyntheticLMStream(cfg)
    batches = [next(s1) for _ in range(5)]
    s2 = SyntheticLMStream(cfg)
    s2.restore({"step": 3, "seed": 3, "host_id": 0, "n_hosts": 1})
    np.testing.assert_array_equal(next(s2)["tokens"], batches[3]["tokens"])
    with pytest.raises(ValueError):
        s2.restore({"step": 3, "seed": 4, "host_id": 0, "n_hosts": 1})


def test_stream_sharding_partitions_batch():
    cfg = DataConfig(seq_len=16, global_batch=8, vocab_size=50, seed=1)
    hosts = [SyntheticLMStream(cfg, host_id=i, n_hosts=4) for i in range(4)]
    batches = [next(h) for h in hosts]
    assert all(b["tokens"].shape == (2, 16) for b in batches)
    assert not np.array_equal(batches[0]["tokens"], batches[1]["tokens"])
    with pytest.raises(ValueError):
        SyntheticLMStream(cfg, n_hosts=3)


def test_config_equals_jax():
    assert ([f.name for f in dataclasses.fields(DataConfig)]
            == [f.name for f in dataclasses.fields(JDataConfig)])


def test_batch_to_device():
    stream = SyntheticLMStream(DataConfig(**CONFIGS[-1]))
    batch = stream.batch_at(0)
    moved = batch_to_device(batch, "cpu")
    assert moved["tokens"].dtype == moved["labels"].dtype == torch.int64
    assert moved["embeds"].dtype == torch.float32
    for key in batch:
        np.testing.assert_array_equal(moved[key].numpy(), batch[key])

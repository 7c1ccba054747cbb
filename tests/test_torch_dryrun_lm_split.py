"""The dry run's LM cells whose head counts, SSD heads or experts do not
divide the ``model`` axis, planned on a (2, 4) ``data`` × ``model`` CPU
mesh at smoke width (``test_torch_dryrun_lm.smoke_overrides``), the head
counts overridden to the full configs' ratios.

Each family runs through its per-device region: a projection viewed as
heads that do not divide ``model`` (``split_heads``: gathered there), the
query heads of one GQA group on a device (``per_device_attention``),
whisper's cross attention and encoder, internvl2's vision prefix, hymba's
window ring under a sequence-sharded cache, SSD per device and the MoE
dispatch per device, with an expert count that divides ``model`` (expert
parallel) and one that does not (``MOE_ALT``'s d_ff sharding).  Each cell
is ``ok`` with JAX's record keys, and its argument bytes are the shards of
JAX's own specs on the same mesh.  ``test_torch_split_numeric.py`` holds
the regions' values against the unsharded port.
"""
import pytest

from test_torch_dryrun_lm import (MEMORY_KEYS, RECORD_KEYS,
                                  _jax_argument_bytes, _mesh,
                                  smoke_overrides)
from repro_torch.launch import dryrun as D
from repro_torch.launch import graph_cost as GC

CELLS = [
    ("internlm2_20b", "decode_32k", {"n_heads": 12, "n_kv_heads": 2}),
    ("starcoder2_7b", "decode_32k", {"n_heads": 9, "n_kv_heads": 1}),
    ("whisper_large_v3", "decode_32k", {"n_heads": 5, "n_kv_heads": 5}),
    ("whisper_large_v3", "prefill_32k", {"n_heads": 5, "n_kv_heads": 5}),
    ("hymba_1_5b", "decode_32k", {"n_heads": 5, "n_kv_heads": 1,
                                  "ssm_heads": 2}),
    ("hymba_1_5b", "long_500k", {"n_heads": 5, "n_kv_heads": 1}),
    ("internvl2_1b", "prefill_32k", {}),
    ("llama3_405b", "decode_32k", {"n_heads": 16, "n_kv_heads": 2}),
    ("granite_moe_3b_a800m", "decode_32k", {"n_heads": 6, "n_kv_heads": 2}),
    ("granite_moe_3b_a800m", "decode_32k", {"n_heads": 6, "n_kv_heads": 2,
                                            "n_experts": 6}),
    ("moonshot_v1_16b_a3b", "decode_32k", {}),
    ("moonshot_v1_16b_a3b", "decode_32k", {"n_experts": 6}),
    ("mamba2_370m", "decode_32k", {}),
    # the full config's SSD chunk: 256 chunks of 32k, not 2,048
    ("mamba2_370m", "prefill_32k", {"ssm_chunk": 128}),
]


@pytest.mark.parametrize(
    "arch,shape,extra", CELLS,
    ids=[f"{a}-{s}-" + "-".join(f"{k}{v}" for k, v in x.items())
         for a, s, x in CELLS])
def test_split_cell_plans_with_jax_record(arch, shape, extra):
    overrides = {**smoke_overrides(arch), **extra}
    rec = D.run_lm_cell(arch, shape, overrides=overrides, mesh=_mesh("2x4"))
    assert rec["status"] == "ok", rec.get("error")
    for k in RECORD_KEYS:
        assert k in rec, k
    assert set(rec["memory"]) == set(MEMORY_KEYS)
    assert rec["memory"]["argument_size_in_bytes"] == _jax_argument_bytes(
        arch, shape, "2x4", overrides)
    coll = rec["collectives_naive"]
    assert set(coll) == set(GC.COLLECTIVES) | {"count", "total"}
    assert coll["count"] > 0 and coll["total"] == sum(
        coll[k] for k in GC.COLLECTIVES)
    assert rec["roofline"]["n_chips"] == 8

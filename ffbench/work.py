"""The least time one launch of the transform could take on the card.

The method is the paper's (section 6): the matrix form of the transform,
with each coefficient and each twiddle split into ``limbs`` bytes, so one
output of one row costs ``d`` products of ``limbs × limbs`` byte products,
each a multiply-add (2 operations, as the data sheet counts int8 TOP/s).
A field too wide for one such product (BN254's F_r) is computed exactly
over ``channels`` residue channels (section 6.2: an RNS transform, one
matrix product per channel of ``channel_bits``-bit primes), and each
channel is counted as one such transform.

A configuration may give ``"work": {"channels": C, "channel_bits": b,
"element_bytes": e}``; then ``limbs`` is ⌈b / 8⌉.  Without it, C is 1,
``limbs`` is the bytes of a residue mod the configuration's modulus, and e
is one 4-byte word.  Per launch of ``rows`` live rows of bucket ``d``:

* bytes: each live row's input and output once, ``d`` elements of ``e``
  bytes each way (a request is its coefficients zero-padded to its
  bucket), plus each channel's ``d × d`` twiddle matrix at ``limbs`` bytes
  an entry, once per launch;
* operations: ``2 · C · limbs² · d²`` per live row;
* least time: max(bytes ÷ HBM bandwidth, operations ÷ int8 rate).

Not counted: the elementwise work between the field and its channels (in
BN254's case the residues of each input, and ``rns_to_field``'s base
extension and Montgomery reduction of each output), which is no matrix
product.

The count is the yardstick's, computed from the launch's size alone, not
from what the program's kernels read.  A program that computes the
transform by another method (butterflies, say) needs a benchmark change to
recount it.
"""
from __future__ import annotations

import json
from pathlib import Path

WORD_BYTES = 4
PEAKS = Path(__file__).with_name("peaks.json")


def limbs_for(modulus: int) -> int:
    """Bytes a residue mod ``modulus`` splits into."""
    return (int(modulus - 1).bit_length() + 7) // 8


def launch_shape(config: dict) -> dict:
    """A configuration's ``limbs``, ``channels`` and ``element_bytes``."""
    if "work" not in config:
        return {"limbs": limbs_for(int(config["modulus"])), "channels": 1,
                "element_bytes": WORD_BYTES}
    w = config["work"]
    return {"limbs": (int(w["channel_bits"]) + 7) // 8,
            "channels": int(w["channels"]),
            "element_bytes": int(w["element_bytes"])}


def launch_bytes(d: int, rows: int, limbs: int, channels: int = 1,
                 element_bytes: int = WORD_BYTES) -> int:
    return 2 * rows * d * element_bytes + channels * d * d * limbs


def launch_ops(d: int, rows: int, limbs: int, channels: int = 1) -> int:
    return 2 * channels * limbs * limbs * rows * d * d


def peaks(kind: str) -> dict:
    """The card's published peaks, by ``torch.cuda.get_device_name()``."""
    table = json.loads(PEAKS.read_text())
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in {PEAKS.name}")
    return table[kind]


def launch_least_s(d: int, rows: int, limbs: int, peak: dict,
                   channels: int = 1, element_bytes: int = WORD_BYTES) -> float:
    return max(launch_bytes(d, rows, limbs, channels, element_bytes)
               / peak["hbm_bytes_per_s"],
               launch_ops(d, rows, limbs, channels) / peak["int8_ops_per_s"])

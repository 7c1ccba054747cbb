"""The least time one launch of the transform could take on the card.

The method is the paper's (section 6): the matrix form of the transform,
with each coefficient and each twiddle split into ``limbs`` bytes, so one
output of one row costs ``d`` products of ``limbs × limbs`` byte products,
each a multiply-add (2 operations, as the data sheet counts int8 TOP/s).

Per launch of ``rows`` live rows of bucket ``d``:

* bytes: each live row's input and output once, 4-byte words of ``d``
  coefficients each way (a request is its coefficients zero-padded to its
  bucket), plus the ``d × d`` twiddle matrix at ``limbs`` bytes an entry,
  once per launch;
* operations: ``2 · limbs² · d²`` per live row;
* least time: max(bytes ÷ HBM bandwidth, operations ÷ int8 rate).

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


def launch_bytes(d: int, rows: int, limbs: int) -> int:
    return 2 * rows * d * WORD_BYTES + d * d * limbs


def launch_ops(d: int, rows: int, limbs: int) -> int:
    return 2 * limbs * limbs * rows * d * d


def peaks(kind: str) -> dict:
    """The card's published peaks, by ``torch.cuda.get_device_name()``."""
    table = json.loads(PEAKS.read_text())
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in {PEAKS.name}")
    return table[kind]


def launch_least_s(d: int, rows: int, limbs: int, peak: dict) -> float:
    return max(launch_bytes(d, rows, limbs) / peak["hbm_bytes_per_s"],
               launch_ops(d, rows, limbs) / peak["int8_ops_per_s"])

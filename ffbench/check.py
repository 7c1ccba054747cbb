"""The comparison that decides ``correct``: every answered request's row
against the plain reference, computed after the window has closed.

A request's reference is its coefficients zero-padded to its bucket and
transformed by the configuration's reference (``reference/<name>.py``),
which is given the benchmark's own inputs and nothing the program made.
A coefficient, and so an answer's entry, is a word or a field element of
``k`` words (``gen.element_shape``); an answered row is right when it has
the shape ``(bucket,) + element_shape`` and every word equals the
reference's.

Numbers compared, each with its limit (an exact comparison has limit 0):

* ``wrong_rows``: answered rows that differ from the reference in any
  word, or have another shape than the request's bucket of elements;
* ``missing_rows``: admitted requests that were never answered.

A rejected request is no wrong answer: it counts in ``failed`` and, in an
open loop, as a latency that never ends.
"""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from ffbench import gen

LIMITS = {"wrong_rows": 0, "missing_rows": 0}
BLOCK = 1 << 15


def reference(config: dict):
    return importlib.import_module(f"ffbench.reference.{config['reference']}")


def _blocks(items, shape: tuple, device, rows: bool):
    """(coefficients, rows) blocks of one bucket, each coefficient array
    zero-padded to ``shape`` (the bucket's), as device tensors (rows None
    when not read); a block holds BLOCK rows of one-word coefficients, and
    proportionally fewer of wider ones."""
    step = BLOCK // math.prod(shape[1:])
    for lo in range(0, len(items), step):
        part = items[lo:lo + step]
        x = np.zeros((len(part),) + shape, np.int64)
        for k, (coeffs, _) in enumerate(part):
            x[k, :len(coeffs)] = coeffs
        y = (torch.from_numpy(np.stack([r for _, r in part]).astype(np.int64))
             .to(device) if rows else None)
        yield torch.from_numpy(x).to(device), y


def compare(answers, config: dict, device, *, control=None) -> int:
    """Rows of ``answers`` ((coefficients, row) pairs) that differ from the
    reference.  With ``control`` (a dtype), the rows are not read: the
    reference computed in that dtype stands in the program's place."""
    ref = reference(config)
    q = int(config["modulus"])
    element = gen.element_shape(config)
    by_bucket: dict[int, list] = {}
    wrong = 0
    for coeffs, row in answers:
        b = gen.bucket(len(coeffs))
        if control is None and (row is None
                                or np.shape(row) != (b,) + element):
            wrong += 1
            continue
        by_bucket.setdefault(b, []).append((coeffs, row))
    for b, items in sorted(by_bucket.items()):
        w = ref.twiddles(b, q, device)
        for x, y in _blocks(items, (b,) + element, device,
                            rows=control is None):
            want = ref.transform(x, q, w=w)
            if control is not None:
                y = ref.transform(x, q, w=w, dtype=control)
            wrong += int((y != want).flatten(1).any(dim=1).sum())
    return wrong


def judge(loop, config: dict, device) -> dict:
    """The numbers compared for every request ``loop`` offered (a
    :class:`ffbench.loops.Loop`), each beside its limit."""
    answers, missing = [], 0
    for i in range(len(loop)):
        if loop.rejected[i]:
            continue
        if math.isnan(loop.seen[i]):
            missing += 1
            continue
        answers.append((loop.source.get(i)[1], loop.rows[i]))
    wrong = compare(answers, config, device)
    return {"wrong_rows": {"value": wrong, "limit": LIMITS["wrong_rows"]},
            "missing_rows": {"value": missing,
                             "limit": LIMITS["missing_rows"]},
            "compared_rows": {"value": len(answers), "limit": None}}


def passed(checks: dict) -> bool:
    return (checks["compared_rows"]["value"] > 0
            and all(c["value"] <= c["limit"] for c in checks.values()
                    if c["limit"] is not None))

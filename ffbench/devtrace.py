"""What the device did in the traced window, from torch.profiler's trace.

The harness opens ``torch.profiler.record_function(WINDOW)`` around the
traced window; its host event gives the window's edges on the trace's clock,
and the host clock read just inside it gives the offset that places the
loop's own spans (sleep, submit, pump) on that clock.

* busy: the union of every device interval (kernels, copies, sets) inside
  the window; idle = window − busy;
* programs: the union of every device interval but the copies between host
  and device (CUPTI's ``Memcpy HtoD`` and ``Memcpy DtoH``).  In the server
  every other operation on the device runs inside a launch's program (a
  replayed graph: limb split, K1, K2, recombination, the copy to the static
  output), whatever kernels a later version puts there; the rows' way in
  and out is the copies;
* by name: device seconds of each operation, clipped to the window;
* idle gaps: the window's stretches with nothing on the device, each labelled
  by the loop's span open at its midpoint ("harness" between spans).
"""
from __future__ import annotations

import bisect

WINDOW = "ffbench.window"
TRANSFERS = ("Memcpy HtoD", "Memcpy DtoH")
NAME_CHARS = 96


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def profile_events(prof) -> list[tuple]:
    """``(name, on_device, is_annotation, start_us, end_us)`` of every event
    of a finished ``torch.profiler.profile``, read from its kineto results
    (no per-event Python objects are built), or from ``prof.events()`` where
    those are not exposed."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.device_type() == cuda, e.is_user_annotation(),
                 e.start_ns() / 1e3, e.end_ns() / 1e3) for e in raw]
    except AttributeError:
        return [(e.name, e.device_type == cuda,
                 getattr(e, "is_user_annotation", False),
                 e.time_range.start, e.time_range.end) for e in prof.events()]


def read_events(events, spans=None, window_ns0=None):
    """Summarise ``events`` (:func:`profile_events`' tuples) over the
    window.  ``spans``: the loop's ``(label, start_ns, end_ns)`` on the host
    clock, and ``window_ns0`` that clock's reading at the window's start.
    Times returned are in seconds."""
    win = [(s, t) for name, on_dev, _, s, t in events
           if name == WINDOW and not on_dev]
    if not win:
        raise RuntimeError(f"no {WINDOW!r} range in the trace")
    w0, w1 = win[0]
    dev = []
    for name, on_dev, annotation, s, t in events:
        if not on_dev or annotation or name.startswith("ffbench."):
            continue
        s, t = max(s, w0), min(t, w1)
        if t > s:
            dev.append((name, s, t))
    merged = _union((s, t) for _, s, t in dev)
    busy_us = sum(t - s for s, t in merged)
    program_us = sum(t - s for s, t in _union(
        (s, t) for name, s, t in dev if not name.startswith(TRANSFERS)))
    by_name: dict[str, float] = {}
    for name, s, t in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
    gaps, edge = [], w0
    for s, t in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if w1 > edge:
        gaps.append((edge, w1))
    labels: dict[str, float] = {}
    longest: dict[str, float] = {}
    starts = [s for _, s, _ in spans] if spans else []
    for g0, g1 in gaps:
        label = "harness"
        if spans and window_ns0 is not None:
            mid_ns = window_ns0 + ((g0 + g1) / 2 - w0) * 1e3
            k = bisect.bisect_right(starts, mid_ns) - 1
            if k >= 0 and spans[k][2] >= mid_ns:
                label = spans[k][0]
        labels[label] = labels.get(label, 0.0) + (g1 - g0) / 1e6
        longest[label] = max(longest.get(label, 0.0), (g1 - g0) / 1e6)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(labels.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "program_s": program_us / 1e6,
        "device_events": len(dev),
        "device_ops": [[n[:NAME_CHARS], us / 1e6] for n, us in top_ops],
        "idle_gaps": ([[label, s] for label, s in idle]
                      + [["longest:" + label, longest[label]]
                         for label, _ in idle])[:10],
        "idle_gap_count": len(gaps),
    }

"""Chrome ``trace_event`` / Perfetto rendering of a :class:`Tracer` buffer.

The tracer stores neutral event dicts (serving-clock seconds, logical
``track`` names, optional ``host`` tags).  This module maps them onto the
Chrome trace-event JSON object format — open the output file directly in
https://ui.perfetto.dev (or ``chrome://tracing``):

* each **host** becomes one Perfetto *process* (``pid = host + 1``; single-
  host traces use pid 1) named via ``process_name`` metadata;
* each logical **track** ("serve", "batcher", "device", "holdback",
  "counters", …) becomes one *thread* row inside its host process, named via
  ``thread_name`` metadata;
* timestamps convert from serving-clock seconds to integer-ish microseconds
  (the unit Perfetto expects);
* async spans keep their ``cat``/``id`` pair — Perfetto nests same-category
  overlapping spans (depth-k launch rings, concurrent requests) instead of
  corrupting a stack the way sync B/E would.

* the host spans (the ``"host"`` track, sync ``B``/``E``) are stamped on
  ``time.perf_counter``, not on the serving clock: on a wall-clock server
  that is one timeline with the rest, under a virtual clock it is their own,
  which the track's name says (``host (perf_counter)``).

Export is pure: it never mutates the tracer, so it can run mid-flight.
:func:`host_spans` reads the host spans back, each with its depth and self
time.
"""
from __future__ import annotations

import gzip
import json

# Stable thread ordering inside each host process: lifecycle first, then the
# device/dispatch tracks, cluster control (drain barrier, failover spans),
# counters and alerts, then the host spans.  Unknown tracks sort after these.
_TRACK_ORDER = ("serve", "batcher", "holdback", "device", "cluster",
                "failover", "counters", "alerts", "host")
# Thread names that differ from the track's.
_TRACK_NAMES = {"host": "host (perf_counter)"}


def open_text(path: str, mode: str = "rt"):
    """Open a text file, transparently gzipped when the path ends in .gz —
    the one place ``--trace-out`` / ``--metrics-out`` compression lives."""
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode.rstrip("t") or "r")


def write_text(path: str, text: str) -> None:
    with open_text(path, "wt") as f:
        f.write(text)


def read_text(path: str) -> str:
    with open_text(path, "rt") as f:
        return f.read()


def _tid(track: str) -> int:
    try:
        return _TRACK_ORDER.index(track) + 1
    except ValueError:
        return len(_TRACK_ORDER) + 1 + (hash(track) % 101)


def chrome_trace(events: list[dict], *,
                 label: str = "repro_torch.serve") -> dict:
    """Render tracer events as a Chrome trace-event JSON object.

    ``events`` is ``Tracer.events`` (or the concatenation of several hosts'
    buffers — each event carries its own ``host`` tag, ``None`` meaning the
    single-host/cluster-control process, which gets pid 1; host h gets
    pid h+2 so host 0 never shares a process with the control track).
    """
    out: list[dict] = []
    seen: set = set()   # (pid, tid) pairs that already have name metadata
    host_names: dict[int, str] = {}
    for ev in events:
        host = ev.get("host")
        pid = 1 if host is None else int(host) + 2
        track = ev.get("track", "serve")
        tid = _tid(track)
        if pid not in host_names:
            host_names[pid] = (label if host is None
                               else f"{label} host {host}")
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": host_names[pid]}})
            out.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                        "tid": 0, "args": {"sort_index": pid}})
        if (pid, tid) not in seen:
            seen.add((pid, tid))
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid,
                        "args": {"name": _TRACK_NAMES.get(track, track)}})
            out.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                        "tid": tid, "args": {"sort_index": tid}})
        row = {"ph": ev["ph"], "name": ev["name"], "pid": pid, "tid": tid,
               "ts": ev["ts"] * 1e6}
        if "cat" in ev:
            row["cat"] = ev["cat"]
        if "id" in ev:
            row["id"] = ev["id"]
        if ev["ph"] == "i":
            row["s"] = "t"          # thread-scoped instant marker
        if "args" in ev:
            row["args"] = ev["args"]
        out.append(row)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"label": label}}


def write_chrome_trace(path: str, events: list[dict], *,
                       label: str = "repro_torch.serve") -> dict:
    trace = chrome_trace(events, label=label)
    with open_text(path, "wt") as f:
        json.dump(trace, f)
    return trace


def host_spans(events: list[dict]) -> list[tuple]:
    """The closed host spans of ``events`` (``Tracer.event_dicts()``, one
    host's or several), in the order they close: ``(name, id, start_s,
    end_s, depth, self_s)``, where ``depth`` is 0 for a span no other host
    span encloses and ``self_s`` is its length less its children's.  A span
    left open at the end of the events, or closed with no begin (a tracer
    attached or detached inside it), is left out."""
    out = []
    stacks: dict = {}      # host -> [[name, id, start, child seconds]]
    for ev in events:
        ph = ev["ph"]
        if ev.get("track") != "host" or ph not in ("B", "E"):
            continue
        stack = stacks.setdefault(ev.get("host"), [])
        if ph == "B":
            stack.append([ev["name"], ev.get("id"), ev["ts"], 0.0])
        elif stack and stack[-1][0] == ev["name"]:
            name, id, start, child = stack.pop()
            length = ev["ts"] - start
            if stack:
                stack[-1][3] += length
            out.append((name, id, start, ev["ts"], len(stack),
                        length - child))
    return out


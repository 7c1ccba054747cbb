"""Chrome-trace schema validator — the CI contract for ``--trace-out``.

``validate_chrome_trace`` checks a trace dict (as produced by
:func:`repro_torch.obs.export.chrome_trace`, or ``json.load`` of a trace file)
against the protocol the serving stack emits:

* structural: every event row has ``ph``/``name``/``pid``/``tid``/``ts``
  with a known phase and non-negative timestamp;
* balance: every async ``b`` (cat, id, pid) has a matching ``e`` later in
  the stream; sync ``B``/``E`` pairs nest LIFO per (pid, tid), each ``E``
  naming the span it closes;
* causality: every admitted request (a ``cat="request"`` span) is closed by
  a terminal ``e`` AND chains submit → batch → launch — its rid appears in
  the ``args.rids`` roster of a closed batch span, and that batch id
  appears in a ``launch_batches`` instant naming a launch span.  Rejected
  requests appear only as ``reject`` instants and need no chain.  One
  exemption: requests abandoned by a host failure (their span ends with a
  ``failover`` event and their rid is listed in a ``failover_abandoned``
  instant) must still balance but carry no chain — the replayed request
  opens a fresh span on the surviving host, and *that* span chains.

Violations raise ``ValueError`` with the offending id; success returns a
stats dict (span/chain counts) the smoke tests assert on.

``validate_openmetrics`` plays the same role for ``--metrics-out``: it
parses the OpenMetrics text exposition (backfill flavour — repeated
timestamped samples per series) and asserts family headers, sample syntax,
per-series timestamp monotonicity, counter monotonicity, and the ``# EOF``
terminator.
"""
from __future__ import annotations

import re

_PHASES = {"B", "E", "b", "e", "i", "C", "M"}

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(\{[^}]*\})?"                          # optional labels
    r" (-?(?:[0-9.]+(?:[eE][+-]?[0-9]+)?|inf|nan))"   # value
    r"(?: (-?[0-9.]+(?:[eE][+-]?[0-9]+)?))?$")        # optional timestamp


def validate_chrome_trace(trace) -> dict:
    """Accepts the trace dict itself or a path to a trace file (plain or
    ``.gz`` — the ``--trace-out foo.json.gz`` round-trip)."""
    if isinstance(trace, (str, bytes)):
        import json

        from repro_torch.obs.export import open_text
        with open_text(trace, "rt") as f:
            trace = json.load(f)
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")

    opens: dict = {}       # (cat, id, pid) -> open-count for async spans
    spans: dict = {}       # (cat, id) -> {"b": n, "e": n} across hosts
    stacks: dict = {}      # (pid, tid) -> [names] for sync B/E nesting
    enq: dict = {}         # rid -> set of bids (from batch-close rosters)
    launch_of: dict = {}   # bid -> lid (from launch_batches instants)
    requests: set = set()
    abandoned: set = set() # rids closed by host failure (replayed elsewhere)
    rejects = 0

    for i, ev in enumerate(events):
        for field in ("ph", "name", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if ph == "M":
            continue
        if "ts" not in ev:
            raise ValueError(f"event {i} missing 'ts': {ev}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i} has bad ts {ev['ts']!r}")

        if ph in ("b", "e"):
            if "cat" not in ev or "id" not in ev:
                raise ValueError(f"async event {i} missing cat/id: {ev}")
            key = (ev["cat"], ev["id"], ev["pid"])
            rec = spans.setdefault((ev["cat"], ev["id"]), {"b": 0, "e": 0})
            if ph == "b":
                opens[key] = opens.get(key, 0) + 1
                rec["b"] += 1
                if ev["cat"] == "request":
                    requests.add(ev["id"])
            else:
                if opens.get(key, 0) < 1:
                    raise ValueError(
                        f"event {i}: 'e' without open 'b' for {key}")
                opens[key] -= 1
                rec["e"] += 1
                if ev["cat"] == "batch":
                    # the close event carries the batch's request roster —
                    # the submit → batch half of the causal chain
                    for rid in ev.get("args", {}).get("rids", ()):
                        enq.setdefault(rid, set()).add(ev["id"])
        elif ph == "B":
            stacks.setdefault((ev["pid"], ev["tid"]), []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get((ev["pid"], ev["tid"]), [])
            if not stack:
                raise ValueError(f"event {i}: 'E' on empty stack "
                                 f"(pid={ev['pid']}, tid={ev['tid']})")
            top = stack.pop()
            if ev["name"] != top:
                raise ValueError(f"event {i}: 'E' of {ev['name']!r} closes "
                                 f"{top!r} (sync spans must nest LIFO)")
        elif ph == "i":
            args = ev.get("args", {})
            if ev["name"] == "launch_batches":
                for bid in args["bids"]:
                    launch_of[bid] = args["lid"]
            elif ev["name"] == "reject":
                rejects += 1
            elif ev["name"] == "failover_abandoned":
                abandoned.update(args.get("rids", ()))
        elif ph == "C":
            if "value" not in ev.get("args", {}):
                raise ValueError(f"counter event {i} missing args.value")

    unbalanced = [k for k, n in opens.items() if n != 0]
    if unbalanced:
        raise ValueError(f"unbalanced async spans (open 'b' without 'e'): "
                         f"{sorted(unbalanced)[:5]}")
    dangling = [(pt, s) for pt, s in stacks.items() if s]
    if dangling:
        raise ValueError(f"unclosed sync spans: {dangling[:5]}")

    # Causal chain: every admitted request reaches a terminal complete via
    # a batch-roster → launch link.
    for rid in sorted(requests):
        rec = spans[("request", rid)]
        if rec["e"] < rec["b"]:
            raise ValueError(f"request {rid} never completed")
        if rid in abandoned:
            continue       # chain continues on the survivor's replay span
        bids = enq.get(rid)
        if not bids:
            raise ValueError(f"request {rid} has no enqueue link to a batch "
                             f"(no closed batch span lists it in args.rids)")
        for bid in bids:
            brec = spans.get(("batch", bid))
            if brec is None or brec["e"] < brec["b"]:
                raise ValueError(f"request {rid}: batch {bid} span "
                                 f"missing or unclosed")
            lid = launch_of.get(bid)
            if lid is None:
                raise ValueError(f"request {rid}: batch {bid} never "
                                 f"reached a launch")
            lrec = spans.get(("launch", lid))
            if lrec is None or lrec["e"] < lrec["b"]:
                raise ValueError(f"request {rid}: launch {lid} span "
                                 f"missing or unclosed")

    n_cat = lambda c: sum(1 for (cat, _), r in spans.items()
                          if cat == c and r["b"] > 0)
    return {
        "events": len(events),
        "requests": len(requests),
        "rejects": rejects,
        "batches": n_cat("batch"),
        "launches": n_cat("launch"),
    }


def validate_openmetrics(text: str) -> dict:
    """Validate an OpenMetrics exposition (see module docstring); pass a
    path (plain or ``.gz``) instead of text to validate a ``--metrics-out``
    file from disk.  Returns ``{"families", "series", "samples"}``."""
    if "\n" not in text and (text.endswith(".gz") or text.endswith(".om")
                             or text.endswith(".txt")
                             or not text.lstrip().startswith("#")):
        from repro_torch.obs.export import read_text
        text = read_text(text)
    lines = text.splitlines()
    if not lines or lines[-1] != "# EOF":
        raise ValueError("exposition must terminate with '# EOF'")
    kinds: dict[str, str] = {}
    last_ts: dict[tuple, float] = {}
    last_val: dict[tuple, float] = {}
    samples = 0
    for i, line in enumerate(lines[:-1]):
        if not line:
            raise ValueError(f"line {i}: empty line inside exposition")
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {i}: bad comment line {line!r}")
            if parts[1] == "TYPE":
                name, kind = parts[2], parts[3] if len(parts) > 3 else ""
                if kind not in ("counter", "gauge", "histogram", "summary",
                                "unknown"):
                    raise ValueError(f"line {i}: unknown TYPE {kind!r}")
                if name in kinds:
                    raise ValueError(f"line {i}: duplicate TYPE for {name}")
                kinds[name] = kind
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i}: unparseable sample {line!r}")
        name, labels, value, ts = m.groups()
        if name not in kinds:
            raise ValueError(f"line {i}: sample for {name} precedes its "
                             f"'# TYPE' header")
        samples += 1
        key = (name, labels or "")
        if ts is not None:
            t = float(ts)
            if key in last_ts and t <= last_ts[key]:
                raise ValueError(f"line {i}: non-increasing timestamp for "
                                 f"{key}: {t} after {last_ts[key]}")
            last_ts[key] = t
        v = float(value)
        if kinds[name] == "counter":
            if key in last_val and v < last_val[key]:
                raise ValueError(f"line {i}: counter {key} decreased "
                                 f"({last_val[key]} -> {v})")
            last_val[key] = v
    return {"families": len(kinds),
            "series": len(set(last_ts) | set(last_val)),
            "samples": samples}

"""Post-hoc structural validator of the port's programs (paper §6.3).

The JAX package reads XLA's lowered and compiled module and asserts the
separation invariants on it.  The port's programs are CUDA graphs, so on
the card :func:`validate_fn` captures the function once with the graph kept
(:class:`repro_torch.core.scheduler.program.GraphProbe`) and reads its
nodes and dependency edges (``csrc/graph_census.cu``); the launch log of the
same capture (:func:`repro_torch.core.zones.launch_log`) tags each K1/K2/K3
node with the scope path of its call, as ``op_name`` tags an HLO op.
:func:`validate_probe` checks a probe made by the caller, which can then
replay the graph it validated.  On the CPU (the tests) the function runs
eagerly under the log, and the log in call order, one full edge from each
record to the next, is the program; a CPU run that writes on the card is
refused, since its call order is not the card's completion order.

  match: on the card the K1/K2/K3 nodes in topological order must equal the
      log's records one for one (kernel, static arguments and operand
      addresses); a node the log lacks or a record with no node fails, and
      nothing else is checked before they agree.
  V1 (Invariant 5.1, strict reduction ordering): for each channel of an
      eager program the K1/K2 nodes run (K1^g K2) per staging pass: every
      pass's GEMMs, then its fold, which depends on them, before the next
      pass's GEMMs.  Nodes under ``vpu_montgomery`` and kernels that are
      not K1/K2 (PyTorch's ``addmod``, the ``rns_redc`` reduction) are no summation
      window, as the JAX V1 skips the Montgomery matmuls.
  V2 (barrier survival): each pass's first GEMM is reachable from the
      previous pass's fold through full edges.  A programmatic edge orders
      only K2, which executes ``griddepcontrol.wait`` before it reads
      (``csrc/mont_fold.cu``); a programmatic edge into any other node
      fails.  ``n_barriers`` counts the fold → next-GEMM paths found.
  V3 / V4 (zone separation): every K node carries exactly one ``wzone_*``
      and one ``pzone_*``, and no K node reads bytes that a K node of
      another workload (V3) or precision (V4) zone wrote in the program.
      The port has no fusing compiler; this is its "no computation mixes
      zones".
  V5 (disjoint addressing): buffer donation in a multi-zone program fails,
      as in the JAX package; :func:`disjoint_programs` checks that the
      co-scheduler's programs of distinct workloads share no static buffer.
  V6 (κ-window fold survival, lazy programs): exactly ``expected_windows``
      ``lazy_window_*`` scopes (qualified by channel) carry a fold, and no
      fold is tagged ``staging_pass_*/vpu_fold`` (an eager per-pass fold).
  V7 (single fold per window, lazy programs): each window holds exactly one
      K2, whose ``n_diag`` equals ``n_diag``.

Any violation raises :class:`ValidationError` through
:meth:`ValidationReport.raise_if_failed`.  ``n_dots``/``n_folds`` are the K1
and K2 node counts, which the callers hold against the engine's fold
profile (:func:`repro_torch.core.scheduler.coscheduler.check_launch_census`).
"""
from __future__ import annotations

import bisect
import dataclasses
import difflib
import math
import re

import torch

from repro_torch.core import zones
from repro_torch.core.scheduler.program import GraphProbe
from repro_torch.kernels.graph_census import Node

WZONE_RE = re.compile(r"wzone_[A-Za-z0-9_]+")
PZONE_RE = re.compile(r"pzone_[A-Za-z0-9_]+")
PASS_RE = re.compile(r"staging_pass_(\d+)")
CHANNEL_RE = re.compile(r"channel_\d+")
# Window key carries the channel qualifier so BN254's per-channel windows
# with the same index stay distinct.
LAZY_WIN_RE = re.compile(r"(?:channel_\d+/)?lazy_window_\d+(?=/vpu_fold_lazy)")
EAGER_FOLD_RE = re.compile(r"staging_pass_\d+/vpu_fold(?!_lazy)")

K1, K2, K3 = "limb_matmul", "mont_fold", "fused_ntt_tile"


class ValidationError(AssertionError):
    def __init__(self, violations):
        self.violations = violations
        super().__init__("structural validation failed:\n" +
                         "\n".join(f"  [{v[0]}] {v[1]}" for v in violations))


@dataclasses.dataclass
class ValidationReport:
    ok: bool
    violations: list
    n_barriers: int
    n_dots: int
    n_folds: int
    zones: set
    precision_zones: set
    # the graph reader's census on the card (node and edge counts, the
    # reader's seconds); None on the CPU
    graph: dict | None = None

    def add(self, violations: list):
        """Add violations found outside the program (e.g. V5 across
        programs)."""
        self.violations.extend(violations)
        self.ok = not self.violations

    def raise_if_failed(self):
        if not self.ok:
            raise ValidationError(self.violations)


def _signature(kernel: str, args: dict, ptrs: tuple) -> tuple:
    return (kernel, tuple(sorted(args.items())), tuple(ptrs))


def record_nodes(records) -> tuple[list, list]:
    """The CPU's program: one node per record, in call order, each with one
    full edge to the next (an eager run completes every call before the
    next starts)."""
    nodes = [Node(r.kernel, r.args,
                  tuple(a for a, _ in r.reads + r.writes)) for r in records]
    edges = [(i, i + 1, False) for i in range(len(nodes) - 1)]
    return nodes, edges


def match(records, nodes) -> list:
    """Violations of the one-for-one match of the K1/K2/K3 nodes (in
    topological order) with the launch log's records."""
    want = [_signature(r.kernel, r.args,
                       tuple(a for a, _ in r.reads + r.writes))
            for r in records]
    got = [_signature(n.kernel, n.args, n.ptrs) for n in nodes
           if n.kernel is not None]
    violations = []
    sm = difflib.SequenceMatcher(a=want, b=got, autojunk=False)
    for op, i0, i1, j0, j1 in sm.get_opcodes():
        if op in ("delete", "replace"):
            for r in want[i0:i1]:
                violations.append(("match", f"launch record {r[0]} "
                                   f"{dict(r[1])} has no node in the graph"))
        if op in ("insert", "replace"):
            for g in got[j0:j1]:
                violations.append(("match", f"graph node {g[0]} "
                                   f"{dict(g[1])} has no launch record"))
    return violations


def _ancestors(nodes, edges, bits: dict, ordering: bool) -> list:
    """For each node, the K nodes it is reachable from, as a bit set over
    ``bits`` (node index -> bit).  With ``ordering``, only edges that order
    their destination count: full edges, and programmatic edges into K2."""
    preds = [[] for _ in nodes]
    for s, d, programmatic in edges:
        if s >= d:
            raise ValueError(f"edge {s} -> {d} is not in topological order")
        if ordering and programmatic and nodes[d].kernel != K2:
            continue
        preds[d].append(s)
    anc = [0] * len(nodes)
    for v, ps in enumerate(preds):
        a = 0
        for u in ps:
            a |= anc[u] | bits.get(u, 0)
        anc[v] = a
    return anc


def _overlaps(a: tuple, b: tuple) -> bool:
    return a[0] < b[0] + b[1] and b[0] < a[0] + a[1]


class _Writers:
    """The byte ranges the K nodes wrote so far, sorted by address: the
    latest writer of a read range is found among the few ranges that start
    within the longest range's length of it, not by a walk over every
    range (a BN254 program at d = 8192 has ~10,000 K nodes)."""

    def __init__(self):
        self._ranges: list = []     # (address, bytes, node index), sorted
        self._longest = 0

    def add(self, rng: tuple, node: int):
        bisect.insort(self._ranges, (rng[0], rng[1], node))
        self._longest = max(self._longest, rng[1])

    def latest(self, rng: tuple) -> int | None:
        """The highest node index whose write overlaps ``rng``, or None."""
        lo = bisect.bisect_right(self._ranges, (rng[0] - self._longest,
                                                math.inf, math.inf))
        hi = bisect.bisect_left(self._ranges, (rng[0] + rng[1],))
        hits = [j for a, n, j in self._ranges[lo:hi]
                if _overlaps(rng, (a, n))]
        return max(hits) if hits else None


def check(records, nodes, edges, *, scopes=(),
          expected_passes: int | None = None, expect_eager: bool = True,
          expected_windows: int | None = None, n_diag: int | None = None,
          donate_argnums=(),
          graph: dict | None = None) -> tuple[ValidationReport, list]:
    """Check a program given as its launch log (``records``, and the names
    of the scopes its run opened, ``scopes``) and its nodes and edges (in
    topological order).  ``zones``/``precision_zones`` are every zone the
    run opened, as the JAX package's are every zone in the module.  Returns
    the report and the scope path of every K node (empty when the match
    fails)."""
    kidx = [i for i, n in enumerate(nodes) if n.kernel is not None]
    n_dots = sum(nodes[i].kernel == K1 for i in kidx)
    n_folds = sum(nodes[i].kernel == K2 for i in kidx)
    violations = match(records, nodes)
    if graph and graph.get("matched_by", {}).get("unreadable"):
        violations.append(("match", f"{graph['matched_by']['unreadable']} "
                           "kernel nodes whose parameters the graph reader "
                           "could not read"))
    if violations:
        return ValidationReport(False, violations, 0, n_dots, n_folds, set(),
                                set(), graph), []
    paths = {i: r.path for i, r in zip(kidx, records)}
    rec_of = dict(zip(kidx, records))
    bits = {i: 1 << b for b, i in enumerate(kidx)}
    reach = _ancestors(nodes, edges, bits, ordering=False)
    ordered = _ancestors(nodes, edges, bits, ordering=True)

    # --- V2: a programmatic edge orders only K2 -------------------------------
    for s, d, programmatic in edges:
        if programmatic and nodes[d].kernel != K2:
            what = nodes[d].kernel or nodes[d].args.get("type", "node")
            violations.append((
                "V2", f"programmatic edge {s} -> {d} into {what}, which "
                f"executes no griddepcontrol.wait: it may start before "
                f"node {s} completes"))

    # --- V1/V2: per channel, (K1^g K2) per staging pass -----------------------
    channels: dict = {}
    for i in kidx:
        p = paths[i]
        if nodes[i].kernel in (K1, K2) and "vpu_montgomery" not in p:
            key = (tuple(WZONE_RE.findall(p)), tuple(CHANNEL_RE.findall(p)))
            channels.setdefault(key, []).append(i)
    n_barriers = 0
    for key, seq in channels.items():
        name = "/".join(key[0] + key[1]) or "program"
        groups, cur = [], []
        for i in seq:
            if nodes[i].kernel == K1:
                if (expect_eager and cur
                        and PASS_RE.findall(paths[i]) != PASS_RE.findall(
                            paths[cur[-1]])):
                    violations.append((
                        "V1", f"{name}: no fold between summation windows "
                        f"{_pass(paths[cur[-1]])}→{_pass(paths[i])} (GEMM "
                        f"nodes {cur[-1]}, {i}: open-summation fold "
                        f"violation)"))
                cur.append(i)
                continue
            if cur:
                groups.append((cur, i))
            elif expect_eager:
                violations.append((
                    "V1", f"{name}: fold node {i} ({_pass(paths[i])}) closes "
                    f"no summation window"))
            cur = []
        if cur and expect_eager:
            violations.append((
                "V1", f"{name}: summation window {_pass(paths[cur[0]])} is "
                f"never folded"))
        for (k1s, k2), nxt in zip(groups, groups[1:] + [None]):
            if expect_eager:
                late = [i for i in k1s if not reach[k2] & bits[i]]
                if late:
                    violations.append((
                        "V1", f"{name}: fold node {k2} does not depend on "
                        f"GEMM nodes {late} of its pass"))
                if PASS_RE.findall(paths[k2]) != PASS_RE.findall(
                        paths[k1s[0]]):
                    violations.append((
                        "V1", f"{name}: fold node {k2} ({_pass(paths[k2])}) "
                        f"folds pass {_pass(paths[k1s[0]])}"))
            if nxt is None:
                continue
            if ordered[nxt[0][0]] & bits[k2]:
                n_barriers += 1
            elif expect_eager:
                violations.append((
                    "V2", f"{name}: GEMM node {nxt[0][0]} "
                    f"({_pass(paths[nxt[0][0]])}) is not ordered after fold "
                    f"node {k2} by a path of full edges"))
        if expect_eager and len({len(k1s) for k1s, _ in groups}) > 1:
            violations.append((
                "V1", f"{name}: passes with "
                f"{sorted({len(k1s) for k1s, _ in groups})} GEMMs"))
    if expect_eager and expected_passes and expected_passes > 1:
        want = expected_passes - 1
        if n_barriers < want:
            violations.append((
                "V2", f"{n_barriers} fold → next-pass paths for "
                f"{expected_passes} staging passes (need >= {want})"))

    # --- V3/V4: one zone per K node, no cross-zone reads -----------------------
    zones_seen = {z for z in scopes if WZONE_RE.fullmatch(z)}
    pzones_seen = {z for z in scopes if PZONE_RE.fullmatch(z)}
    writers = _Writers()
    for i in kidx:
        wz = WZONE_RE.findall(paths[i])
        pz = PZONE_RE.findall(paths[i])
        zones_seen |= set(wz)
        pzones_seen |= set(pz)
        if len(wz) != 1:
            violations.append(("V3", f"{nodes[i].kernel} node {i} carries "
                               f"workload zones {wz}: {paths[i]!r}"))
        if len(pz) != 1:
            violations.append(("V4", f"{nodes[i].kernel} node {i} carries "
                               f"precision zones {pz}: {paths[i]!r}"))
        for rng in rec_of[i].reads:
            j = writers.latest(rng)
            if j is None:
                continue
            src = paths[j]
            if WZONE_RE.findall(src) != wz:
                violations.append((
                    "V3", f"{nodes[i].kernel} node {i} ({wz}) reads what "
                    f"{nodes[j].kernel} node {j} "
                    f"({WZONE_RE.findall(src)}) wrote"))
            if PZONE_RE.findall(src) != pz:
                violations.append((
                    "V4", f"{nodes[i].kernel} node {i} ({pz}) reads what "
                    f"{nodes[j].kernel} node {j} "
                    f"({PZONE_RE.findall(src)}) wrote"))
        for w in rec_of[i].writes:
            writers.add(w, i)

    # --- V5: no donation in a multi-zone program -------------------------------
    if donate_argnums and len(zones_seen) > 1:
        violations.append((
            "V5", f"buffer donation (arguments {tuple(donate_argnums)}) in a "
            f"program of zones {sorted(zones_seen)}"))

    # --- V6/V7: κ-window folds of a lazy program -------------------------------
    if expected_windows is not None:
        folds = [i for i in kidx if nodes[i].kernel == K2]
        per_window: dict = {}
        for i in folds:
            m = LAZY_WIN_RE.search(paths[i])
            if m:
                per_window.setdefault(m.group(0), []).append(i)
        if len(per_window) != expected_windows:
            violations.append((
                "V6", f"{len(per_window)} deferred-fold windows in the "
                f"program, expected {expected_windows} (windows seen: "
                f"{sorted(per_window)[:8]})"))
        eager = sorted({m.group(0) for i in folds
                        if (m := EAGER_FOLD_RE.search(paths[i]))})
        if eager:
            violations.append((
                "V6", f"lazy program contains eager per-pass folds "
                f"{eager[:4]}: the deferred schedule was folded per pass"))
        if n_diag is not None:
            for win, members in sorted(per_window.items()):
                diags = [nodes[i].args["n_diag"] for i in members]
                if diags != [n_diag]:
                    violations.append((
                        "V7", f"window {win} carries {len(members)} folds of "
                        f"n_diag {diags} (expected exactly one fold of "
                        f"n_diag {n_diag})"))

    report = ValidationReport(
        ok=not violations, violations=violations, n_barriers=n_barriers,
        n_dots=n_dots, n_folds=n_folds, zones=zones_seen,
        precision_zones=pzones_seen, graph=graph)
    return report, [paths[i] for i in kidx]


def _pass(path: str) -> str:
    m = re.search(r"staging_pass_\d+", path)
    return m.group(0) if m else "?"


def _device(args) -> torch.device:
    """The device of the first tensor among ``args`` (lists and tuples
    searched), the CPU when there is none."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (list, tuple)):
            dev = _device(a)
            if dev.type != "cpu":
                return dev
    return torch.device("cpu")


def _check_probe(probe: GraphProbe, checks: dict) -> tuple:
    graph = dict(probe.census.stats, read_s=probe.read_s)
    return check(probe.log.records, probe.census.nodes, probe.census.edges,
                 scopes=probe.log.scopes, graph=graph, **checks)


def _run(fn, args, checks: dict) -> tuple[ValidationReport, list]:
    device = _device(args)
    if device.type == "cuda":
        return _check_probe(GraphProbe(lambda: fn(*args), device), checks)
    with zones.launch_log() as log:
        fn(*args)
    off_cpu = log.devices - {"cpu"}
    if off_cpu:
        raise ValueError(
            f"the function wrote on {sorted(off_cpu)} though its first "
            f"tensor argument is not there: its eager call order is not "
            f"the device's completion order, so it is validated only as a "
            f"captured graph; pass a tensor on that device first")
    nodes, edges = record_nodes(log.records)
    return check(log.records, nodes, edges, scopes=log.scopes, **checks)


def checks_for(eng, reduction: str) -> dict:
    """The checks a program of ``eng`` under ``reduction`` is held to, as
    the JAX package's callers pass them: eager, V1/V2 over its staging
    passes; lazy, V6/V7 over its κ-windows (per-pass V1/V2 do not apply to
    a κ-amortised program)."""
    if reduction == "eager":
        return {"expected_passes": eng.n_passes}
    return {"expect_eager": False,
            "expected_windows": eng.fold_profile["n_folds"],
            "n_diag": eng.n_diag}


def validate_fn(fn, *args, expected_passes: int | None = None,
                expect_eager: bool = True, expected_windows: int | None = None,
                n_diag: int | None = None,
                donate_argnums=()) -> ValidationReport:
    """Run ``fn(*args)`` under the launch log and validate it: on CUDA (the
    device of the first tensor argument) as a captured graph read node by
    node, on the CPU eagerly (where a write on the card raises ValueError).

    ``expected_windows``/``n_diag`` arm the lazy-mode V6/V7 checks (pass
    ``expect_eager=False`` alongside: a κ-amortised program defers folds
    out of the per-pass schedule V1/V2 police)."""
    return _run(fn, args, dict(
        expected_passes=expected_passes, expect_eager=expect_eager,
        expected_windows=expected_windows, n_diag=n_diag,
        donate_argnums=donate_argnums))[0]


def validate_probe(probe: GraphProbe, *, expected_passes: int | None = None,
                   expect_eager: bool = True,
                   expected_windows: int | None = None,
                   n_diag: int | None = None,
                   donate_argnums=()) -> ValidationReport:
    """Validate a :class:`~repro_torch.core.scheduler.program.GraphProbe`
    from its launch log and its graph, as :func:`validate_fn` validates the
    probe it makes on CUDA; the caller keeps the probe and can replay the
    graph that was validated."""
    return _check_probe(probe, dict(
        expected_passes=expected_passes, expect_eager=expect_eager,
        expected_windows=expected_windows, n_diag=n_diag,
        donate_argnums=donate_argnums))[0]


def fold_census(fn, *args) -> dict:
    """Static fold census for the κ analysis (paper §7.2.1): distinct fold
    sites, one per staging pass under the eager discipline, one per window
    under the lazy one."""
    rep, paths = _run(fn, args, dict(expect_eager=False))
    folds = [p for p in paths if "vpu_fold" in p]
    pass_folds = {t for p in folds
                  for t in re.findall(r"staging_pass_(\d+)/vpu_fold", p)}
    lazy_windows = {m.group(0) for p in folds if (m := LAZY_WIN_RE.search(p))}
    n_lazy = len(lazy_windows) or (
        1 if any("vpu_fold_lazy" in p for p in folds) else 0)
    return {"n_dots": rep.n_dots,
            "n_fold_scopes": len(pass_folds) + n_lazy,
            "n_lazy_windows": len(lazy_windows),
            "n_fold_tagged_ops": len(folds), "n_barriers": rep.n_barriers}


def _buffers(prog):
    yield "static_in", prog.static_in
    yield "static_out", prog.static_out
    for ci, pair in enumerate(prog.planes):
        for name, t in zip(("w_planes", "fused"), pair):
            if t is not None:
                yield f"planes[{ci}].{name}", t


def disjoint_programs(programs) -> list:
    """V5 across programs: ``programs`` are ``(workload, E2EProgram)``
    pairs; no static input, static output or twiddle plane of one workload
    may share bytes with one of another workload.  Returns the
    violations."""
    spans = []
    for workload, prog in programs:
        for what, t in _buffers(prog):
            if t.numel():
                spans.append((zones._extent(t), str(t.device), workload,
                              f"{workload} {tuple(prog.shape)} {what}"))
    violations = []
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            if a[1] == b[1] and a[2] != b[2] and _overlaps(a[0], b[0]):
                violations.append(("V5", f"{a[3]} and {b[3]} share device "
                                   f"bytes"))
    return violations

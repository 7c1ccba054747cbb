"""Live penalty ledger: per-launch modeled-cycle attribution (paper §7).

The paper decomposes the TPU finite-field deficit into an **arithmetic
penalty** (Montgomery folds run on the VPU while the MXU stalls, §7.2) and a
**spatial penalty** (M/K under-fill of the 128×128 systolic array, §7.3 —
the 6.25% M-occupancy collapse).  This module turns that decomposition into
a live, per-snapshot quantity: every launch is priced in
modeled device cycles and split into four exhaustive, mutually exclusive
bins

* ``mxu_productive``   — MXU cycles doing live tenant work (live-row share
  of the limb-GEMM MACs, discounted by achieved K occupancy);
* ``arithmetic_stall`` — VPU fold cycles attributable to live rows (the
  §7.2 reduction-stall tax; scales with ``n_folds``, so κ-deferred classes
  show it shrink);
* ``spatial_pad``      — MXU cycles burned on M-tile rounding, ladder-pad
  rows and K under-fill, plus the VPU fold share spent on dead rows (§7.3);
* ``host_gap``         — measured service time beyond the modeled device
  cycles: dispatch, gather, transfers, compile-cache misses.

**Conservation is the contract**: the four cycle bins are an exact partition
of ``total_cycles`` by construction, so their shares sum to 1.0 (±1e-9 float
noise) per workload — tested in tests/test_obs.py and re-established after
the exact cross-host merge in :func:`merge_penalty_sections`.

The cycle model is the paper's modelled TPU v4 (the constants below are the
v4-class geometry of its roofline), kept bit for bit from the JAX package so
that a ``deterministic_timing`` run of the port equals the JAX server's.  Its
cycles and ``device_s`` are that model's, never the CUDA card's time: on the
card, the measured service time is what the server reports unless
``deterministic_timing`` substitutes this model.  One launch of height R
(``launched_rows``, rounded up to ``m_slots`` whole M tiles) over degree d
with C channels costs

* MXU: ``m_slots · d² · data_limbs · tw_limbs · C / MXU_MACS_PER_CYCLE``
  limb-plane GEMM MACs (the d² contraction is pass-tiled but its MAC count
  is tile-invariant);
* VPU: ``n_folds · R · d · n_diag · VPU_OPS_PER_DIAG / VPU_LANES`` fold
  lane-ops (``n_folds`` already counts every channel's windows).
"""
from __future__ import annotations

MXU_MACS_PER_CYCLE = 128 * 128        # one v4-class 128×128 systolic pass
VPU_LANES = 8 * 128                   # (8, 128) vector registers
VPU_OPS_PER_DIAG = 4.0                # mul+add+shift+select per diagonal fold
DEVICE_HZ = 940e6                     # v4 clock used by the paper's roofline

SHARE_KEYS = ("mxu_productive", "arithmetic_stall", "spatial_pad", "host_gap")


def _shares(cycles: dict) -> dict:
    total = cycles["total"]
    if total <= 0.0:
        return {k: 0.0 for k in SHARE_KEYS}
    return {k: cycles[k] / total for k in SHARE_KEYS}


def launch_cycles(*, d: int, live_rows: int, launched_rows: int,
                  profile: dict, m_tile: int = 128,
                  k_occupancy: float = 1.0) -> dict:
    """Price one launch in modeled device cycles (the ledger's cycle model,
    factored out so callers can use it without a ledger — notably
    ``ServeConfig.deterministic_timing``, which substitutes
    ``(mxu + vpu) / DEVICE_HZ`` for the wall-clock service measurement to
    make the whole serving loop bit-reproducible).

    Returns ``{"mxu", "vpu", "mxu_productive", "arithmetic_stall",
    "spatial_pad", "device_s"}`` — device bins only; ``host_gap`` needs a
    measured service time and stays the ledger's business.
    """
    m_tile = max(1, int(m_tile))
    launched = max(1, int(launched_rows))
    live = min(int(live_rows), launched)
    m_slots = -(-launched // m_tile) * m_tile
    k_occ = min(max(float(k_occupancy), 0.0), 1.0)

    macs = (m_slots * float(d) * float(d) * profile["data_limbs"]
            * profile["tw_limbs"] * profile["n_channels"])
    mxu = macs / MXU_MACS_PER_CYCLE
    lane_ops = (profile["n_folds"] * launched * float(d)
                * profile["n_diag"] * VPU_OPS_PER_DIAG)
    vpu = lane_ops / VPU_LANES

    live_m = live / m_slots
    live_r = live / launched
    mxu_productive = mxu * live_m * k_occ
    arithmetic_stall = vpu * live_r
    spatial_pad = (mxu - mxu_productive) + vpu * (1.0 - live_r)
    return {"mxu": mxu, "vpu": vpu,
            "mxu_productive": mxu_productive,
            "arithmetic_stall": arithmetic_stall,
            "spatial_pad": spatial_pad,
            "device_s": (mxu + vpu) / DEVICE_HZ}


class PenaltyLedger:
    """Accumulates per-launch cycle attributions, keyed by workload."""

    def __init__(self, m_tile: int = 128):
        # M granule: the paper's N_c^max occupancy denominator — a launch
        # occupies whole 128-row systolic M slots regardless of the ladder
        # rung it launched at, so 8 live rows in one slot read as the 6.25%
        # collapse (§7.3).
        self.m_tile = max(1, int(m_tile))
        self._w: dict[str, dict] = {}

    def observe_launch(self, *, workload: str, d: int, live_rows: int,
                       launched_rows: int, n_batches: int, service_s: float,
                       profile: dict, k_occupancy: float = 1.0):
        """Price one launch group.

        ``profile`` is the engine's fold profile augmented with limb counts
        (``n_folds``, ``n_diag``, ``n_channels``, ``data_limbs``,
        ``tw_limbs``, ``reduction``); ``k_occupancy`` is the mean achieved K
        fill of the batches in this launch (K under-fill is spatial).
        """
        launched = max(1, int(launched_rows))
        live = min(int(live_rows), launched)
        cyc = launch_cycles(d=d, live_rows=live, launched_rows=launched,
                            profile=profile, m_tile=self.m_tile,
                            k_occupancy=k_occupancy)
        mxu_productive = cyc["mxu_productive"]
        arithmetic_stall = cyc["arithmetic_stall"]
        spatial_pad = cyc["spatial_pad"]
        measured = max(0.0, float(service_s)) * DEVICE_HZ
        host_gap = max(0.0, measured - (cyc["mxu"] + cyc["vpu"]))

        w = self._w.setdefault(workload, {
            "launches": 0, "batches": 0, "live_rows": 0, "launched_rows": 0,
            "reduction_modes": {},
            "cycles": {k: 0.0 for k in SHARE_KEYS}})
        w["launches"] += 1
        w["batches"] += int(n_batches)
        w["live_rows"] += live
        w["launched_rows"] += launched
        mode = profile.get("reduction", "eager")
        w["reduction_modes"][mode] = w["reduction_modes"].get(mode, 0) + 1
        c = w["cycles"]
        c["mxu_productive"] += mxu_productive
        c["arithmetic_stall"] += arithmetic_stall
        c["spatial_pad"] += spatial_pad
        c["host_gap"] += host_gap

    def observe_host_gap(self, workload: str, gap_s: float):
        """Attribute measured non-device seconds straight into the
        ``host_gap`` bin of ``workload`` — no launch involved.  The
        failover path uses this to price a failure transient (the gossip
        detection window during which a dead host's intake sat unserved)
        onto the recovery coordinator's ledger, under a ``failover:hN``
        pseudo-workload.  Conservation holds trivially: the bin *is* the
        workload's whole cycle total."""
        w = self._w.setdefault(workload, {
            "launches": 0, "batches": 0, "live_rows": 0, "launched_rows": 0,
            "reduction_modes": {},
            "cycles": {k: 0.0 for k in SHARE_KEYS}})
        w["cycles"]["host_gap"] += max(0.0, float(gap_s)) * DEVICE_HZ

    def snapshot(self) -> dict:
        """Per-workload cycle bins + shares (the ``penalty`` section)."""
        out = {}
        for name, w in self._w.items():
            cycles = dict(w["cycles"])
            cycles["total"] = sum(cycles[k] for k in SHARE_KEYS)
            out[name] = {
                "launches": w["launches"],
                "batches": w["batches"],
                "live_rows": w["live_rows"],
                "launched_rows": w["launched_rows"],
                "reduction_modes": dict(w["reduction_modes"]),
                "cycles": cycles,
                "shares": _shares(cycles),
            }
        return out


def merge_penalty_sections(sections) -> dict:
    """Exact cross-host merge of ``penalty`` snapshot sections: raw cycle
    bins and row counts add, shares are recomputed from the merged bins (so
    conservation survives the merge exactly).  Hosts missing the section or
    a workload simply contribute nothing."""
    acc: dict[str, dict] = {}
    for sec in sections:
        if not sec:
            continue
        for name, w in sec.items():
            a = acc.setdefault(name, {
                "launches": 0, "batches": 0, "live_rows": 0,
                "launched_rows": 0, "reduction_modes": {},
                "cycles": {k: 0.0 for k in SHARE_KEYS}})
            for k in ("launches", "batches", "live_rows", "launched_rows"):
                a[k] += w.get(k, 0)
            for mode, n in w.get("reduction_modes", {}).items():
                a["reduction_modes"][mode] = (
                    a["reduction_modes"].get(mode, 0) + n)
            for k in SHARE_KEYS:
                a["cycles"][k] += w.get("cycles", {}).get(k, 0.0)
    out = {}
    for name, a in acc.items():
        cycles = dict(a["cycles"])
        cycles["total"] = sum(cycles[k] for k in SHARE_KEYS)
        out[name] = {**{k: a[k] for k in ("launches", "batches", "live_rows",
                                          "launched_rows")},
                     "reduction_modes": a["reduction_modes"],
                     "cycles": cycles, "shares": _shares(cycles)}
    return out

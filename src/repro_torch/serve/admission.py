"""SLO-aware admission control and per-tenant rate limiting.

Online serving must bound *queueing*, not just throughput: once the offered
load exceeds the slice's service rate, every admitted request inflates the
tail latency of all tenants (the paper's §7.4 regime where TPU BN254
throughput is 3 orders below GPU baselines — overload is the common case,
not the exception).  The controller rejects early with a machine-readable
reason and a retry-after hint so clients can back off instead of timing out.

Two state layouts implement one policy:

* **scalar** (``columnar=False``) — one :class:`TokenBucket` object per
  tenant in a dict, one Python decision per request.  This is the oracle:
  small, obviously correct, and what the property suite checks the fast
  path against.
* **columnar** (``columnar=True``, the default) — all tenant state lives in
  one numpy structured array (token level, last-refill instant, per-tenant
  rate/burst) keyed by a dense tenant index from :class:`TenantInterner`.
  :meth:`AdmissionController.admit_batch` then vectorises the queue-bound /
  SLO pricing and the token-bucket refill+charge over a whole arrival
  batch; steady state does zero per-request dict or object allocation.

The two paths are *bit-identical*: every float op in the vector path is
arranged exactly as the scalar path computes it (python floats are IEEE
doubles, as are numpy float64 lanes), so decisions, reasons, retry hints,
and bucket levels match exactly — not approximately — on any trace.  The
one sequential coupling, "the queue/SLO gate sees the count admitted so far
this batch", is resolved by a gate-threshold argument: within one batch the
gates only depend on ``pending + admitted_so_far``, which is non-decreasing,
so once the gate rejects it rejects every later request with the same frozen
reason/hint.  The vector path finds that cut point and replays bucket
charges before it (see ``admit_batch``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


class TokenBucket:
    """Classic token bucket: ``rate_hz`` sustained, ``burst`` peak."""

    def __init__(self, rate_hz: float, burst: float):
        self.rate_hz = float(rate_hz)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t_last: float | None = None

    def _refill(self, now: float):
        if self._t_last is not None and now > self._t_last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t_last) * self.rate_hz)
        self._t_last = now if self._t_last is None else max(self._t_last, now)

    def try_take(self, now: float, n: float = 1.0) -> bool:
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def time_until(self, n: float = 1.0, *, now: float | None = None) -> float:
        """Seconds until ``n`` tokens accumulate (0 if available now).

        Pass ``now`` so the deficit is priced from the level the bucket
        would hold *at this instant* — without it, tokens accrued since the
        last charge are invisible and the hint overstates the wait for any
        bucket not charged right now."""
        if now is not None:
            self._refill(now)
        deficit = n - self.tokens
        return max(0.0, deficit / self.rate_hz) if self.rate_hz > 0 else float("inf")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    reason: str              # "ok" | "queue_full" | "rate_limited" |
                             # "slo_miss" | "cluster_slo_miss" | "shed"
    retry_after_s: float = 0.0


ADMIT = AdmissionDecision(True, "ok")

# Machine-readable reason codes for the columnar batch path (uint8 lanes).
# SHED is issued by the cluster's failover coordinator (watermark-gated load
# shedding during a redistribution transient), never by this controller —
# it lives here so reason codes stay one authoritative enumeration.
OK, QUEUE_FULL, SLO_MISS, CLUSTER_SLO_MISS, RATE_LIMITED, SHED = range(6)
REASONS = ("ok", "queue_full", "slo_miss", "cluster_slo_miss",
           "rate_limited", "shed")


@dataclasses.dataclass
class BatchDecisions:
    """Columnar decisions for one arrival batch (positional, arrival order).

    ``reason_codes`` indexes :data:`REASONS`; ``decision(i)`` materialises
    the scalar :class:`AdmissionDecision` for position ``i`` on demand, so
    the batch path never allocates per-request objects for admitted rows."""

    admitted: np.ndarray          # bool[n]
    reason_codes: np.ndarray      # uint8[n]
    retry_after_s: np.ndarray     # float64[n]

    def __len__(self) -> int:
        return len(self.admitted)

    @property
    def n_admitted(self) -> int:
        return int(np.count_nonzero(self.admitted))

    def reasons(self) -> list[str]:
        return [REASONS[c] for c in self.reason_codes]

    def decision(self, i: int) -> AdmissionDecision:
        if self.admitted[i]:
            return ADMIT
        return AdmissionDecision(False, REASONS[self.reason_codes[i]],
                                 retry_after_s=float(self.retry_after_s[i]))

    def counts(self) -> dict[str, int]:
        """Per-reason decision counts (bulk telemetry)."""
        codes, n = np.unique(self.reason_codes, return_counts=True)
        return {REASONS[c]: int(k) for c, k in zip(codes, n)}


class TenantInterner:
    """Amortised tenant-id → dense-index map.

    Non-negative integer ids below ``dense_limit`` resolve through one numpy
    array probe (``_dense[id]``) — no hashing, no dict, vectorisable for a
    whole batch with one fancy-index gather.  Ids outside that range (huge,
    negative, or non-integer) fall back to a dict.  Indices are assigned in
    first-intern order and never recycled."""

    def __init__(self, dense_limit: int = 1 << 21):
        self.dense_limit = int(dense_limit)
        self._dense = np.full(1024, -1, np.int32)
        self._map: dict = {}
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def _grow_dense(self, need: int):
        cap = len(self._dense)
        while cap <= need:
            cap *= 2
        cap = min(cap, self.dense_limit)
        if cap > len(self._dense):
            grown = np.full(cap, -1, np.int32)
            grown[:len(self._dense)] = self._dense
            self._dense = grown

    def index_of(self, tid):
        """Existing index for ``tid`` or None (never interns)."""
        if isinstance(tid, (int, np.integer)) and 0 <= tid < self.dense_limit:
            t = int(tid)
            if t < len(self._dense):
                i = int(self._dense[t])
                return i if i >= 0 else None
            return None
        return self._map.get(tid)

    def intern(self, tid) -> int:
        if isinstance(tid, (int, np.integer)) and 0 <= tid < self.dense_limit:
            t = int(tid)
            if t >= len(self._dense):
                self._grow_dense(t)
            i = int(self._dense[t])
            if i < 0:
                i = self._n
                self._dense[t] = i
                self._n += 1
            return i
        i = self._map.get(tid)
        if i is None:
            i = self._map[tid] = self._n
            self._n += 1
        return i

    def intern_many(self, ids) -> np.ndarray:
        """Vectorised intern: one gather + one scatter for the dense ids in
        a batch; only never-seen or non-dense ids pay per-item work."""
        arr = np.asarray(ids)
        out = np.empty(len(arr), np.int64)
        if arr.dtype.kind in "iu" and len(arr):
            in_dense = (arr >= 0) & (arr < self.dense_limit)
            if in_dense.all():
                hi = int(arr.max())
                if hi >= len(self._dense):
                    self._grow_dense(hi)
                idx = self._dense[arr]
                miss = idx < 0
                if miss.any():
                    # assign in first-occurrence order so a batch intern is
                    # indistinguishable from the scalar per-item loop
                    uniq, first = np.unique(arr[miss], return_index=True)
                    new_ids = uniq[np.argsort(first, kind="stable")]
                    self._dense[new_ids] = np.arange(
                        self._n, self._n + len(new_ids), dtype=np.int32)
                    self._n += len(new_ids)
                    idx = self._dense[arr]
                out[:] = idx
                return out
        for p, tid in enumerate(arr.tolist()):
            out[p] = self.intern(tid)
        return out


_STATE_DTYPE = np.dtype([("tokens", np.float64), ("t_last", np.float64),
                         ("rate_hz", np.float64), ("burst", np.float64)])


class AdmissionController:
    """Three gates: queue bound, SLO estimate, then the tenant bucket.

    The SLO gate predicts this request's queueing delay as
    ``pending / service_rate`` using an EWMA of observed dispatch throughput;
    requests that would already be late on arrival are rejected immediately
    (better a fast 429 than a slow success past its deadline).  The token
    bucket runs last so server-side rejections never debit a tenant's rate
    budget — only requests the server could actually take consume tokens.

    ``columnar=True`` (default) keeps tenant bucket state in one structured
    array behind a :class:`TenantInterner` and enables the vectorised
    :meth:`admit_batch`; ``columnar=False`` keeps the per-tenant
    :class:`TokenBucket` dict and serves as the oracle the property suite
    compares against.  Decisions are bit-identical either way.
    """

    def __init__(self, *, max_pending: int = 1024,
                 tenant_rate_hz: float | None = None,
                 tenant_burst: float = 8.0,
                 slo_deadline_s: float | None = None,
                 service_rate_init: float = 1024.0,
                 ewma_alpha: float = 0.3,
                 columnar: bool = True):
        self.max_pending = max_pending
        self.tenant_rate_hz = tenant_rate_hz
        self.tenant_burst = tenant_burst
        self.slo_deadline_s = slo_deadline_s
        self.service_rate = float(service_rate_init)   # ops/s, EWMA-updated
        self.ewma_alpha = ewma_alpha
        self.columnar = bool(columnar)
        self._buckets: dict[int, TokenBucket] = {}     # scalar mode
        self._interner = TenantInterner()              # columnar mode
        self._state = np.zeros(0, _STATE_DTYPE)

    # --- shared estimators ----------------------------------------------------

    def observe_service(self, n_ops: int, elapsed_s: float):
        """Fold a completed dispatch into the service-rate estimate."""
        if elapsed_s <= 0 or n_ops <= 0:
            return
        rate = n_ops / elapsed_s
        a = self.ewma_alpha
        self.service_rate = (1 - a) * self.service_rate + a * rate

    def estimated_wait_s(self, pending: int) -> float:
        return pending / self.service_rate if self.service_rate > 0 else float("inf")

    def backpressure(self, pending: int, *, high_watermark: float = 0.8) -> bool:
        """Soft signal: queue above the watermark — clients should slow down
        before hard rejections begin."""
        return pending >= high_watermark * self.max_pending

    @property
    def tenants(self) -> int:
        """Distinct tenants with bucket state (either layout)."""
        return len(self._interner) if self.columnar else len(self._buckets)

    def bucket_level(self, tenant_id, now: float) -> float | None:
        """Pure probe: the token level ``tenant_id``'s bucket would hold at
        ``now`` (no state mutation) — None if the tenant has no bucket yet.
        The parity suite compares levels across layouts through this."""
        if self.tenant_rate_hz is None:
            return None
        if not self.columnar:
            b = self._buckets.get(tenant_id)
            if b is None:
                return None
            tokens, t_last = b.tokens, b._t_last
            if t_last is not None and now > t_last:
                tokens = min(b.burst, tokens + (now - t_last) * b.rate_hz)
            return tokens
        i = self._interner.index_of(tenant_id)
        if i is None:
            return None
        row = self._state[i]
        tokens = float(row["tokens"])
        t_last = float(row["t_last"])
        if now > t_last:
            gain = (now - t_last) * float(row["rate_hz"])
            if math.isnan(gain):          # fresh row (t_last = -inf), rate 0
                gain = math.inf
            tokens = min(float(row["burst"]), tokens + gain)
        return tokens

    # --- columnar state plumbing ----------------------------------------------

    def _grow_state(self, need: int):
        cap = max(1024, len(self._state))
        while cap < need:
            cap *= 2
        if cap > len(self._state):
            grown = np.zeros(cap, _STATE_DTYPE)
            grown[:len(self._state)] = self._state
            n0 = len(self._state)
            grown["tokens"][n0:] = self.tenant_burst
            # -inf marks a never-refilled row: the first refill then clamps
            # straight to burst (dt = +inf) exactly like a fresh TokenBucket,
            # and t_last picks up the true first-seen instant even when the
            # virtual clock is negative.
            grown["t_last"][n0:] = -np.inf
            grown["rate_hz"][n0:] = self.tenant_rate_hz or 0.0
            grown["burst"][n0:] = self.tenant_burst
            self._state = grown

    def _intern_rows(self, ids) -> np.ndarray:
        idx = self._interner.intern_many(ids)
        n = len(self._interner)
        if n > len(self._state):
            self._grow_state(n)
        return idx

    def _charge_one(self, i: int, now: float) -> tuple[bool, float]:
        """Scalar refill+charge of columnar row ``i`` — the same float ops
        as TokenBucket.try_take/time_until, on the structured-array lanes."""
        st = self._state
        tokens = float(st["tokens"][i])
        t_last = float(st["t_last"][i])
        rate = float(st["rate_hz"][i])
        burst = float(st["burst"][i])
        if now > t_last:
            gain = (now - t_last) * rate
            if math.isnan(gain):                      # fresh row, rate 0
                gain = math.inf
            tokens = min(burst, tokens + gain)
            t_last = now
        st["t_last"][i] = t_last
        if tokens >= 1.0:
            st["tokens"][i] = tokens - 1.0
            return True, 0.0
        st["tokens"][i] = tokens
        deficit = 1.0 - tokens
        hint = max(0.0, deficit / rate) if rate > 0 else math.inf
        return False, hint

    def set_tenant_limit(self, tenant_id, *, rate_hz: float, burst: float):
        """Per-tenant rate override.  Resets the tenant's bucket to a fresh
        full one (both layouts), so the ``tokens ≤ burst`` invariant the
        vector refill relies on holds by construction."""
        if self.columnar:
            i = self._interner.intern(tenant_id)
            if len(self._interner) > len(self._state):
                self._grow_state(len(self._interner))
            self._state[i] = (float(burst), -np.inf, float(rate_hz),
                              float(burst))
        else:
            self._buckets[tenant_id] = TokenBucket(rate_hz, burst)

    # --- per-request path -----------------------------------------------------

    def admit(self, req, now: float, pending: int,
              cluster_pending: float | None = None) -> AdmissionDecision:
        """``cluster_pending`` is the per-host-equivalent cluster queue depth
        (cluster total / live hosts) from the gossip layer; ``None`` means no
        cluster view and the SLO gate falls back to local state only.  The
        cluster check runs after the local one so ``cluster_slo_miss`` always
        means a rejection local-only state would have admitted."""
        if pending >= self.max_pending:
            return AdmissionDecision(False, "queue_full",
                                     retry_after_s=self.estimated_wait_s(pending))
        if self.slo_deadline_s is not None:
            wait = self.estimated_wait_s(pending)
            if wait > self.slo_deadline_s:
                return AdmissionDecision(False, "slo_miss", retry_after_s=wait)
            if cluster_pending is not None and cluster_pending > pending:
                cwait = self.estimated_wait_s(cluster_pending)
                if cwait > self.slo_deadline_s:
                    return AdmissionDecision(False, "cluster_slo_miss",
                                             retry_after_s=cwait)
        if self.tenant_rate_hz is not None:
            if self.columnar:
                i = self._interner.intern(req.tenant_id)
                if len(self._interner) > len(self._state):
                    self._grow_state(len(self._interner))
                ok, hint = self._charge_one(i, now)
                if not ok:
                    return AdmissionDecision(False, "rate_limited",
                                             retry_after_s=hint)
            else:
                bucket = self._buckets.get(req.tenant_id)
                if bucket is None:
                    bucket = self._buckets[req.tenant_id] = TokenBucket(
                        self.tenant_rate_hz, self.tenant_burst)
                if not bucket.try_take(now):
                    return AdmissionDecision(False, "rate_limited",
                                             retry_after_s=bucket.time_until(
                                                 now=now))
        return ADMIT

    # --- batch path -----------------------------------------------------------

    def admit_batch(self, tenant_ids, nows, *, pending: int,
                    cluster_pending: float | None = None) -> BatchDecisions:
        """Admit one arrival batch (arrival order) against entering depth
        ``pending``.  Semantically this IS the scalar loop

            for tid, t in zip(tenant_ids, nows):
                d = self.admit(req(tid), t, pending + admitted_so_far, ...)

        — same decisions, reasons, hints, and bucket state, bit for bit —
        vectorised.  ``cluster_pending`` is sampled once for the batch (the
        scalar loop at a batch edge would re-read the same digest anyway).
        """
        ids = np.asarray(tenant_ids)
        ts = np.asarray(nows, np.float64)
        if ts.ndim == 0:
            ts = np.broadcast_to(ts, ids.shape).copy()
        n = len(ids)
        if n == 0:
            return BatchDecisions(np.zeros(0, bool), np.zeros(0, np.uint8),
                                  np.zeros(0))
        if not self.columnar:
            return self._admit_batch_scalar(ids, ts, pending, cluster_pending)

        # Gate threshold: the queue/SLO gates see pending + admitted-so-far,
        # which never decreases within a batch, so there is a first admitted
        # count T at which they reject — and from then on every request gets
        # that same frozen reason and hint.  Scan the n+1 candidate counts.
        cand = pending + np.arange(n + 1)
        sr = self.service_rate
        wait_cand = (cand / sr if sr > 0
                     else np.full(n + 1, np.inf))
        rej_q = cand >= self.max_pending
        rej_s = np.zeros(n + 1, bool)
        rej_c = np.zeros(n + 1, bool)
        cwait = 0.0
        if self.slo_deadline_s is not None:
            rej_s = wait_cand > self.slo_deadline_s
            if cluster_pending is not None:
                cwait = (cluster_pending / sr) if sr > 0 else math.inf
                rej_c = ((cluster_pending > cand)
                         & (cwait > self.slo_deadline_s))
        gate_rej = rej_q | rej_s | rej_c
        if gate_rej.any():
            T = int(np.argmax(gate_rej))
            if rej_q[T]:
                g_code, g_hint = QUEUE_FULL, float(wait_cand[T])
            elif rej_s[T]:
                g_code, g_hint = SLO_MISS, float(wait_cand[T])
            else:
                g_code, g_hint = CLUSTER_SLO_MISS, float(cwait)
        else:
            T, g_code, g_hint = n + 1, OK, 0.0

        admitted = np.zeros(n, bool)
        codes = np.zeros(n, np.uint8)
        retry = np.zeros(n, np.float64)
        if T == 0:
            # Gate already closed on entry: nothing reaches the buckets, no
            # tenant is interned (the scalar loop never touches them either).
            codes[:] = g_code
            retry[:] = g_hint
            return BatchDecisions(admitted, codes, retry)

        if self.tenant_rate_hz is None:
            cut = min(T, n)
            admitted[:cut] = True
            codes[cut:] = g_code
            retry[cut:] = g_hint
            return BatchDecisions(admitted, codes, retry)

        idx = self._intern_rows(ids)
        # Occurrence rank: the r-th time a tenant appears in this batch.
        # Positions sharing a rank hit distinct state rows, so each round is
        # one safe fancy-indexed refill+charge; duplicates serialise across
        # rounds exactly like the scalar loop would.
        order = np.argsort(idx, kind="stable")
        sidx = idx[order]
        is_start = np.empty(n, bool)
        is_start[0] = True
        is_start[1:] = sidx[1:] != sidx[:-1]
        pos = np.arange(n)
        occ = np.empty(n, np.int64)
        occ[order] = pos - np.maximum.accumulate(np.where(is_start, pos, 0))
        max_occ = int(occ.max())

        # Snapshot touched rows: if the gate cuts mid-batch we restore and
        # replay only the prefix, so post-cut requests leave zero trace in
        # bucket state (they never reached the buckets in the scalar loop).
        need_snap = T <= n
        if need_snap:
            touched = np.unique(idx)
            snap = self._state[touched].copy()

        bucket_ok = np.empty(n, bool)
        bucket_hint = np.empty(n, np.float64)

        def scan(limit: int):
            st = self._state
            tok_f, tl_f = st["tokens"], st["t_last"]
            rate_f, burst_f = st["rate_hz"], st["burst"]
            for r in range(max_occ + 1):
                sel = np.nonzero((occ == r) & (pos < limit))[0]
                if not len(sel):
                    break
                i = idx[sel]
                t = ts[sel]
                tl = tl_f[i]
                rate = rate_f[i]
                burst = burst_f[i]
                # dt clamped at 0 ≡ the scalar skip-if-backwards branch:
                # min(burst, tokens + 0) is tokens under tokens ≤ burst.
                with np.errstate(invalid="ignore"):  # fresh row dt=inf × rate 0
                    gain = np.maximum(0.0, t - tl) * rate
                gain[np.isnan(gain)] = np.inf
                tok = np.minimum(burst, tok_f[i] + gain)
                ok = tok >= 1.0
                tok_f[i] = tok - ok                 # charge 1.0 where ok
                tl_f[i] = np.maximum(tl, t)
                bucket_ok[sel] = ok
                deficit = 1.0 - tok
                hint = np.divide(deficit, rate,
                                 out=np.full(len(sel), np.inf),
                                 where=rate > 0)
                bucket_hint[sel] = np.maximum(0.0, hint)

        scan(n)
        cut = n
        if need_snap:
            # First position whose *entering* admitted count reaches T — the
            # gate slams shut there; restore and replay the clean prefix.
            entering = np.concatenate(
                ([0], np.cumsum(bucket_ok[:-1], dtype=np.int64)))
            over = entering >= T
            if over.any():
                cut = int(np.argmax(over))
                self._state[touched] = snap
                scan(cut)

        admitted[:cut] = bucket_ok[:cut]
        rl = ~bucket_ok[:cut]
        codes[:cut][rl] = RATE_LIMITED
        retry[:cut][rl] = bucket_hint[:cut][rl]
        codes[cut:] = g_code
        retry[cut:] = g_hint
        return BatchDecisions(admitted, codes, retry)

    def _admit_batch_scalar(self, ids, ts, pending, cluster_pending):
        """The oracle: the literal per-request loop over admit()."""
        n = len(ids)
        admitted = np.zeros(n, bool)
        codes = np.zeros(n, np.uint8)
        retry = np.zeros(n, np.float64)
        extra = 0
        req = _BucketProbe(None)
        for p in range(n):
            req.tenant_id = ids[p] if ids.dtype.kind not in "iu" \
                else int(ids[p])
            d = self.admit(req, float(ts[p]), pending + extra,
                           cluster_pending=cluster_pending)
            admitted[p] = d.admitted
            codes[p] = REASONS.index(d.reason)
            retry[p] = d.retry_after_s
            extra += d.admitted
        return BatchDecisions(admitted, codes, retry)


class _BucketProbe:
    """Minimal request stand-in for the oracle loop (tenant_id only)."""
    __slots__ = ("tenant_id",)

    def __init__(self, tenant_id):
        self.tenant_id = tenant_id

"""Per-tenant SLO observability, the runner side: accounting, burn, audit.

The port's own copy of the runner half of ``helix_tpu/obs/slo.py``
(standard library only).  Four pieces:

- **Identity plumbing** — the ``X-Helix-Tenant`` header, the one
  sanitiser applied to it, and ``resolve_tenant`` (auth user id, a
  stable hash of the API key, or ``anonymous`` when auth is off).
- :class:`TenantAccounting` — per-tenant request/token/shed/preemption
  counters plus sliding-window TTFT / queue-wait / goodput, with
  **bounded cardinality**: only the top-K most recently active tenants
  get their own label series; everyone else folds into one
  ``__other__`` bucket (LRU demotion conserves the counter totals), so
  the runner's ``/metrics`` series count is CONSTANT under tenant
  churn.  This class is the ONLY emitter of ``tenant``-labelled metrics
  in the port (``tests/test_torch_obs.py`` fails on tenant labels
  minted anywhere else).
- :class:`SLOObserver` — the bundle one ``EngineLoop`` owns: the
  accounting above, declared :class:`SLOTargets` (from the profile's
  ``slo:`` block), and multi-window error-budget **burn rates** (fast /
  slow, default 5 m / 1 h, ``HELIX_SLO_BURN_WINDOWS``).  For a p95
  latency target the error budget is the 5 % of requests allowed to
  exceed it; burn rate = (violating fraction over the window) / 0.05,
  so 1.0 means the budget is being spent exactly as fast as it
  accrues and >1.0 means the SLO is being violated.  The scheduler's
  adaptive prefill budget reads ``latency_fast_burn()``.
- :class:`AdmissionAudit` — a bounded ring of admission *decisions*
  (429 shed, kv_exhausted shed, quarantine eviction,
  preemption-by-swap) with ``(tenant, trace_id, reason, queue state)``,
  served at ``GET /v1/debug/admissions`` on the runner.

Bookkeeping shapes (each chosen so neither traffic rate nor window
length can silently distort the numbers):

- *Latency violations* land in per-minute buckets ``(requests,
  ttft_violations, queue_wait_violations)`` — O(slow_window/60)
  memory per tenant, so the slow-window burn really covers the whole
  hour at any request rate.
- *Goodput* rides the monotonic generated-token counter with a
  once-per-second ``(ts, cumulative)`` sample list (the RateTracker
  idea): window tokens = counter_now − counter_at_anchor, exact at any
  token rate.
- *Quantile gauges* (p50/p95) come from a bounded recent-sample deque:
  at high rates they cover the most recent ~1024 requests of the fast
  window; burn rates never read them.
- Scrape-time ``collect``/``rollup`` snapshot under the lock with
  C-level copies and compute OUTSIDE it, so a /metrics scrape can't
  stall the engine thread's per-step notes.

``TENANT_KEYS`` is the per-tenant entry schema of the ``rollup()``
block (the reference's tuple, key for key).  The control-plane side
(``merge_rollups``, ``validate_tenant_rollup``,
``collect_cp_tenant_gauges``) waits for the node agent (ROADMAP A7b).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import hashlib
import math
import os
import re
import threading
import time
from typing import Callable, Optional

# the tenant identity header, minted by the control plane at dispatch
# (alongside X-Helix-Trace-Id) and adopted by the runner's OpenAI surface
TENANT_HEADER = "X-Helix-Tenant"

# identity of unauthenticated traffic (auth off, or no usable identity)
ANON_TENANT = "anonymous"
# the fold bucket demoted tenants aggregate into; a client may not claim
# it (sanitize_tenant maps it to anonymous)
OTHER_TENANT = "__other__"
# the correctness-canary prober's identity (the reference's
# obs/canary.py, ROADMAP A19): probes ride the real serving path under
# this tenant but are invisible to tenant accounting, SLO burn and
# autoscale signals; equally unclaimable
CANARY_TENANT = "__canary__"

_TENANT_RE = re.compile(r"[A-Za-z0-9_.@+:-]{1,64}")

# The per-tenant entry schema of the ``tenants`` rollup block: exactly
# these numeric keys per tenant (plus the ``tenant`` id itself), the
# reference's tuple key for key, so a torch runner's rollup merges with
# a JAX runner's.
TENANT_KEYS = (
    "prompt_tokens",            # lifetime prompt tokens admitted
    "generated_tokens",         # lifetime tokens emitted
    "requests",                 # lifetime requests that reached a token
    "sheds",                    # 429/503 load sheds (all reasons)
    "kv_exhausted",             # the typed kv_exhausted subset of sheds
    "preemptions",              # decoders swapped out mid-generation
    "goodput_tps",              # tokens/s over the fast window
    "ttft_p95_seconds",         # recent-sample p95 submit -> first token
    "queue_wait_p95_seconds",   # recent-sample p95 submit -> admission
    "burn_rate_fast",           # worst SLO burn over the fast window
    "burn_rate_slow",           # worst SLO burn over the slow window
)

# p95 targets grant a 5% error budget; burn = violating fraction / this
_ERROR_BUDGET = 0.05

_DEFAULT_WINDOWS = (300.0, 3600.0)

# violation buckets are minute-granular: horizon edges are fuzzy by at
# most one bucket, memory is slow_window/60 + 1 entries per tenant
_BUCKET_SECONDS = 60.0


def sanitize_tenant(raw) -> str:
    """The one tenant-id sanitiser both planes apply: printable
    identifier-ish strings up to 64 chars pass through, anything else
    (missing header, control chars, a client claiming the ``__other__``
    fold bucket or the ``__canary__`` prober identity) lands under
    ``anonymous`` — a hostile header must never mint an arbitrary
    /metrics label value or hide traffic inside the canary lane."""
    if not isinstance(raw, str):
        return ANON_TENANT
    raw = raw.strip()
    if (
        not raw
        or raw == OTHER_TENANT
        or raw == CANARY_TENANT
        or not _TENANT_RE.fullmatch(raw)
    ):
        return ANON_TENANT
    return raw


def resolve_tenant(user=None, bearer: Optional[str] = None) -> str:
    """The dispatch-time identity: the authenticated user's id when auth
    resolved one, else a stable short hash of the presented API key
    (unknown keys still get per-key accounting without storing the
    secret), else ``anonymous``."""
    if user is not None and getattr(user, "id", ""):
        return sanitize_tenant(str(user.id))
    if bearer:
        token = (
            bearer.split(" ", 1)[1]
            if bearer.lower().startswith("bearer ")
            else bearer
        ).strip()
        if token:
            digest = hashlib.blake2b(
                token.encode("utf-8", "replace"), digest_size=6
            ).hexdigest()
            return f"key-{digest}"
    return ANON_TENANT


def tenant_top_k_from_env(default: int = 8) -> int:
    """``HELIX_TENANT_TOP_K``: how many tenants get their own label
    series per engine (everyone else folds into ``__other__``)."""
    v = os.environ.get("HELIX_TENANT_TOP_K", "")
    try:
        return max(1, int(v)) if v else default
    except ValueError:
        return default


def burn_windows_from_env(
    default: tuple = _DEFAULT_WINDOWS,
) -> tuple:
    """``HELIX_SLO_BURN_WINDOWS``: "fast,slow" seconds for the two
    burn-rate windows (default "300,3600")."""
    v = os.environ.get("HELIX_SLO_BURN_WINDOWS", "")
    if not v:
        return default
    try:
        parts = [float(p) for p in v.split(",")]
    except ValueError:
        return default
    if len(parts) != 2 or parts[0] <= 0 or parts[1] <= 0:
        return default
    return (min(parts), max(parts))


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    """SLO targets a profile declares per model (``slo:`` block).  None
    disables that objective's burn-rate gauge."""

    ttft_p95_seconds: Optional[float] = None
    queue_wait_p95_seconds: Optional[float] = None
    goodput_floor_tps: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SLOTargets":
        d = d or {}

        def num(key):
            v = d.get(key)
            if v is None:
                return None
            try:
                f = float(v)
            except (TypeError, ValueError):
                return None
            return f if math.isfinite(f) and f > 0 else None

        return cls(
            ttft_p95_seconds=num("ttft_p95_seconds"),
            queue_wait_p95_seconds=num("queue_wait_p95_seconds"),
            goodput_floor_tps=num("goodput_floor_tps"),
        )

    def to_dict(self) -> dict:
        return {
            k: v
            for k, v in dataclasses.asdict(self).items()
            if v is not None
        }

    @property
    def any(self) -> bool:
        return any(
            (self.ttft_p95_seconds, self.queue_wait_p95_seconds,
             self.goodput_floor_tps)
        )


class _TenantStats:
    """One tenant's counters + bounded windows.  Mutated only under the
    owning TenantAccounting's lock."""

    __slots__ = (
        "prompt_tokens", "generated_tokens", "requests", "sheds",
        "kv_exhausted", "preemptions", "ttft", "queue_wait",
        "tok_samples", "buckets", "last_seen",
    )

    def __init__(self):
        self.prompt_tokens = 0
        self.generated_tokens = 0
        self.requests = 0
        self.sheds = 0
        self.kv_exhausted = 0
        self.preemptions = 0
        # recent (ts, value) samples for the p50/p95 GAUGES only
        self.ttft: collections.deque = collections.deque(maxlen=1024)
        self.queue_wait: collections.deque = collections.deque(maxlen=1024)
        # goodput: throttled (ts, cumulative generated_tokens) samples —
        # window tokens = counter_now - counter_at_anchor, exact at any
        # token rate (first entry is a pre-traffic zero anchor)
        self.tok_samples: list = []
        # latency-violation minute buckets:
        # minute -> [requests, ttft_violations, queue_wait_violations]
        self.buckets: dict[int, list] = {}
        self.last_seen = 0.0

    def fold_into(self, other: "_TenantStats") -> None:
        """Demotion: counter totals and violation buckets are conserved
        into ``other`` (burn rates stay honest for the fold bucket); the
        quantile sample windows are dropped (a folded bucket's
        quantiles would mix tenants anyway).  ``other``'s goodput
        samples are rebased so the folded lifetime tokens read as
        *pre-window* history, not a burst just now."""
        other.prompt_tokens += self.prompt_tokens
        other.generated_tokens += self.generated_tokens
        other.requests += self.requests
        other.sheds += self.sheds
        other.kv_exhausted += self.kv_exhausted
        other.preemptions += self.preemptions
        for minute, counts in self.buckets.items():
            cur = other.buckets.get(minute)
            if cur is None:
                other.buckets[minute] = list(counts)
            else:
                for i in range(3):
                    cur[i] += counts[i]
        if self.generated_tokens and other.tok_samples:
            other.tok_samples = [
                (ts, v + self.generated_tokens)
                for ts, v in other.tok_samples
            ]
        other.last_seen = max(other.last_seen, self.last_seen)


def _quantile(values: list, q: float) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    return s[min(len(s) - 1, int(len(s) * q))]


class _TenantSnap:
    """Point-in-time copy of one tenant's state, taken under the
    accounting lock with C-level container copies; all derived numbers
    (quantiles, window sums, burn rates) are computed from it OUTSIDE
    the lock so scrapes never stall the engine thread."""

    __slots__ = (
        "tenant", "prompt_tokens", "generated_tokens", "requests",
        "sheds", "kv_exhausted", "preemptions", "ttft", "queue_wait",
        "tok_samples", "buckets", "last_seen",
    )

    def __init__(self, tenant: str, st: _TenantStats):
        self.tenant = tenant
        self.prompt_tokens = st.prompt_tokens
        self.generated_tokens = st.generated_tokens
        self.requests = st.requests
        self.sheds = st.sheds
        self.kv_exhausted = st.kv_exhausted
        self.preemptions = st.preemptions
        self.ttft = list(st.ttft)
        self.queue_wait = list(st.queue_wait)
        self.tok_samples = list(st.tok_samples)
        self.buckets = {m: list(c) for m, c in st.buckets.items()}
        self.last_seen = st.last_seen


class TenantAccounting:
    """Bounded per-tenant accounting: top-K tenants by recency get their
    own series, the rest fold into ``__other__``.  Thread-safe — the
    engine-loop thread writes, /metrics scrape and heartbeat threads
    read.  ``targets`` are fixed at construction: latency violations
    are judged once, at observe time, and bucketed."""

    def __init__(
        self,
        top_k: int = 8,
        windows: tuple = _DEFAULT_WINDOWS,
        targets: Optional[SLOTargets] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.top_k = max(1, int(top_k))
        self.fast_window, self.slow_window = windows
        self.targets = targets or SLOTargets()
        self.clock = clock
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantStats] = {}
        self._other = _TenantStats()
        self._all = _TenantStats()   # every tenant pooled: per-model SLO
        self.demotions = 0           # lifetime top-K -> __other__ folds

    # -- write side ---------------------------------------------------------

    def _stats_locked(self, tenant: str) -> _TenantStats:
        st = self._tenants.get(tenant)
        if st is None:
            if len(self._tenants) >= self.top_k:
                # LRU demotion: the least recently active tenant folds
                # into __other__ (totals conserved) so the label-series
                # count stays fixed under churn
                victim = min(
                    self._tenants, key=lambda t: self._tenants[t].last_seen
                )
                self._tenants.pop(victim).fold_into(self._other)
                self.demotions += 1
            st = self._tenants[tenant] = _TenantStats()
        st.last_seen = self.clock()
        return st

    def _bucket_locked(self, st: _TenantStats, now: float,
                       ttft_s: float, queue_wait_s: float) -> None:
        minute = int(now // _BUCKET_SECONDS)
        b = st.buckets.get(minute)
        if b is None:
            b = st.buckets[minute] = [0, 0, 0]
            floor = int(
                (now - self.slow_window) // _BUCKET_SECONDS
            ) - 1
            stale = [m for m in st.buckets if m < floor]
            for m in stale:
                del st.buckets[m]
        b[0] += 1
        t = self.targets
        if t.ttft_p95_seconds is not None and ttft_s > t.ttft_p95_seconds:
            b[1] += 1
        if (
            t.queue_wait_p95_seconds is not None
            and queue_wait_s > t.queue_wait_p95_seconds
        ):
            b[2] += 1

    def note_first_token(
        self, tenant: str, ttft_s: float, queue_wait_s: float,
        prompt_tokens: int,
    ) -> None:
        now = self.clock()
        with self._lock:
            for st in (self._stats_locked(tenant), self._all):
                st.requests += 1
                st.prompt_tokens += prompt_tokens
                st.ttft.append((now, float(ttft_s)))
                st.queue_wait.append((now, float(queue_wait_s)))
                self._bucket_locked(st, now, ttft_s, queue_wait_s)

    def note_tokens(self, tenant: str, n: int = 1) -> None:
        now = self.clock()
        with self._lock:
            for st in (self._stats_locked(tenant), self._all):
                st.generated_tokens += n
                s = st.tok_samples
                if not s:
                    # pre-traffic zero anchor: window sums for horizons
                    # longer than the tenant's age come out exact
                    s.append((now, st.generated_tokens - n))
                if now - s[-1][0] >= 1.0:
                    s.append((now, st.generated_tokens))
                    if (
                        len(s) > 64
                        and now - s[1][0] > self.slow_window + 1.0
                    ):
                        # prune stale head, keeping one anchor at or
                        # before the slow horizon
                        cutoff = now - self.slow_window - 1.0
                        i = bisect.bisect_right(
                            s, (cutoff, float("inf"))
                        ) - 1
                        if i > 0:
                            del s[:i]

    def note_shed(self, tenant: str, kv_exhausted: bool = False) -> None:
        with self._lock:
            for st in (self._stats_locked(tenant), self._all):
                st.sheds += 1
                if kv_exhausted:
                    st.kv_exhausted += 1

    def note_preemption(self, tenant: str) -> None:
        with self._lock:
            for st in (self._stats_locked(tenant), self._all):
                st.preemptions += 1

    # -- read side (lock-free math over _TenantSnap copies) -----------------

    @staticmethod
    def _window_tokens(snap, now: float, horizon: float) -> int:
        """Tokens generated within the horizon: monotonic counter minus
        its value at the newest sample at/before the horizon edge (the
        leading zero anchor covers tenants younger than the horizon)."""
        s = snap.tok_samples
        if not s:
            return 0
        cutoff = now - horizon
        i = bisect.bisect_right(s, (cutoff, float("inf"))) - 1
        v0 = s[i][1] if i >= 0 else s[0][1]
        return max(0, snap.generated_tokens - v0)

    @staticmethod
    def _window_rate(snap, now: float, horizon: float) -> float:
        """Tokens/s over the horizon, RateTracker semantics: when the
        tenant is younger than the horizon the divisor is its actual
        active span, so a fresh tenant's rate is not diluted by history
        it was never alive for."""
        s = snap.tok_samples
        if not s:
            return 0.0
        cutoff = now - horizon
        i = bisect.bisect_right(s, (cutoff, float("inf"))) - 1
        if i >= 0:
            v0, dt = s[i][1], horizon
        else:
            v0, dt = s[0][1], max(1.0, now - s[0][0])
        return max(0, snap.generated_tokens - v0) / dt

    def _goodput(self, snap, now: float) -> float:
        return self._window_rate(snap, now, self.fast_window)

    def _burn(self, snap, now: float, horizon: float,
              per_tenant: bool = False) -> dict:
        """Error-budget burn per declared SLO over one window.  Latency
        p95 targets: (violating fraction of the window's requests, from
        the minute buckets) / the 5% budget.  Goodput floor: shortfall
        fraction / the budget, only while there was traffic — and only
        for the POOLED per-model view (``per_tenant=False``): a demand
        floor is a capacity SLO, and judging it per tenant would brand
        every ordinary low-demand tenant a maximal violator."""
        t = self.targets
        out: dict = {}
        if (
            t.ttft_p95_seconds is not None
            or t.queue_wait_p95_seconds is not None
        ):
            start = int((now - horizon) // _BUCKET_SECONDS)
            n = vt = vq = 0
            for minute, (cnt, tviol, qviol) in snap.buckets.items():
                if minute >= start:
                    n += cnt
                    vt += tviol
                    vq += qviol
            if t.ttft_p95_seconds is not None:
                out["ttft_p95"] = (vt / n / _ERROR_BUDGET) if n else 0.0
            if t.queue_wait_p95_seconds is not None:
                out["queue_wait_p95"] = (
                    (vq / n / _ERROR_BUDGET) if n else 0.0
                )
        if t.goodput_floor_tps is not None and not per_tenant:
            active = self._window_tokens(snap, now, horizon) > 0 or any(
                minute >= int((now - horizon) // _BUCKET_SECONDS)
                for minute in snap.buckets
            )
            if active:
                goodput = self._window_rate(snap, now, horizon)
                shortfall = max(
                    0.0,
                    (t.goodput_floor_tps - goodput)
                    / t.goodput_floor_tps,
                )
                out["goodput_floor"] = shortfall / _ERROR_BUDGET
            else:
                out["goodput_floor"] = 0.0
        return out

    def _snapshot(self, tenant: Optional[str] = None):
        """One tenant's copy (None = the pooled ``_all``), or None for
        an unknown tenant."""
        with self._lock:
            if tenant is None:
                return _TenantSnap("", self._all)
            st = self._tenants.get(tenant)
            return None if st is None else _TenantSnap(tenant, st)

    def _snapshot_rows(self) -> list:
        with self._lock:
            rows = [
                _TenantSnap(t, st) for t, st in self._tenants.items()
            ]
            rows.append(_TenantSnap(OTHER_TENANT, self._other))
            return rows

    def burn_rates(self, tenant: Optional[str] = None) -> dict:
        """{window: {slo: burn}} for one tenant (None = the pooled
        per-model view), against the construction-time targets."""
        snap = self._snapshot(tenant)
        if snap is None:
            snap = _TenantSnap("", _TenantStats())
        now = self.clock()
        per_tenant = tenant is not None
        return {
            "fast": self._burn(snap, now, self.fast_window,
                               per_tenant=per_tenant),
            "slow": self._burn(snap, now, self.slow_window,
                               per_tenant=per_tenant),
        }

    def totals(self) -> dict:
        """Pooled lifetime counters (conservation checks + stats())."""
        with self._lock:
            a = self._all
            return {
                "prompt_tokens": a.prompt_tokens,
                "generated_tokens": a.generated_tokens,
                "requests": a.requests,
                "sheds": a.sheds,
                "kv_exhausted": a.kv_exhausted,
                "preemptions": a.preemptions,
                "tracked_tenants": len(self._tenants),
                "demotions": self.demotions,
            }

    def _entry(self, snap, now: float) -> dict:
        fast = self._burn(snap, now, self.fast_window, per_tenant=True)
        slow = self._burn(snap, now, self.slow_window, per_tenant=True)
        return {
            "tenant": snap.tenant,
            "prompt_tokens": snap.prompt_tokens,
            "generated_tokens": snap.generated_tokens,
            "requests": snap.requests,
            "sheds": snap.sheds,
            "kv_exhausted": snap.kv_exhausted,
            "preemptions": snap.preemptions,
            "goodput_tps": round(self._goodput(snap, now), 2),
            "ttft_p95_seconds": round(
                _quantile(
                    [v for ts, v in snap.ttft
                     if now - ts <= self.fast_window], 0.95,
                ), 6,
            ),
            "queue_wait_p95_seconds": round(
                _quantile(
                    [v for ts, v in snap.queue_wait
                     if now - ts <= self.fast_window], 0.95,
                ), 6,
            ),
            "burn_rate_fast": round(max(fast.values(), default=0.0), 4),
            "burn_rate_slow": round(max(slow.values(), default=0.0), 4),
        }

    def rollup(self) -> dict:
        """The compact ``tenants`` block a node heartbeats: one
        TENANT_KEYS entry per tracked tenant plus the ``__other__``
        fold, ordered by recent activity."""
        rows = self._snapshot_rows()
        now = self.clock()
        entries = []
        for snap in sorted(rows[:-1], key=lambda s: -s.last_seen):
            entries.append(self._entry(snap, now))
        other = rows[-1]
        if other.requests or other.sheds or other.preemptions:
            entries.append(self._entry(other, now))
        with self._lock:
            tracked, demotions = len(self._tenants), self.demotions
        return {"top": entries, "tracked": tracked,
                "demotions": demotions}

    # -- /metrics (the port's ONLY tenant-label emitter)

    def collect(self, c, lbl: dict) -> None:
        """Scrape-time samples with a ``tenant`` label: top-K tenants +
        the ``__other__`` fold, a fixed number of series regardless of
        how many tenants have ever been seen.  The lock is held only
        for the snapshot copies; all math runs outside it."""
        rows = self._snapshot_rows()
        with self._lock:
            tracked, demotions = len(self._tenants), self.demotions
            all_snap = _TenantSnap("", self._all)
        now = self.clock()
        for snap in rows:
            tl = {**lbl, "tenant": snap.tenant}
            c.counter("helix_tenant_prompt_tokens_total",
                      snap.prompt_tokens, tl)
            c.counter("helix_tenant_generated_tokens_total",
                      snap.generated_tokens, tl)
            c.counter("helix_tenant_requests_total", snap.requests, tl)
            c.counter("helix_tenant_sheds_total", snap.sheds, tl)
            c.counter("helix_tenant_kv_exhausted_sheds_total",
                      snap.kv_exhausted, tl)
            c.counter("helix_tenant_preemptions_total",
                      snap.preemptions, tl)
            c.gauge(
                "helix_tenant_goodput_tokens_per_second",
                round(self._goodput(snap, now), 4), tl,
            )
            c.gauge(
                "helix_tenant_ttft_p95_seconds",
                _quantile(
                    [v for ts, v in snap.ttft
                     if now - ts <= self.fast_window], 0.95,
                ), tl,
            )
            c.gauge(
                "helix_tenant_queue_wait_p95_seconds",
                _quantile(
                    [v for ts, v in snap.queue_wait
                     if now - ts <= self.fast_window], 0.95,
                ), tl,
            )
            if self.targets.any:
                for window, horizon in (
                    ("fast", self.fast_window),
                    ("slow", self.slow_window),
                ):
                    for slo, burn in self._burn(
                        snap, now, horizon, per_tenant=True
                    ).items():
                        c.gauge(
                            "helix_tenant_slo_burn_rate",
                            round(burn, 4),
                            {**tl, "slo": slo, "window": window},
                        )
        # cardinality introspection + the pooled per-model burn
        c.gauge("helix_tenant_tracked", tracked, lbl)
        c.counter("helix_tenant_demotions_total", demotions, lbl)
        if self.targets.any:
            for window, horizon in (
                ("fast", self.fast_window),
                ("slow", self.slow_window),
            ):
                for slo, burn in self._burn(
                    all_snap, now, horizon
                ).items():
                    c.gauge(
                        "helix_slo_burn_rate", round(burn, 4),
                        {**lbl, "slo": slo, "window": window},
                    )


class AdmissionAudit:
    """Bounded ring of admission decisions: every 429 shed, typed
    kv_exhausted shed, quarantine eviction and preemption-by-swap is
    recorded with its tenant, trace id and the queue state at the
    moment of the decision — the "why was MY request rejected" trail,
    served at ``GET /v1/debug/admissions``."""

    REASONS = (
        "queue_full", "kv_exhausted", "quarantine", "preempt_by_swap",
        "shutting_down", "canary_mismatch",
    )

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.recorded = 0

    def record(
        self, reason: str, tenant: str = ANON_TENANT,
        trace_id: str = "", request_id: str = "", detail: str = "",
        **queue_state,
    ) -> None:
        rec = {
            "ts": time.time(),
            "reason": reason,
            "tenant": tenant or ANON_TENANT,
            "trace_id": trace_id,
            "request_id": request_id,
            "detail": detail[:200],
            **{k: v for k, v in queue_state.items()},
        }
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1

    def snapshot(self, recent: int = 64) -> dict:
        with self._lock:
            return {
                "recorded": self.recorded,
                "capacity": self.capacity,
                "recent": [dict(r) for r in list(self._ring)[-recent:]],
            }


class SLOObserver:
    """The per-EngineLoop SLO bundle: bounded tenant accounting +
    declared targets + the admission audit ring."""

    def __init__(
        self,
        targets: Optional[dict] = None,
        top_k: Optional[int] = None,
        windows: Optional[tuple] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.targets = (
            targets
            if isinstance(targets, SLOTargets)
            else SLOTargets.from_dict(targets)
        )
        self.accounting = TenantAccounting(
            top_k=top_k if top_k is not None else tenant_top_k_from_env(),
            windows=windows or burn_windows_from_env(),
            targets=self.targets,
            clock=clock,
        )
        self.audit = AdmissionAudit()

    # thin delegates the engine loop calls on its hot paths.  The
    # canary prober's probes ride these same paths under the reserved
    # ``__canary__`` tenant — they are dropped HERE, at the accounting
    # boundary, so probes never appear in per-tenant series, burn
    # rates, /v1/tenants/usage totals or autoscale burn inputs.
    def note_first_token(self, tenant, ttft_s, queue_wait_s,
                         prompt_tokens) -> None:
        if tenant == CANARY_TENANT:
            return
        self.accounting.note_first_token(
            tenant, ttft_s, queue_wait_s, prompt_tokens
        )

    def note_tokens(self, tenant, n: int = 1) -> None:
        if tenant == CANARY_TENANT:
            return
        self.accounting.note_tokens(tenant, n)

    def note_shed(self, tenant, kv_exhausted: bool = False) -> None:
        if tenant == CANARY_TENANT:
            return
        self.accounting.note_shed(tenant, kv_exhausted=kv_exhausted)

    def note_preemption(self, tenant) -> None:
        if tenant == CANARY_TENANT:
            return
        self.accounting.note_preemption(tenant)

    def burn_rates(self, tenant: Optional[str] = None) -> dict:
        return self.accounting.burn_rates(tenant=tenant)

    def latency_fast_burn(self) -> float:
        """The worst pooled fast-window LATENCY burn (TTFT p95 /
        queue-wait p95 — the goodput floor is a capacity SLO, not a
        latency one).  This is the scheduler's prefill-budget feedback
        signal: >1.0 means interactive latency is spending its error
        budget faster than it accrues, so admission work per step
        should shrink.  0.0 with no declared latency targets."""
        fast = self.accounting.burn_rates().get("fast", {})
        return max(
            (
                v
                for k, v in fast.items()
                if k in ("ttft_p95", "queue_wait_p95")
            ),
            default=0.0,
        )

    def collect(self, c, lbl: dict) -> None:
        self.accounting.collect(c, lbl)

    def rollup(self) -> dict:
        return self.accounting.rollup()

    def summary(self) -> dict:
        """Aggregate + per-tenant latency/goodput snapshot (the
        reference bench's ``slo`` JSON block)."""
        acc = self.accounting
        rows = acc._snapshot_rows()
        agg = acc._snapshot(None)
        now = acc.clock()

        def qs(samples, q):
            return round(
                _quantile(
                    [v for ts, v in samples
                     if now - ts <= acc.fast_window], q,
                ), 6,
            )

        out = {
            "ttft_p50_seconds": qs(agg.ttft, 0.50),
            "ttft_p95_seconds": qs(agg.ttft, 0.95),
            "queue_wait_p50_seconds": qs(agg.queue_wait, 0.50),
            "queue_wait_p95_seconds": qs(agg.queue_wait, 0.95),
            "goodput_tokens_per_second": round(
                acc._goodput(agg, now), 2
            ),
            "tenants": {},
        }
        for snap in rows:
            if snap.tenant == OTHER_TENANT and not snap.requests:
                continue
            out["tenants"][snap.tenant] = {
                "requests": snap.requests,
                "prompt_tokens": snap.prompt_tokens,
                "generated_tokens": snap.generated_tokens,
                "ttft_p50_seconds": qs(snap.ttft, 0.50),
                "ttft_p95_seconds": qs(snap.ttft, 0.95),
                "goodput_tokens_per_second": round(
                    acc._goodput(snap, now), 2
                ),
            }
        return out

    def stats(self) -> dict:
        return {
            **self.accounting.totals(),
            "audit_recorded": self.audit.recorded,
            "targets": self.targets.to_dict(),
        }


def merge_rollups(rollups: list, top_k: int = 8) -> dict:
    """Merge per-engine rollups into the node's heartbeat ``tenants``
    block (the reference's, runner side): counters and goodput sum, burn
    rates and p95s take the worst, then the merged set is bounded again
    to ``top_k`` + the ``__other__`` fold (sums conserved)."""
    merged: dict[str, dict] = {}
    demotions = 0
    for roll in rollups:
        if not isinstance(roll, dict):
            continue
        demotions += int(roll.get("demotions", 0) or 0)
        for entry in roll.get("top", []) or []:
            t = entry.get("tenant")
            if not isinstance(t, str):
                continue
            cur = merged.get(t)
            if cur is None:
                merged[t] = {k: entry.get(k, 0) for k in TENANT_KEYS}
                merged[t]["tenant"] = t
                continue
            for k in _SUMMED:
                cur[k] = cur.get(k, 0) + entry.get(k, 0)
            for k in (
                "ttft_p95_seconds", "queue_wait_p95_seconds",
                "burn_rate_fast", "burn_rate_slow",
            ):
                cur[k] = max(cur.get(k, 0.0), entry.get(k, 0.0))
    ranked = sorted(
        merged.values(),
        key=lambda e: (-e.get("generated_tokens", 0),
                       -e.get("requests", 0), e["tenant"]),
    )
    # the fold bucket always merges last regardless of volume
    other = [e for e in ranked if e["tenant"] == OTHER_TENANT]
    ranked = [e for e in ranked if e["tenant"] != OTHER_TENANT]
    keep, overflow = ranked[:top_k], ranked[top_k:]
    fold = other[0] if other else None
    for e in overflow:
        if fold is None:
            fold = {k: 0 for k in TENANT_KEYS}
            fold["tenant"] = OTHER_TENANT
        for k in _SUMMED:
            fold[k] = fold.get(k, 0) + e.get(k, 0)
        for k in ("burn_rate_fast", "burn_rate_slow"):
            fold[k] = max(fold.get(k, 0.0), e.get(k, 0.0))
    if fold is not None:
        keep = keep + [fold]
    # tracked counts distinct tenant ids across the inputs
    return {"top": keep, "tracked": len(merged) - len(other),
            "demotions": demotions}


_SUMMED = ("prompt_tokens", "generated_tokens", "requests", "sheds",
           "kv_exhausted", "preemptions", "goodput_tps")

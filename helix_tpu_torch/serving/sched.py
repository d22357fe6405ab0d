"""The scheduler: SLO-tiered admission, per-tenant fairness, preemption policy.

The port's own copy of ``helix_tpu/serving/sched.py`` (standard library
only).  Every ordering / shedding / preemption *decision* of the engine
loop is delegated to one policy object:

- **Priority classes** — ``interactive`` / ``batch``, resolved from the
  ``X-Helix-Class`` request header with a per-profile default.  Dispatch
  is strict priority between classes: while interactive work is queued,
  no batch request admits ahead of it.
- **Per-tenant weighted fair queueing within a class** — deficit-style
  round robin keyed on the tenant id: each tenant carries a
  virtual-service counter (admitted prompt tokens normalized by its
  declared weight); the tenant with the least normalized attained
  service dispatches first, so under saturation admitted tokens
  converge to the weight ratio.  Weights live in the profile's ``slo:``
  block (``sched: {tenant_weights: {...}}``).  Bounded per-tenant
  queues turn one flooding tenant's overflow into *per-tenant* 429s
  instead of a global ``queue_full`` that starves everyone.
- **Adaptive chunked-prefill admission budget** — a per-step token
  budget for NEW prefill admissions.  The budget halves while the
  fast-window TTFT/queue-wait burn rate (``obs.slo``) exceeds 1.0 and
  grows back multiplicatively once the burn clears, floored so
  admission always makes progress.
- **Policy-driven victims** — ``preempt_order`` / ``pick_shed_victim``
  implement one ladder everywhere: lowest class first (batch before
  interactive), then the most-over-fair-share tenant (highest
  normalized attained service), then newest admission.

The FIFO policy is the default-off baseline: ``make_scheduler(None)``
returns a scheduler whose reorder is a no-op and whose victim pick is
the historical newest-first.

``helix_sched_*`` metric names and the scheduler-decision audit reasons
below are minted only by THIS module in the port (``tests/
test_torch_obs.py`` fails otherwise); the loop and the OpenAI surface
import the shared constants.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Optional

from helix_tpu_torch.obs.slo import ANON_TENANT

# priority classes, strict dispatch order (first = most urgent)
INTERACTIVE = "interactive"
BATCH = "batch"
SCHED_CLASSES = (INTERACTIVE, BATCH)

# the priority-class request header: set by clients, forwarded by the
# control plane at dispatch for AUTHENTICATED callers (anonymous traffic
# cannot self-select a class — it gets the profile default)
CLASS_HEADER = "X-Helix-Class"

# Scheduler-decision audit reasons (obs.slo.AdmissionAudit ring).  No
# other module of the port writes these literals: every other module
# imports the constants, so the audit vocabulary has one owner.
TENANT_QUEUE_FULL = "sched_tenant_queue_full"
PREEMPT_VICTIM = "sched_preempt_victim"
SHED_VICTIM = "sched_shed_victim"
SCHED_AUDIT_REASONS = (
    TENANT_QUEUE_FULL,
    PREEMPT_VICTIM,
    SHED_VICTIM,
)


def sanitize_class(raw, default: str = "") -> str:
    """The one class-header sanitiser: a known class name passes
    through, anything else (missing header, garbage) yields
    ``default``.  Mirrors ``obs.slo.sanitize_tenant`` — a hostile
    header must never mint a metric label value."""
    if isinstance(raw, str):
        v = raw.strip().lower()
        if v in SCHED_CLASSES:
            return v
    return default


def _env_str(name: str, default: str = "") -> str:
    v = os.environ.get(name, "")
    return v.strip() if v.strip() else default


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name, "")
    try:
        return int(v) if v else None
    except ValueError:
        return None


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Scheduler policy knobs, declared in the profile's ``slo:`` block
    (``sched: {...}``) with operator env overrides (``HELIX_SCHED_*``
    beat the profile, same contract as HELIX_SPEC_TOKENS)."""

    # "fifo" preserves the pre-scheduler ordering semantics exactly;
    # "wfq" turns on class tiers + per-tenant weighted fair queueing
    policy: str = "fifo"
    # class assumed when a request carries none
    default_class: str = INTERACTIVE
    # per-tenant DRR weights (share of admitted tokens under
    # saturation); tenants not listed get default_weight
    tenant_weights: dict = dataclasses.field(default_factory=dict)
    default_weight: float = 1.0
    # bounded per-tenant queues: one tenant may hold at most this many
    # queued requests before ITS submissions 429 (None = unbounded)
    max_tenant_queue_depth: Optional[int] = None
    # adaptive per-step prefill-admission token budget: the cap/initial
    # value (None = unbudgeted) and the floor the TTFT-burn feedback
    # loop may shrink it to
    prefill_budget_tokens: Optional[int] = None
    prefill_budget_min_tokens: int = 256
    # how often the budget controller re-reads the burn signal
    adapt_interval_seconds: float = 1.0

    @classmethod
    def from_profile(cls, slo_block: Optional[dict]) -> "SchedConfig":
        """Build from the profile's ``slo: {sched: {...}}`` sub-block,
        with ``HELIX_SCHED_*`` env overrides applied on top."""
        d = {}
        if isinstance(slo_block, dict):
            raw = slo_block.get("sched")
            if isinstance(raw, dict):
                d = raw
        policy = str(d.get("policy", "fifo")).strip().lower()
        policy = _env_str("HELIX_SCHED_POLICY", policy).strip().lower()
        if policy not in ("fifo", "wfq"):
            policy = "fifo"
        default_class = sanitize_class(
            _env_str(
                "HELIX_SCHED_DEFAULT_CLASS",
                str(d.get("default_class", INTERACTIVE)),
            ),
            INTERACTIVE,
        )
        weights = {}
        raw_w = d.get("tenant_weights")
        if isinstance(raw_w, dict):
            for t, w in raw_w.items():
                try:
                    f = float(w)
                except (TypeError, ValueError):
                    continue
                if f > 0 and isinstance(t, str):
                    weights[t] = f
        try:
            default_weight = max(
                1e-6, float(d.get("default_weight", 1.0))
            )
        except (TypeError, ValueError):
            default_weight = 1.0

        def _opt_int(key, env):
            v = _env_int(env)
            if v is None:
                raw = d.get(key)
                try:
                    v = int(raw) if raw is not None else None
                except (TypeError, ValueError):
                    v = None
            return v if v is None or v > 0 else None

        budget = _opt_int(
            "prefill_budget_tokens", "HELIX_SCHED_PREFILL_BUDGET"
        )
        budget_min = _opt_int(
            "prefill_budget_min_tokens", "HELIX_SCHED_PREFILL_BUDGET_MIN"
        ) or 256
        depth = _opt_int(
            "max_tenant_queue_depth", "HELIX_SCHED_TENANT_QUEUE_DEPTH"
        )
        return cls(
            policy=policy,
            default_class=default_class,
            tenant_weights=weights,
            default_weight=default_weight,
            max_tenant_queue_depth=depth,
            prefill_budget_tokens=budget,
            prefill_budget_min_tokens=budget_min,
        )


class FifoScheduler:
    """The default-off baseline: every decision matches the
    pre-scheduler behaviour (FIFO order, newest-first victims, no
    per-step budget) so existing ordering semantics — and every test
    that depends on them — are preserved.  Also the shared bookkeeping
    (per-class admission counters, metrics surface) the WFQ subclass
    builds on."""

    name = "fifo"
    #: True when the policy actually reorders/budgets (the loop skips
    #: the per-pass scheduler work entirely for the baseline)
    active = False

    def __init__(self, cfg: Optional[SchedConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or SchedConfig()
        self.clock = clock
        self._lock = threading.Lock()
        # per-class lifetime admission counters (on_admit hook)
        self.admitted_requests = {c: 0 for c in SCHED_CLASSES}
        self.admitted_tokens = {c: 0 for c in SCHED_CLASSES}
        # last-observed queue depth per class (stamped by reorder)
        self._class_depth = {c: 0 for c in SCHED_CLASSES}
        self.reorders = 0
        self.tenant_queue_sheds = 0   # per-tenant-bound 429s
        self.preempt_victims = {c: 0 for c in SCHED_CLASSES}
        self.shed_victims = {c: 0 for c in SCHED_CLASSES}
        # adaptive prefill budget state (None under the FIFO baseline,
        # whose prefill_budget() never applies one — the gauge must not
        # claim a budget the policy will never enforce)
        self._budget = (
            self.cfg.prefill_budget_tokens if self.active else None
        )
        self._budget_checked = 0.0
        self.budget_shrinks = 0
        self.budget_grows = 0

    # -- identity ------------------------------------------------------------

    def request_class(self, req) -> str:
        """The request's effective priority class (its stamped class,
        else the profile default)."""
        return sanitize_class(
            getattr(req, "sched_class", ""), self.cfg.default_class
        )

    def weight(self, tenant: str) -> float:
        return max(
            1e-6,
            float(
                self.cfg.tenant_weights.get(
                    tenant, self.cfg.default_weight
                )
            ),
        )

    # -- admission -----------------------------------------------------------

    def tenant_overflow(self, tenant: str, tenant_depth: int) -> bool:
        """Would admitting one more request from ``tenant`` exceed its
        bounded queue?  (The caller formats the 429 and owns the audit
        record; this only answers the policy question.)"""
        bound = self.cfg.max_tenant_queue_depth
        return bound is not None and tenant_depth >= bound

    def note_tenant_shed(self) -> None:
        self.tenant_queue_sheds += 1

    def note_admitted(self, req) -> None:
        """Admission-confirm hook (``Engine.on_admit``): charges the
        request's prefill cost to its class counters (and, in the WFQ
        subclass, its tenant's fair-share account)."""
        cls = self.request_class(req)
        cost = max(
            1,
            len(req.prompt_tokens) - getattr(req, "cached_tokens", 0),
        )
        with self._lock:
            self.admitted_requests[cls] += 1
            self.admitted_tokens[cls] += cost
            self._charge_locked(cls, getattr(req, "tenant", ANON_TENANT),
                                cost)

    def _charge_locked(self, cls: str, tenant: str, cost: int) -> None:
        pass   # fair-share accounting lives in the WFQ subclass

    # -- ordering ------------------------------------------------------------

    def reorder(self, waiting: list) -> None:
        """FIFO: leave the queue exactly as submitted.  Like the WFQ
        override, safe to call with a device step in flight (the async
        loop's pending-dispatch contract): reads only the wait queue."""

    # -- per-step prefill budget --------------------------------------------

    def prefill_budget(self, slo=None) -> Optional[int]:
        """Token budget for NEW prefill admissions this step (None =
        unbudgeted — the FIFO baseline and unconfigured WFQ)."""
        return None

    # -- victim selection ----------------------------------------------------

    def pick_shed_victim(self, cands: list):
        """The request to sacrifice when the loop must shed one of
        ``cands`` (oldest-admission-first order).  Baseline: newest —
        the historical hardcoded choice."""
        return cands[-1] if cands else None

    def preempt_order(self, cands: list) -> list:
        """Preference-ordered preemption victims for
        ``Engine.preempt_for_pressure``.  The baseline returns [] so
        the engine keeps its builtin newest-admission/largest-footprint
        pick."""
        return []

    def note_preempt_victim(self, req) -> None:
        self.preempt_victims[self.request_class(req)] += 1

    def note_shed_victim(self, req) -> None:
        self.shed_victims[self.request_class(req)] += 1

    # -- observability -------------------------------------------------------

    def collect(self, c, lbl: dict) -> None:
        """Scrape-time ``helix_sched_*`` samples: this module is the
        only emitter of the family."""
        c.gauge("helix_sched_wfq_enabled", 1 if self.active else 0, lbl)
        c.gauge(
            "helix_sched_prefill_budget_tokens", self._budget or 0, lbl
        )
        c.counter(
            "helix_sched_prefill_budget_shrinks_total",
            self.budget_shrinks, lbl,
        )
        c.counter(
            "helix_sched_prefill_budget_grows_total",
            self.budget_grows, lbl,
        )
        c.counter("helix_sched_reorders_total", self.reorders, lbl)
        c.counter(
            "helix_sched_tenant_queue_sheds_total",
            self.tenant_queue_sheds, lbl,
        )
        for cls in SCHED_CLASSES:
            cl = {**lbl, "class": cls}
            c.counter(
                "helix_sched_admitted_requests_total",
                self.admitted_requests[cls], cl,
            )
            c.counter(
                "helix_sched_admitted_tokens_total",
                self.admitted_tokens[cls], cl,
            )
            c.gauge(
                "helix_sched_queue_depth", self._class_depth[cls], cl
            )
            c.counter(
                "helix_sched_preempt_victims_total",
                self.preempt_victims[cls], cl,
            )
            c.counter(
                "helix_sched_shed_victims_total",
                self.shed_victims[cls], cl,
            )

    def stats(self) -> dict:
        with self._lock:
            return {
                "policy": self.name,
                "default_class": self.cfg.default_class,
                "admitted_requests": dict(self.admitted_requests),
                "admitted_tokens": dict(self.admitted_tokens),
                "queue_depth": dict(self._class_depth),
                "tenant_queue_sheds": self.tenant_queue_sheds,
                "preempt_victims": dict(self.preempt_victims),
                "shed_victims": dict(self.shed_victims),
                "prefill_budget_tokens": self._budget,
                "budget_shrinks": self.budget_shrinks,
                "budget_grows": self.budget_grows,
                "reorders": self.reorders,
            }


class WFQScheduler(FifoScheduler):
    """Strict-priority classes + per-tenant deficit-style weighted fair
    queueing.

    Fair-share state is one number per (class, tenant): the tenant's
    *normalized attained service* — admitted prompt tokens divided by
    its weight.  Ordering dispatches the tenant with the LEAST
    normalized service first (ties broken by queue arrival), which is
    the deficit-round-robin invariant expressed as a running account:
    every admission charges ``cost/weight``, so under saturation the
    per-tenant admitted-token ratio converges to the weight ratio.
    Charging happens only on CONFIRMED admissions (the ``Engine.on_admit``
    hook), so a reorder pass that the engine could not act on (resource
    block) leaves no trace and cannot under-serve anyone.

    A per-class *virtual floor* tracks the minimum normalized service
    among recently queued tenants; a newly active tenant starts at the
    floor instead of zero, so returning after an idle hour does not
    grant a monopoly burst, and the state stays prunable (entries at or
    below the floor with nothing queued carry no information).
    """

    name = "wfq"
    active = True

    # bound on the fair-share dict: beyond this, idle entries at the
    # floor are pruned (they are reconstructible as "floor" by
    # definition)
    _MAX_TENANTS = 4096

    def __init__(self, cfg: Optional[SchedConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(cfg, clock)
        # (class) -> tenant -> normalized attained service
        self._vsrv: dict = {c: {} for c in SCHED_CLASSES}
        self._vfloor = {c: 0.0 for c in SCHED_CLASSES}

    # -- fair-share account --------------------------------------------------

    def _charge_locked(self, cls: str, tenant: str, cost: int) -> None:
        vs = self._vsrv[cls]
        base = max(vs.get(tenant, 0.0), self._vfloor[cls])
        vs[tenant] = base + cost / self.weight(tenant)
        if len(vs) > self._MAX_TENANTS:
            floor = self._vfloor[cls]
            for t in [t for t, v in vs.items() if v <= floor]:
                del vs[t]

    def normalized_service(self, cls: str, tenant: str) -> float:
        with self._lock:
            return max(
                self._vsrv[cls].get(tenant, 0.0), self._vfloor[cls]
            )

    # -- ordering ------------------------------------------------------------

    def reorder(self, waiting: list) -> None:
        """Rewrite ``waiting`` in place into dispatch order: interactive
        before batch (strict priority), and within a class the DRR
        interleave — repeatedly take the head of the tenant with the
        least normalized attained service, charging a *simulated* copy
        of the account so one pass emits the whole fair interleave.
        FIFO order within a tenant is preserved.  Runs on the engine
        thread (the list's owner); an in-place slice assignment keeps
        concurrent GIL-atomic ``len()`` / ``list()`` readers safe.

        Pending-dispatch contract: the async engine loop may
        invoke this while a device step is still in flight, so a reorder
        pass must read ONLY the wait queue and the burn-rate accounts —
        never slot state, page occupancy or anything else the in-flight
        step's reconcile will rewrite.  The loop reconciles before the
        dispatch that acts on the new order, so the order can never be
        applied against a stale resource picture."""
        if len(waiting) < 2:
            # nothing to reorder, but keep the per-class depth gauges
            # live — a burst's stamp must not outlast the burst
            counts = {c: 0 for c in SCHED_CLASSES}
            for req in waiting:
                if not req.finished:
                    counts[self.request_class(req)] += 1
            with self._lock:
                self._class_depth = counts
            return
        groups: dict = {c: {} for c in SCHED_CLASSES}
        arrival: dict = {c: {} for c in SCHED_CLASSES}
        dropped = 0
        for i, req in enumerate(waiting):
            if req.finished:
                dropped += 1   # purged: a finished request owns no slot
                continue
            cls = self.request_class(req)
            t = getattr(req, "tenant", ANON_TENANT)
            groups[cls].setdefault(t, []).append(req)
            arrival[cls].setdefault(t, i)
        with self._lock:
            sim = {
                c: {
                    t: max(self._vsrv[c].get(t, 0.0), self._vfloor[c])
                    for t in groups[c]
                }
                for c in SCHED_CLASSES
            }
            # advance the virtual floor to the least service among
            # currently queued tenants: future arrivals start here
            for c in SCHED_CLASSES:
                if sim[c]:
                    self._vfloor[c] = max(
                        self._vfloor[c], min(sim[c].values())
                    )
            for c in SCHED_CLASSES:
                self._class_depth[c] = sum(
                    len(q) for q in groups[c].values()
                )
        order = []
        for cls in SCHED_CLASSES:
            queues = groups[cls]
            while queues:
                t = min(
                    queues,
                    key=lambda u: (sim[cls][u], arrival[cls][u]),
                )
                req = queues[t].pop(0)
                order.append(req)
                sim[cls][t] += max(1, len(req.prompt_tokens)) / (
                    self.weight(t)
                )
                if not queues[t]:
                    del queues[t]
        if dropped or any(
            a is not b for a, b in zip(order, waiting)
        ):
            waiting[:] = order
        self.reorders += 1

    # -- adaptive prefill budget --------------------------------------------

    def prefill_budget(self, slo=None) -> Optional[int]:
        """Current per-step prefill-admission token budget, adapted to
        the fast-window latency burn: >1.0 (the error budget is being
        spent faster than it accrues) halves the budget toward the
        floor; a healthy burn (<0.5) grows it back 1.25x toward the
        cap.  Re-evaluated at most once per ``adapt_interval_seconds``;
        with no declared SLO targets the burn reads 0.0 and the budget
        rests at the cap."""
        cap = self.cfg.prefill_budget_tokens
        if cap is None:
            return None
        now = self.clock()
        if (
            self._budget is not None
            and now - self._budget_checked < self.cfg.adapt_interval_seconds
        ):
            return self._budget
        self._budget_checked = now
        burn = 0.0
        if slo is not None:
            try:
                burn = slo.latency_fast_burn()
            except Exception:  # noqa: BLE001 — feedback is advisory
                burn = 0.0
        cur = self._budget if self._budget is not None else cap
        floor = min(cap, max(1, self.cfg.prefill_budget_min_tokens))
        if burn > 1.0:
            nxt = max(floor, cur // 2)
            if nxt < cur:
                self.budget_shrinks += 1
            cur = nxt
        elif burn < 0.5 and cur < cap:
            cur = min(cap, int(cur * 1.25) + 1)
            self.budget_grows += 1
        self._budget = cur
        return cur

    # -- victim selection ----------------------------------------------------

    def _victim_key(self, cands: list):
        """The one victim ladder: lowest class (batch sacrificed before
        interactive), then most-over-fair-share tenant (highest
        normalized attained service), then newest — judged by actual
        admission recency (submit time for never-admitted requests),
        NOT list position: preempt candidates arrive in slot order and
        shed candidates in dispatch order, neither of which says who is
        newest."""
        with self._lock:
            vsrv = {
                c: dict(self._vsrv[c]) for c in SCHED_CLASSES
            }
            floor = dict(self._vfloor)

        def key(pair):
            i, req = pair
            cls = self.request_class(req)
            t = getattr(req, "tenant", ANON_TENANT)
            over = max(vsrv[cls].get(t, 0.0), floor[cls])
            recency = (
                req.admitted_time
                if getattr(req, "admitted_time", None) is not None
                else getattr(req, "submit_time", 0.0)
            )
            # batch ranks above interactive as a victim
            return (1 if cls == BATCH else 0, over, recency, i)

        return key

    def pick_shed_victim(self, cands: list):
        if not cands:
            return None
        key = self._victim_key(cands)
        return max(enumerate(cands), key=key)[1]

    def preempt_order(self, cands: list) -> list:
        key = self._victim_key(cands)
        return [
            req
            for _i, req in sorted(
                enumerate(cands), key=key, reverse=True
            )
        ]


def make_scheduler(cfg=None) -> FifoScheduler:
    """Policy factory: a ``SchedConfig`` (or profile ``slo:`` dict, or
    None) to the scheduler the engine loop delegates to.  Anything
    short of an explicit ``policy: wfq`` yields the FIFO baseline."""
    if cfg is None:
        cfg = SchedConfig.from_profile(None)
    elif isinstance(cfg, dict):
        cfg = SchedConfig.from_profile(cfg)
    if cfg.policy == "wfq":
        return WFQScheduler(cfg)
    return FifoScheduler(cfg)

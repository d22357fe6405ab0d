"""Engine flight recorder + the shared saturation-summary schema.

The port's own copy of ``helix_tpu/obs/flight.py`` (standard library
only):

- :class:`FlightRecorder` — a bounded ring of per-step records fed by
  ``EngineLoop`` (host-side bookkeeping ONLY: every field is a plain-int
  delta of counters the engine already keeps, so nothing here touches
  the device).  A watchdog marks anomalous steps (wall time blowing
  past a multiple of the trailing p99, a quarantine firing, a
  zero-progress step with busy slots) and FREEZES a snapshot of the ring
  at that moment — the per-step batch composition leading up to an
  incident survives even after the ring wraps.  Served at
  ``GET /v1/debug/flight`` on the runner.  The loop's
  ``device_idle_ratio()`` and ``padding_ratio()`` read its window.
- ``SATURATION_KEYS`` — the one schema for the compact saturation
  summary a runner reports: the same tuple, in the same order, as the
  reference's, so a torch runner's summary carries the keys a JAX
  runner's does.
- :class:`RateTracker` — windowed rate over a monotonically increasing
  counter (goodput tokens/s for /metrics and the saturation summary).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

# The saturation-summary schema: a runner reports exactly these keys,
# in this order (the reference's tuple, key for key).
SATURATION_KEYS = (
    "kv_occupancy",      # used KV pages / allocatable pages, 0..1
    "slots_busy",        # occupied decode slots (all engines)
    "slots_total",       # decode-slot capacity (all engines)
    "queue_depth",       # requests waiting for a slot (inbox + engine)
    "tokens_per_sec",    # generated tokens/s over the trailing window
    "prefix_hit_rate",   # prefix-cache page hit rate, 0..1
    "spec_acceptance_ratio",  # speculative drafts accepted/drafted, 0..1
    "kv_host_occupancy",  # host KV tier bytes used / budget, 0..1
    "preempted_requests",  # decoders swapped out, parked for resume
    "prefill_budget_tokens",  # scheduler prefill-admission budget/step
    "adapters_resident",  # multi-LoRA adapters in the device pool
    "kv_cold_pages",     # demoted cold-middle KV pages host-resident
)


class RateTracker:
    """Windowed rate of a monotonically increasing counter.

    ``rate(value)`` banks a ``(now, value)`` sample (throttled to one
    per ``min_sample_interval`` so a per-step caller stays bounded),
    prunes until the anchor is the newest sample older than the window,
    and returns the average rate from the anchor to now.  The engine
    loop feeds it every step, so while the engine is working the anchor
    stays within ~one window of now and the value is a true trailing
    rate; across pure idle stretches the counter delta is zero and the
    rate correctly reads 0 regardless of anchor age.  Thread-safe:
    the engine-loop, heartbeat, and /metrics scrape threads share one
    tracker per engine loop."""

    def __init__(
        self,
        window_seconds: float = 60.0,
        min_sample_interval: float = 1.0,
    ):
        self.window = window_seconds
        self.min_interval = min_sample_interval
        self._samples: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def rate(self, value: float, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            if (
                not self._samples
                or now - self._samples[-1][0] >= self.min_interval
            ):
                self._samples.append((now, float(value)))
            while (
                len(self._samples) > 1
                and now - self._samples[1][0] >= self.window
            ):
                self._samples.popleft()
            t0, v0 = self._samples[0]
            dt = now - t0
            if dt <= 0.0:
                return 0.0
            return max(0.0, (float(value) - v0) / dt)


class FlightRecorder:
    """Bounded per-step flight ring with an anomaly watchdog.

    ``record_step`` is called once per engine step from the engine-loop
    thread with plain host-side numbers; reads (``snapshot``) come from
    HTTP threads, so all state is guarded by one lock.  Step records are
    plain dicts (JSON-ready as-is).

    Anomaly detection, checked per step:

    - ``slow_step``: wall time > ``slow_factor`` x the trailing p99 of
      recent successful steps (after ``min_samples`` are banked, and
      only above ``min_step_seconds`` so tiny-engine jitter can't trip
      it);
    - ``zero_progress``: busy decode slots but zero tokens generated and
      zero prefill progress — decode must always emit, so this is a
      wedged engine;
    - explicit anomalies handed in by the caller (``step_failure``,
      ``quarantine``).

    On any anomaly the current ring tail is FROZEN into a bounded
    anomaly list: the batch composition of the steps preceding the
    incident stays retrievable after the live ring has wrapped."""

    def __init__(
        self,
        capacity: int = 512,
        freeze_steps: int = 64,
        max_anomalies: int = 8,
        slow_factor: float = 4.0,
        min_step_seconds: float = 0.25,
        min_samples: int = 32,
    ):
        self.capacity = capacity
        self.freeze_steps = freeze_steps
        self.slow_factor = slow_factor
        self.min_step_seconds = min_step_seconds
        self.min_samples = min_samples
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._durations: collections.deque = collections.deque(maxlen=256)
        self._anomalies: collections.deque = collections.deque(
            maxlen=max_anomalies
        )
        self._lock = threading.Lock()
        self.steps_recorded = 0
        self.anomalies_total = 0

    # -- write side (engine-loop thread) -----------------------------------

    def _trailing_p99_locked(self) -> float:
        if not self._durations:
            return 0.0
        s = sorted(self._durations)
        return s[min(len(s) - 1, int(len(s) * 0.99))]

    def record_step(self, rec: dict) -> Optional[str]:
        """Append one step record; returns the anomaly reason when the
        watchdog fired (the record itself is annotated + frozen)."""
        with self._lock:
            reason = rec.get("anomaly")
            duration = float(rec.get("duration", 0.0))
            if reason is None:
                if (
                    len(self._durations) >= self.min_samples
                    and duration > self.min_step_seconds
                    and duration
                    > self.slow_factor * self._trailing_p99_locked()
                ):
                    reason = "slow_step"
                elif (
                    rec.get("slots_busy", 0) > 0
                    and rec.get("generated_tokens", 0) == 0
                    and rec.get("prefill_tokens", 0) == 0
                ):
                    reason = "zero_progress"
                if reason is not None:
                    rec["anomaly"] = reason
            else:
                rec["anomaly"] = reason
            if rec.get("anomaly") is None:
                # only clean steps feed the p99 baseline: one incident
                # must not raise the bar for detecting the next one
                self._durations.append(duration)
            self._ring.append(rec)
            self.steps_recorded += 1
            if reason is not None:
                self._freeze_locked(reason, rec)
            return reason

    def reset_baseline(self) -> None:
        """Drop the banked step-duration samples.  First steps that
        build kernels record as 'clean' multi-second durations and would
        inflate the trailing p99 until the window turns over; callers
        that know a build wave just ended (warmup, profile apply) reset
        so the watchdog re-learns the true serving cadence."""
        with self._lock:
            self._durations.clear()

    @property
    def recorded(self) -> int:
        """Step records ever made (``steps_recorded``): a caller's window
        marker."""
        return self.steps_recorded

    def records(self, recent: int = 256) -> list:
        """Copies of the last ``recent`` step records, oldest first."""
        with self._lock:
            return [dict(r) for r in list(self._ring)[-recent:]]

    def note_anomaly(self, reason: str, **attrs) -> None:
        """Freeze a snapshot for an event that is not itself a step
        (a quarantine eviction decided between steps)."""
        with self._lock:
            rec = {"ts": time.time(), "anomaly": reason, **attrs}
            self._freeze_locked(reason, rec)

    def _freeze_locked(self, reason: str, rec: dict) -> None:
        self.anomalies_total += 1
        self._anomalies.append(
            {
                "reason": reason,
                "ts": rec.get("ts", time.time()),
                "step": rec.get("step"),
                "record": dict(rec),
                # the frozen tail: batch composition of the steps
                # PRECEDING the anomaly (copies — immutable from here)
                "steps": [dict(r) for r in list(self._ring)[-self.freeze_steps:]],
            }
        )

    # -- read side (HTTP threads) ------------------------------------------

    def window_ratio(
        self, num_key: str, den_keys: tuple, recent: int = 256
    ) -> float:
        """Sum of ``num_key`` over the last ``recent`` step records
        divided by the summed ``den_keys`` (0.0 on an empty window).

        Feeds ratio gauges computed over the flight window rather than
        process lifetime — e.g. ``helix_prefill_padding_ratio`` =
        padding / (padding + useful prefill) over recent steps, so a
        config change shows up in the gauge instead of being averaged
        away by history."""
        with self._lock:
            recs = list(self._ring)[-recent:]
        num = float(sum(r.get(num_key, 0) or 0 for r in recs))
        den = float(
            sum(r.get(k, 0) or 0 for r in recs for k in den_keys)
        )
        return num / den if den > 0 else 0.0

    def snapshot(self, recent: int = 64) -> dict:
        with self._lock:
            return {
                "steps_recorded": self.steps_recorded,
                "anomalies_total": self.anomalies_total,
                "trailing_p99_seconds": self._trailing_p99_locked(),
                "config": {
                    "capacity": self.capacity,
                    "freeze_steps": self.freeze_steps,
                    "slow_factor": self.slow_factor,
                    "min_step_seconds": self.min_step_seconds,
                    "min_samples": self.min_samples,
                },
                "recent": [dict(r) for r in list(self._ring)[-recent:]],
                "anomalies": [
                    {
                        "reason": a["reason"],
                        "ts": a["ts"],
                        "step": a["step"],
                        "record": dict(a["record"]),
                        "steps": [dict(r) for r in a["steps"]],
                    }
                    for a in self._anomalies
                ],
            }

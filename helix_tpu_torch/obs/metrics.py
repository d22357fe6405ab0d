"""Shared metrics registry: counters, gauges, fixed-bucket histograms.

The port's own copy of ``helix_tpu/obs/metrics.py`` (standard library
only; the port imports nothing from the JAX package).  Every ``/metrics``
surface of the port renders through this module: Prometheus text
exposition is built HERE and nowhere else in ``helix_tpu_torch``
(``tests/test_torch_obs.py`` fails on exposition built anywhere else).
Two usage shapes:

- **Registered metrics** (``registry.counter(...)`` etc.): owned by the
  registry, rendered on every scrape.
- **Scrape-time collectors** (``registry.register_callback(fn)``): the
  callback receives a :class:`Collector` and emits point-in-time samples
  from live objects (per-model engine gauges, standalone histograms owned
  by an ``EngineLoop``), so per-model labels attach at scrape time
  without the engine knowing about HTTP servers.

Same names, buckets, value formatting and text as the reference, so one
sample set renders byte-identical in both packages.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Iterable, Optional, Sequence

# the naming contract: lowercase snake_case under the helix_ prefix.
# the reference's tools/lint_metrics.py additionally rejects
# non-base-unit suffixes (_ms, _cnt, ...).
METRIC_NAME_RE = re.compile(r"helix_[a-z0-9_]+")

# fixed latency buckets (seconds).  One shared ladder keeps TTFT /
# queue-wait / dispatch-attempt histograms comparable across planes; the
# FAST ladder covers per-step and inter-token scales.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
FAST_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)


def validate_metric_name(name: str) -> str:
    if not METRIC_NAME_RE.fullmatch(name):
        raise ValueError(
            f"metric name {name!r} violates the helix naming contract "
            "helix_[a-z0-9_]+ (lowercase snake_case; base-unit suffixes "
            "_total/_seconds/_bytes)"
        )
    return name


def escape_label_value(v: str) -> str:
    """Prometheus exposition-format label escaping — label values arrive
    verbatim from runner ids / model names, and one stray quote would
    invalidate the whole scrape."""
    return (
        v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def format_value(v) -> str:
    """Sample value formatting: integral values render without a decimal
    point (tests and dashboards compare counter values textually)."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return f"{f:.10g}"


def format_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(str(v))}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


def render_sample(name: str, labels: Optional[dict], value) -> str:
    return f"{name}{format_labels(labels)} {format_value(value)}"


# ---------------------------------------------------------------------------
# metric families
# ---------------------------------------------------------------------------


class _Metric:
    """One family: a name, a type, and labelled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        validate_metric_name(name)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict = {}
        self._lock = threading.Lock()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labelvalues)}"
            )
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call "
                ".labels(...) first"
            )
        with self._lock:
            child = self._children.get(())
            if child is None:
                child = self._children[()] = self._new_child()
            return child

    def samples(self) -> Iterable[tuple]:
        """Yields (suffix, labels_dict, value) for every child."""
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            base = dict(zip(self.labelnames, key))
            for suffix, extra, value in child.samples():
                merged = dict(base)
                merged.update(extra)
                yield suffix, merged, value


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n

    def samples(self):
        yield "", {}, self.value


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, n=1):
        self._default_child().inc(n)

    @property
    def value(self):
        return self._default_child().value


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = v

    def inc(self, n=1):
        self.value += n

    def dec(self, n=1):
        self.value -= n

    def samples(self):
        yield "", {}, self.value


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v):
        self._default_child().set(v)

    def inc(self, n=1):
        self._default_child().inc(n)

    def dec(self, n=1):
        self._default_child().dec(n)

    @property
    def value(self):
        return self._default_child().value


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)   # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, v):
        v = float(v)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                break

    def samples(self):
        # ints are GIL-atomic but the tuple of reads is not; a scrape
        # racing an observe may be off by one observation — acceptable
        # for monitoring, never corrupt
        cum = 0
        for b, c in zip(self.buckets, list(self.counts)):
            cum += c
            yield "_bucket", {"le": format_value(b)}, cum
        yield "_bucket", {"le": "+Inf"}, self.count
        yield "_sum", {}, self.sum
        yield "_count", {}, self.count


class Histogram(_Metric):
    """Fixed-bucket histogram.  ``le`` labels are cumulative per the
    exposition format; bucket bounds are frozen at construction so every
    scrape of every process slices latency identically."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        if list(buckets) != sorted(buckets):
            raise ValueError(f"{name}: buckets must be sorted")
        self.buckets = tuple(float(b) for b in buckets)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v):
        self._default_child().observe(v)

    @property
    def count(self):
        return self._default_child().count

    @property
    def sum(self):
        return self._default_child().sum


_KIND_CLASSES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# ---------------------------------------------------------------------------
# scrape-time collection
# ---------------------------------------------------------------------------


class Collector:
    """Scrape-time sample buffer handed to registry callbacks.

    Callbacks read live objects (router breaker snapshots, engine
    counters) and emit samples; the registry renders everything in one
    pass with correct ``# TYPE`` grouping."""

    def __init__(self):
        # name -> [kind, help, [(suffix, labels, value), ...]]
        self.families: dict = {}

    def _family(self, name: str, kind: str, help: str):
        validate_metric_name(name)
        fam = self.families.get(name)
        if fam is None:
            fam = self.families[name] = [kind, help, []]
        elif fam[0] != kind:
            raise ValueError(
                f"metric {name} collected as both {fam[0]} and {kind}"
            )
        return fam

    def counter(self, name: str, value, labels: Optional[dict] = None,
                help: str = ""):
        self._family(name, "counter", help)[2].append(
            ("", dict(labels or {}), value)
        )

    def gauge(self, name: str, value, labels: Optional[dict] = None,
              help: str = ""):
        self._family(name, "gauge", help)[2].append(
            ("", dict(labels or {}), value)
        )

    def metric(self, m: _Metric, labels: Optional[dict] = None):
        """Fold a standalone (unregistered) metric family in, merging
        ``labels`` into every sample — how an EngineLoop's private
        histograms pick up their ``model`` label at scrape time."""
        fam = self._family(m.name, m.kind, m.help)
        extra = dict(labels or {})
        for suffix, sample_labels, value in m.samples():
            merged = dict(extra)
            merged.update(sample_labels)
            fam[2].append((suffix, merged, value))


class Registry:
    """A set of metric families + scrape-time callbacks, rendered as one
    Prometheus text document."""

    def __init__(self):
        self._metrics: dict = {}
        self._callbacks: list = []
        self._lock = threading.Lock()

    def _get_or_create(self, kind: str, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(
                        f"metric {name} already registered as {m.kind}"
                    )
                return m
            m = _KIND_CLASSES[kind](name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(
            "counter", name, help, labelnames=labelnames
        )

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create("gauge", name, help, labelnames=labelnames)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS,
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._get_or_create(
            "histogram", name, help, buckets=buckets, labelnames=labelnames
        )

    def register_callback(self, fn: Callable[[Collector], None]) -> None:
        with self._lock:
            self._callbacks.append(fn)

    def render(self) -> str:
        """The Prometheus text exposition for everything this registry
        knows about — registered families first, then callback samples.
        May run off the event loop (callbacks can take locks)."""
        col = Collector()
        with self._lock:
            metrics = list(self._metrics.values())
            callbacks = list(self._callbacks)
        for m in metrics:
            col.metric(m)
        for cb in callbacks:
            cb(col)
        lines: list = []
        for name, (kind, help, samples) in col.families.items():
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for suffix, labels, value in samples:
                lines.append(render_sample(name + suffix, labels, value))
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# pre-wired bundles
# ---------------------------------------------------------------------------


class EngineLoopObs:
    """The latency surface one EngineLoop feeds (APEX-style per-phase
    breakdown: where did each millisecond of a request go?).  Standalone
    families — the runner's /metrics folds them in with a ``model`` label
    via ``Collector.metric`` at scrape time."""

    def __init__(self):
        self.queue_wait = Histogram(
            "helix_queue_wait_seconds",
            "Submit to slot admission (queueing + page waits)",
        )
        self.ttft = Histogram(
            "helix_ttft_seconds",
            "Submit to first token (queue + prefill)",
        )
        self.inter_token = Histogram(
            "helix_inter_token_seconds",
            "Gap between consecutive emitted tokens of one request",
            buckets=FAST_BUCKETS,
        )
        self.step_seconds = Histogram(
            "helix_engine_step_seconds",
            "Engine step wall time (host view, includes device sync)",
            buckets=FAST_BUCKETS,
        )
        # async-loop time split: where each step's host
        # milliseconds go — schedule/plan/dispatch vs token emission.
        # Under the pipelined loop both phases overlap device execution;
        # the flight recorder's idle_gap_s field (and the
        # helix_device_idle_ratio gauge) shows whether they still leave
        # the device waiting.
        self.host_build = Histogram(
            "helix_step_host_build_seconds",
            "Host-side step build time (scheduling + plan packing + "
            "metadata upload + dispatch) per engine step",
            buckets=FAST_BUCKETS,
        )
        self.emit_seconds = Histogram(
            "helix_step_emit_seconds",
            "Token emission time (subscriber callbacks + per-tenant SLO "
            "accounting) per step batch",
            buckets=FAST_BUCKETS,
        )

    def collect(self, c: Collector, labels: Optional[dict] = None) -> None:
        for m in (
            self.queue_wait, self.ttft, self.inter_token,
            self.step_seconds, self.host_build, self.emit_seconds,
        ):
            c.metric(m, labels)

"""Deterministic fault injection for engine steps, the host KV tier and
snapshot ships.

The port's own copy of the parts of ``helix_tpu/testing/faults.py`` that
its serving path calls: the ``engine_step`` point (the engine loop's
``_fault_gate`` before every dispatch), the ``host_pool`` point
(``HostPagePool`` spills and restores), the ``transfer`` point
(``migration.PeerShipper``) and the ``saturation`` point (the node
agent's heartbeat summary).  Every hook is a no-op unless an injector is
armed, programmatically (``arm``) or through the ``HELIX_FAULTS``
environment variable.

Rule shapes (dicts, JSON-friendly for the env var)::

    {"point": "engine_step", "request_id_contains": "poison"}
    {"point": "engine_step", "engine": "m", "on_step": 5, "times": 1}
    {"point": "engine_step", "mode": "slow", "delay": 0.2}

    {"point": "host_pool", "op": "restore", "mode": "slow", "delay": 0.2}
    {"point": "host_pool", "op": "restore", "mode": "corrupt", "times": 1}
    {"point": "host_pool", "op": "spill", "mode": "alloc_fail", "p": 0.5}
    {"point": "transfer", "peer": "r2", "mode": "drop", "times": 1}
    {"point": "transfer", "peer": "*", "mode": "corrupt", "page": 3}
    {"point": "transfer", "mode": "partial", "times": 1}
    {"point": "saturation", "runner": "r1", "set": {"kv_occupancy": 0.99}}

``engine_step`` raises ``FaultInjected`` when the rule matches the step
(``request_id_contains``: a poisoned request, failing every step that
schedules it; ``on_step``: one step number); ``mode: slow`` sleeps
``delay`` seconds instead (a straggling device call).  ``host_pool``
modes: ``slow`` models a saturated host-device link,
``corrupt`` flips a byte the checksum must catch, ``alloc_fail`` a spill
that host-RAM pressure rejects.  ``transfer`` modes: ``drop`` an
unreachable peer, ``slow`` a saturated link, ``corrupt`` one flipped byte
in one page (the importer's checksum must reject it), ``partial`` a
truncated page list (its coverage check must reject it).
``saturation`` sets keys of one runner's heartbeat saturation summary
(the agent keeps only ``SATURATION_KEYS``), so routing under saturation
is testable without filling a pool.

``times`` caps how often a rule fires (omit for unlimited); ``p`` gates
each match through one seeded ``random.Random`` (omit for always), so a
fixed seed and call order reproduce the same faults.

Env form: ``HELIX_FAULTS='{"seed": 42, "rules": [...]}'``.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Optional

ENV_VAR = "HELIX_FAULTS"


class FaultInjected(RuntimeError):
    """Raised by an armed ``engine_step`` rule."""


class FaultInjector:
    def __init__(self, seed: int = 0, rules: Optional[list] = None):
        self._lock = threading.Lock()
        self.reset(seed=seed, rules=rules)

    def reset(self, seed: int = 0, rules: Optional[list] = None) -> None:
        with self._lock:
            self.seed = seed
            self.rng = random.Random(seed)
            self.rules = [dict(r) for r in (rules or [])]
            self.fired: dict[int, int] = {}   # rule index -> fire count

    def _try_fire(self, idx: int, rule: dict) -> bool:
        """The ``times`` cap and the seeded ``p`` gate (lock held)."""
        times = rule.get("times")
        if times is not None and self.fired.get(idx, 0) >= times:
            return False
        p = rule.get("p")
        if p is not None and self.rng.random() >= float(p):
            return False
        self.fired[idx] = self.fired.get(idx, 0) + 1
        return True

    def _match(self, point: str, field: str, value: str) -> Optional[dict]:
        with self._lock:
            for idx, rule in enumerate(self.rules):
                if rule.get("point") != point:
                    continue
                if rule.get(field, "*") not in ("*", value):
                    continue
                if self._try_fire(idx, rule):
                    return rule
        return None

    def maybe_fail_step(
        self, engine_name: str, step_no: int, request_ids: list
    ) -> None:
        """Raise ``FaultInjected`` if an ``engine_step`` rule matches this
        step; ``mode: "slow"`` rules sleep ``delay`` seconds instead.
        ``request_ids`` are the requests the step would touch (slots +
        waiting), so a ``request_id_contains`` rule models a poisoned
        request: the step fails every time that request is scheduled and
        recovers the moment it is evicted."""
        slow = 0.0
        raise_msg = None
        with self._lock:
            for idx, rule in enumerate(self.rules):
                if rule.get("point") != "engine_step":
                    continue
                if rule.get("engine", "*") not in ("*", engine_name):
                    continue
                frag = rule.get("request_id_contains")
                if frag is not None and not any(
                    frag in rid for rid in request_ids
                ):
                    continue
                on_step = rule.get("on_step")
                if on_step is not None and step_no != on_step:
                    continue
                if not self._try_fire(idx, rule):
                    continue
                if rule.get("mode") == "slow":
                    slow += float(rule.get("delay", 0.1))
                    continue
                raise_msg = (
                    f"injected engine-step fault (engine={engine_name}, "
                    f"step={step_no}, rule={idx})"
                )
                break
        if slow > 0:
            # outside the lock; a slow rule that consumed its `times`
            # budget still slows the step even when a raising rule fired
            time.sleep(slow)
        if raise_msg is not None:
            raise FaultInjected(raise_msg)

    def host_pool_fault(self, op: str) -> Optional[dict]:
        """The fault for one host-pool operation, or None.  ``op`` is
        ``"spill"`` (``HostPagePool.put``) or ``"restore"`` (get,
        prefetch, take_restored)."""
        rule = self._match("host_pool", "op", op)
        if rule is None:
            return None
        return {"mode": rule.get("mode", "slow"),
                "delay": float(rule.get("delay", 0.05))}

    def transfer_fault(self, peer_id: str) -> Optional[dict]:
        """The fault for one snapshot ship attempt to ``peer_id``, or
        None."""
        rule = self._match("transfer", "peer", peer_id)
        if rule is None:
            return None
        return {"mode": rule.get("mode", "drop"),
                "delay": float(rule.get("delay", 0.05)),
                "page": int(rule.get("page", 0))}

    def saturation_override(self, runner_id: str) -> Optional[dict]:
        """Keys to set in ``runner_id``'s heartbeat saturation summary,
        or None."""
        rule = self._match("saturation", "runner", runner_id)
        if rule is None:
            return None
        over = rule.get("set")
        return dict(over) if isinstance(over, dict) else None


_INSTANCE: Optional[FaultInjector] = None
_ENV_CHECKED = False


def arm(seed: int = 0, rules: Optional[list] = None) -> FaultInjector:
    """Install (or re-seed) the global injector; returns it."""
    global _INSTANCE
    if _INSTANCE is None:
        _INSTANCE = FaultInjector(seed=seed, rules=rules)
    else:
        _INSTANCE.reset(seed=seed, rules=rules)
    return _INSTANCE


def disarm() -> None:
    """Remove the global injector: every hook is a no-op again."""
    global _INSTANCE, _ENV_CHECKED
    _INSTANCE = None
    _ENV_CHECKED = True   # no resurrection from the env after a disarm


def active() -> Optional[FaultInjector]:
    """The armed injector, or None.  Reads ``HELIX_FAULTS`` once,
    lazily."""
    global _INSTANCE, _ENV_CHECKED
    if _INSTANCE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        spec = os.environ.get(ENV_VAR)
        if spec:
            doc = json.loads(spec)
            _INSTANCE = FaultInjector(seed=int(doc.get("seed", 0)),
                                      rules=doc.get("rules", []))
    return _INSTANCE

"""Deterministic fault injection for the host KV tier and snapshot ships.

The port's own copy of the parts of ``helix_tpu/testing/faults.py`` that
its serving path calls: the ``host_pool`` point (``HostPagePool`` spills
and restores) and the ``transfer`` point (``migration.PeerShipper``).
Every hook is a no-op unless an injector is armed, programmatically
(``arm``) or through the ``HELIX_FAULTS`` environment variable.

Rule shapes (dicts, JSON-friendly for the env var)::

    {"point": "host_pool", "op": "restore", "mode": "slow", "delay": 0.2}
    {"point": "host_pool", "op": "restore", "mode": "corrupt", "times": 1}
    {"point": "host_pool", "op": "spill", "mode": "alloc_fail", "p": 0.5}
    {"point": "transfer", "peer": "r2", "mode": "drop", "times": 1}
    {"point": "transfer", "peer": "*", "mode": "corrupt", "page": 3}
    {"point": "transfer", "mode": "partial", "times": 1}

``host_pool`` modes: ``slow`` models a saturated host-device link,
``corrupt`` flips a byte the checksum must catch, ``alloc_fail`` a spill
that host-RAM pressure rejects.  ``transfer`` modes: ``drop`` an
unreachable peer, ``slow`` a saturated link, ``corrupt`` one flipped byte
in one page (the importer's checksum must reject it), ``partial`` a
truncated page list (its coverage check must reject it).

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
from typing import Optional

ENV_VAR = "HELIX_FAULTS"


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

"""The port's runner-side SLO accounting (``obs/slo.py``) against the JAX
package's.

The same note sequences (first tokens, tokens, sheds, preemptions over
more tenants than the top-K, on one scripted clock spanning both burn
windows) go through both packages' ``SLOObserver``s and give equal
``burn_rates`` (pooled and per tenant), ``latency_fast_burn``,
``rollup``, ``summary``, ``stats`` and rendered ``/metrics`` text, with
the same folding into ``__other__``.  The identity helpers
(``sanitize_tenant``, ``resolve_tenant``), the env knobs, ``SLOTargets``
and the admission audit agree too.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from helix_tpu.obs import metrics as jmetrics
from helix_tpu.obs import slo as jslo
from helix_tpu_torch.obs import metrics as tmetrics
from helix_tpu_torch.obs import slo as tslo

TARGETS = {"ttft_p95_seconds": 2.0, "queue_wait_p95_seconds": 1.0,
           "goodput_floor_tps": 50}


class _Clock:
    def __init__(self, t0: float = 10_000.0):
        self.now = t0

    def __call__(self) -> float:
        return self.now


def _pair(targets, top_k=3, windows=(300.0, 3600.0)):
    clock = _Clock()
    j = jslo.SLOObserver(targets=targets, top_k=top_k, windows=windows,
                         clock=clock)
    t = tslo.SLOObserver(targets=targets, top_k=top_k, windows=windows,
                         clock=clock)
    return j, t, clock


def _ops(seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    tenants = [f"tenant-{i}" for i in range(6)] + [tslo.CANARY_TENANT,
                                                   tslo.ANON_TENANT]
    out = []
    for _ in range(n):
        kind = rng.choice(["first", "tokens", "shed", "preempt", "tick"],
                          p=[0.3, 0.4, 0.1, 0.05, 0.15])
        ten = tenants[int(rng.integers(0, len(tenants)))]
        if kind == "first":
            out.append(("first", ten, float(rng.exponential(1.5)),
                        float(rng.exponential(0.8)),
                        int(rng.integers(1, 3000))))
        elif kind == "tokens":
            out.append(("tokens", ten, int(rng.integers(1, 40))))
        elif kind == "shed":
            out.append(("shed", ten, bool(rng.integers(0, 2))))
        elif kind == "preempt":
            out.append(("preempt", ten))
        else:
            out.append(("tick", float(rng.choice([0.2, 1.5, 45.0, 400.0]))))
    return out


def _apply(obs, op) -> None:
    kind = op[0]
    if kind == "first":
        obs.note_first_token(*op[1:])
    elif kind == "tokens":
        obs.note_tokens(op[1], op[2])
    elif kind == "shed":
        obs.note_shed(op[1], kv_exhausted=op[2])
    elif kind == "preempt":
        obs.note_preemption(op[1])


def _render(obs, mod) -> str:
    reg = mod.Registry()
    reg.register_callback(lambda c: obs.collect(c, {"model": "m"}))
    return reg.render()


def _compare(j, t) -> None:
    assert t.burn_rates() == j.burn_rates()
    assert t.latency_fast_burn() == j.latency_fast_burn()
    for ten in [f"tenant-{i}" for i in range(6)] + [tslo.OTHER_TENANT,
                                                    "unknown"]:
        assert t.burn_rates(ten) == j.burn_rates(ten), ten
    assert t.rollup() == j.rollup()
    assert t.summary() == j.summary()
    assert t.stats() == j.stats()
    assert _render(t, tmetrics) == _render(j, jmetrics)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("targets", [TARGETS, {"ttft_p95_seconds": 0.5},
                                     None])
def test_note_sequences_match_reference(seed, targets):
    j, t, clock = _pair(targets)
    for k, op in enumerate(_ops(seed)):
        if op[0] == "tick":
            clock.now += op[1]
        else:
            _apply(j, op)
            _apply(t, op)
        if k % 97 == 0:
            _compare(j, t)
    _compare(j, t)
    roll = t.rollup()
    assert roll["demotions"] > 0 and roll["tracked"] == 3
    assert all(set(e) == {"tenant", *tslo.TENANT_KEYS}
               for e in roll["top"])
    # the canary lane never reaches the accounting
    assert tslo.CANARY_TENANT not in t.summary()["tenants"]


@settings(max_examples=40, deadline=None)
@given(ops=st.lists(st.one_of(
    st.tuples(st.just("first"), st.sampled_from(("a", "b", "c", "d")),
              st.floats(0.0, 5.0), st.floats(0.0, 3.0),
              st.integers(1, 500)),
    st.tuples(st.just("tokens"), st.sampled_from(("a", "b", "c", "d")),
              st.integers(1, 64)),
    st.tuples(st.just("shed"), st.sampled_from(("a", "b", "c", "d")),
              st.booleans()),
    st.tuples(st.just("tick"), st.floats(0.0, 700.0)),
), max_size=80), top_k=st.integers(1, 4))
def test_hypothesis_notes_match_reference(ops, top_k):
    j, t, clock = _pair(TARGETS, top_k=top_k, windows=(120.0, 900.0))
    for op in ops:
        if op[0] == "tick":
            clock.now += op[1]
        else:
            _apply(j, op)
            _apply(t, op)
    _compare(j, t)


def test_latency_burn_passes_one_on_violations():
    """The prefill budget's feedback signal: a violating share above the
    5% budget reads above 1 in both packages."""
    j, t, clock = _pair({"ttft_p95_seconds": 1.0})
    for i in range(20):
        for obs in (j, t):
            obs.note_first_token("a", 3.0 if i % 4 == 0 else 0.2, 0.1, 10)
        clock.now += 1.0
    assert t.latency_fast_burn() == j.latency_fast_burn() == 5.0


def test_identity_helpers_match_reference(monkeypatch):
    for raw in ["alice", " bob ", "", None, 7, "__other__", "__canary__",
                "a" * 64, "a" * 65, "bad\nname", "x@y.z:1+2-3_4",
                "white space"]:
        assert tslo.sanitize_tenant(raw) == jslo.sanitize_tenant(raw)

    @dataclasses.dataclass
    class User:
        id: str

    for user, bearer in [(User("u1"), None), (User(""), "Bearer k1"),
                         (None, "bearer  k2 "), (None, "rawkey"),
                         (None, "Bearer "), (None, None),
                         (User("bad id!"), None)]:
        assert tslo.resolve_tenant(user, bearer) == \
            jslo.resolve_tenant(user, bearer)
    for v in ["", "3", "0", "x", "-2"]:
        monkeypatch.setenv("HELIX_TENANT_TOP_K", v)
        assert tslo.tenant_top_k_from_env() == jslo.tenant_top_k_from_env()
    for v in ["", "60,600", "600,60", "1,2,3", "x,1", "0,5"]:
        monkeypatch.setenv("HELIX_SLO_BURN_WINDOWS", v)
        assert tslo.burn_windows_from_env() == jslo.burn_windows_from_env()
    for name in ("TENANT_HEADER", "ANON_TENANT", "OTHER_TENANT",
                 "CANARY_TENANT", "TENANT_KEYS"):
        assert getattr(tslo, name) == getattr(jslo, name)


@pytest.mark.parametrize("d", [
    None, {}, TARGETS, {"ttft_p95_seconds": "2.5"},
    {"ttft_p95_seconds": -1, "queue_wait_p95_seconds": float("nan"),
     "goodput_floor_tps": "x"},
    {"goodput_floor_tps": 0, "sched": {"policy": "wfq"}},
])
def test_slo_targets_match_reference(d):
    j, t = jslo.SLOTargets.from_dict(d), tslo.SLOTargets.from_dict(d)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.to_dict() == j.to_dict() and t.any == j.any


def test_admission_audit_matches_reference():
    j, t = jslo.AdmissionAudit(capacity=4), tslo.AdmissionAudit(capacity=4)
    assert tslo.AdmissionAudit.REASONS == jslo.AdmissionAudit.REASONS
    for i in range(7):
        for audit in (j, t):
            audit.record("queue_full" if i % 2 else "quarantine",
                         tenant=("" if i == 3 else f"t{i}"),
                         trace_id=f"tr{i}", request_id=f"r{i}",
                         detail="x" * 300, queue_depth=i, slots_busy=1)
    js, ts = j.snapshot(recent=3), t.snapshot(recent=3)
    for doc in (js, ts):
        for rec in doc["recent"]:
            rec.pop("ts")
    assert ts == js
    assert ts["recorded"] == 7 and len(ts["recent"]) == 3
    assert len(ts["recent"][0]["detail"]) == 200

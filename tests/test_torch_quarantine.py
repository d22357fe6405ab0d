"""The port's step-failure ladder against the JAX package's.

Each scenario arms the ``engine_step`` fault point of each package with
the same rule (``tests/test_chaos.py``'s poisoned-request rule and its
kin) and drives a tiny JAX ``EngineLoop`` (``attn_backend="reference"``,
float32) and the port's loop through the same submissions:

- two poisoned requests among fresh ones, all admitted together: the
  bisection evicts exactly the poisoned ones with the reference's
  ``request quarantined: engine step failed while scheduled (...)``
  error, the counters agree, and the survivors' greedy tokens equal the
  reference's and an unpoisoned run's;
- a poisoned request arriving while others decode: one eviction, one
  retry at least, the others finish error-free, and the loop serves on;
- a fault that fires once: retried on the same state, nobody evicted;
- a fault living in an emitting request: the control step exonerates
  the fresh suspects and the scheduler's victims are evicted until the
  fault clears (FIFO: the newest first; WFQ: the batch class first);
- with the async loop on, the same bisection and tokens.

The survivors' error-free events also show that no error frame overtook
a token: each stream ends in exactly one terminal event.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helix_tpu.engine import engine as jengine
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.serving import engine_loop as jloop
from helix_tpu.testing import faults as jfaults
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.serving import engine_loop as tloop
from helix_tpu_torch.testing import faults as tfaults

GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=256,
                max_pages_per_seq=32, max_prefill_len=16)
VOCAB = 512
QUARANTINED = "request quarantined: engine step failed while scheduled ("
POISON_RULE = {"point": "engine_step", "request_id_contains": "poison"}


class _SnapshotJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input first (the JAX
    engine's asynchronous host-mirror upload, ROADMAP queue C)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        if isinstance(a, np.ndarray):
            a = a.copy()
        return jnp.asarray(a, *args, **kwargs)


@pytest.fixture(autouse=True, scope="module")
def _reference_uploads_snapshot():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "jnp", _SnapshotJnp())
        yield


@pytest.fixture(autouse=True)
def _disarmed():
    jfaults.disarm()
    tfaults.disarm()
    yield
    jfaults.disarm()
    tfaults.disarm()


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig.tiny(vocab_size=VOCAB, dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(vocab_size=VOCAB, dtype="float32"), tp


class _Events:
    def __init__(self):
        self.tokens, self.errors, self.terminal = [], [], 0
        self.reason = None
        self.done = threading.Event()

    def __call__(self, ev):
        assert not self.done.is_set(), "event after the terminal one"
        if ev.error:
            self.errors.append(ev.error)
        elif ev.token_id >= 0:
            self.tokens.append(ev.token_id)
        if ev.finished:
            self.terminal += 1
            self.reason = ev.finish_reason
            self.done.set()

    @property
    def error(self):
        return self.errors[0] if self.errors else None


SIDES = {
    "jax": (jloop, jengine, jsampling, jfaults),
    "torch": (tloop, tengine, tsampling, tfaults),
}


def _loop(weights, side, name, sched=None, async_on=False):
    jcfg, jp, tcfg, tp = weights
    lmod, emod, *_ = SIDES[side]
    geo = dict(GEOMETRY, enable_async_loop=async_on)
    if side == "jax":
        eng = emod.Engine(jcfg, jp, emod.EngineConfig(
            **geo, attn_backend="reference"))
    else:
        eng = emod.Engine(tcfg, tp, emod.EngineConfig(**geo), device="cpu")
    return lmod.EngineLoop(eng, name, sched_config=sched)


def _req(side, rid, seed, n=7, max_tokens=8, sched_class=""):
    _, emod, smod, _ = SIDES[side]
    prompt = [int(x) for x in np.random.default_rng(seed).integers(
        2, VOCAB, size=n)]
    return emod.Request(
        id=rid, prompt_tokens=prompt, stop_token_ids=(1,),
        sampling=smod.SamplingParams(max_tokens=max_tokens,
                                     temperature=0.0),
        sched_class=sched_class)


def _wait(events, timeout=90):
    for rid, ev in events.items():
        assert ev.done.wait(timeout), f"{rid} stuck"
        assert ev.terminal == 1, rid


def _counters(loop) -> tuple:
    return (loop.quarantine_evictions, loop.step_retries,
            loop.step_failures)


FRESH = ("fresh-1", "poison-a", "fresh-2", "poison-b", "fresh-3")


def _fresh_batch(weights, side, rule, async_on=False) -> tuple:
    """Every request submitted before the loop starts (admitted together,
    in order), with ``rule`` armed or not."""
    lmod, _, _, fmod = SIDES[side]
    if rule is not None:
        fmod.arm(seed=13, rules=[dict(rule)])
    loop = _loop(weights, side, f"q-{side}", async_on=async_on)
    events = {}
    for i, rid in enumerate(FRESH):
        events[rid] = _Events()
        loop.submit(_req(side, rid, 100 + i), events[rid])
    loop.start()
    try:
        _wait(events)
    finally:
        loop.stop()
        fmod.disarm()
    return events, _counters(loop)


@pytest.mark.parametrize("async_on", [False, True])
def test_bisection_evicts_the_same_culprits(weights, async_on):
    out = {s: _fresh_batch(weights, s, POISON_RULE, async_on)
           for s in SIDES}
    clean, _ = _fresh_batch(weights, "torch", None, async_on)
    (jev, jc), (tev, tc) = out["jax"], out["torch"]
    assert tc == jc
    assert tc[0] == 2 and tc[1] >= 1
    for rid in FRESH:
        if rid.startswith("poison"):
            assert tev[rid].error.startswith(QUARANTINED), tev[rid].errors
            assert jev[rid].error.startswith(QUARANTINED)
            assert tev[rid].tokens == []
        else:
            assert tev[rid].errors == [] and jev[rid].errors == []
            assert tev[rid].reason in ("stop", "length")
            assert tev[rid].tokens == jev[rid].tokens, rid
            assert tev[rid].tokens == clean[rid].tokens, rid


def _arrives_while_decoding(weights, side) -> tuple:
    lmod, _, _, fmod = SIDES[side]
    loop = _loop(weights, side, f"qd-{side}").start()
    try:
        innocents = {}
        for i, rid in enumerate(("keep-1", "keep-2")):
            innocents[rid] = _Events()
            loop.submit(_req(side, rid, 200 + i, max_tokens=48),
                        innocents[rid])
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not all(
                e.tokens for e in innocents.values()):
            time.sleep(0.01)
        assert all(e.tokens for e in innocents.values())
        fmod.arm(seed=11, rules=[dict(POISON_RULE)])
        poison = _Events()
        loop.submit(_req(side, "poison-1", 300), poison)
        assert poison.done.wait(60)
        _wait(innocents)
        fmod.disarm()
        after = _Events()
        loop.submit(_req(side, "after-1", 301, max_tokens=4), after)
        assert after.done.wait(60)
        return poison, innocents, after, _counters(loop)
    finally:
        fmod.disarm()
        loop.stop()


def test_poison_arriving_mid_decode_matches_reference(weights):
    outs = {s: _arrives_while_decoding(weights, s) for s in SIDES}
    for side, (poison, innocents, after, counters) in outs.items():
        assert poison.error.startswith(QUARANTINED), (side, poison.errors)
        assert all(e.errors == [] and e.reason in ("stop", "length")
                   for e in innocents.values()), side
        assert after.errors == [] and after.tokens, side
        assert counters[0] == 1 and counters[1] >= 1, (side, counters)
    assert outs["torch"][3][0] == outs["jax"][3][0]


def _transient(weights, side) -> tuple:
    _, _, _, fmod = SIDES[side]
    fmod.arm(seed=3, rules=[{"point": "engine_step", "on_step": 2,
                             "times": 1}])
    loop = _loop(weights, side, f"qt-{side}")
    events = {}
    for i in range(3):
        events[f"t{i}"] = _Events()
        loop.submit(_req(side, f"t{i}", 400 + i), events[f"t{i}"])
    loop.start()
    try:
        _wait(events)
    finally:
        loop.stop()
        fmod.disarm()
    return events, _counters(loop)


def test_transient_fault_is_retried_not_quarantined(weights):
    jev, jc = _transient(weights, "jax")
    tev, tc = _transient(weights, "torch")
    assert tc == jc == (0, 1, 1)
    for rid in jev:
        assert tev[rid].errors == [] and jev[rid].errors == []
        assert tev[rid].tokens == jev[rid].tokens


def _emitting_fault(weights, side, policy) -> tuple:
    """The fault lives in an emitting request: armed once ``bad-1``
    decodes, while two fresh requests arrive."""
    _, _, _, fmod = SIDES[side]
    sched = {"sched": {"policy": policy}} if policy else None
    loop = _loop(weights, side, f"qe-{side}", sched=sched).start()
    try:
        events = {}
        for rid, cls, seed in (("keep-1", "batch", 500),
                               ("bad-1", "interactive", 501)):
            events[rid] = _Events()
            loop.submit(_req(side, rid, seed, max_tokens=60,
                             sched_class=cls), events[rid])
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not all(
                e.tokens for e in events.values()):
            time.sleep(0.01)
        fmod.arm(seed=5, rules=[{"point": "engine_step",
                                 "request_id_contains": "bad-1"}])
        for rid, seed in (("new-1", 502), ("new-2", 503)):
            events[rid] = _Events()
            loop.submit(_req(side, rid, seed, max_tokens=4,
                             sched_class="interactive"), events[rid])
        _wait(events)
        return ({rid: (e.error or "").split(" (")[0]
                 for rid, e in events.items()}, _counters(loop)[0])
    finally:
        fmod.disarm()
        loop.stop()


@pytest.mark.parametrize("policy", [None, "wfq"])
def test_fault_in_emitting_request_evicts_policy_victims(weights, policy):
    j_err, j_ev = _emitting_fault(weights, "jax", policy)
    t_err, t_ev = _emitting_fault(weights, "torch", policy)
    assert t_err == j_err and t_ev == j_ev
    # the culprit goes and the fresh requests finish.  FIFO sheds the
    # newest emitting request, the culprit, at once; WFQ sheds the batch
    # class first, so the batch request goes before the culprit does
    assert t_err["bad-1"].startswith("evicted after repeated engine step")
    assert t_err["new-1"] == t_err["new-2"] == ""
    if policy == "wfq":
        assert t_err["keep-1"] == t_err["bad-1"] and t_ev == 2
    else:
        assert t_err["keep-1"] == "" and t_ev == 1


def test_stop_ends_every_stream_unlike_reference(weights):
    """``stop()`` without a drain: the port ends every request in flight
    with a ``shutting_down`` error event; the reference's thread exits
    leaving them without a terminal event (ROADMAP C)."""
    outs = {}
    for side in SIDES:
        loop = _loop(weights, side, f"qs-{side}").start()
        ev = _Events()
        loop.submit(_req(side, "long-1", 600, max_tokens=10_000), ev)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not ev.tokens:
            time.sleep(0.01)
        assert ev.tokens, side
        loop.stop()
        outs[side] = ev
    assert outs["torch"].done.is_set()
    assert outs["torch"].error.startswith("shutting_down: engine ")
    assert not outs["jax"].done.is_set()

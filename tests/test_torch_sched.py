"""The port's scheduler (``serving/sched.py``) against the JAX package's.

- ``SchedConfig.from_profile``: the same ``slo`` blocks and
  ``HELIX_SCHED_*`` overrides give the same config; ``sanitize_class`` and
  ``make_scheduler`` agree.
- Hypothesis-generated queues of up to 64 requests over 4 tenants and 2
  classes, with weights, admission charges and finished requests, under
  one fake clock: identical reorder lists, shed victims, ``preempt_order``
  lists, stats and ``helix_sched_*`` samples, FIFO and WFQ.
- The adaptive prefill budget on a scripted burn: the same trajectory
  (shrink, floor, regrow to the cap, throttle inside the adapt interval).
- Engine level: a tiny JAX ``EngineLoop`` and the port's get the same
  submission script (two tenants weighted 2:1, one flooding with batch
  requests, a per-tenant bound, a 64-token budget under a scripted burn)
  and give the same 429 set, admission order, greedy tokens and
  ``sched.stats()``.
"""

import dataclasses
import itertools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from helix_tpu.engine import engine as jengine
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.obs import metrics as jmetrics
from helix_tpu.serving import engine_loop as jloop
from helix_tpu.serving import sched as jsched
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.obs import metrics as tmetrics
from helix_tpu_torch.serving import engine_loop as tloop
from helix_tpu_torch.serving import sched as tsched

TENANTS = ("t0", "t1", "t2", "t3")


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


@dataclasses.dataclass
class _Req:
    id: str
    prompt_tokens: list
    tenant: str = "anonymous"
    sched_class: str = ""
    finished: bool = False
    admitted_time: float = None
    submit_time: float = 0.0
    cached_tokens: int = 0


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

PROFILES = [
    None,
    {},
    {"ttft_p95_seconds": 2.0},
    {"sched": {"policy": "wfq", "default_class": "interactive",
               "default_weight": 1, "max_tenant_queue_depth": 64,
               "prefill_budget_tokens": 4096,
               "prefill_budget_min_tokens": 512}},
    {"sched": {"policy": "WFQ ", "default_class": "batch",
               "tenant_weights": {"a": 2, "b": "0.5", "c": -1, "d": "x",
                                  3: 1},
               "default_weight": "junk", "max_tenant_queue_depth": 0,
               "prefill_budget_tokens": "12"}},
    {"sched": {"policy": "lottery", "default_class": "realtime"}},
    {"sched": "wfq"},
    # a sched sub-block passed where the slo block belongs: FIFO in both
    {"policy": "wfq", "max_tenant_queue_depth": 4},
]
ENVS = [
    {},
    {"HELIX_SCHED_POLICY": "wfq", "HELIX_SCHED_PREFILL_BUDGET": "128"},
    {"HELIX_SCHED_POLICY": "fifo", "HELIX_SCHED_DEFAULT_CLASS": "batch",
     "HELIX_SCHED_TENANT_QUEUE_DEPTH": "3",
     "HELIX_SCHED_PREFILL_BUDGET_MIN": "7"},
    {"HELIX_SCHED_PREFILL_BUDGET": "nope", "HELIX_SCHED_DEFAULT_CLASS": " "},
]


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("profile", PROFILES)
def test_from_profile_matches_reference(monkeypatch, profile, env):
    for k in ("POLICY", "DEFAULT_CLASS", "PREFILL_BUDGET",
              "PREFILL_BUDGET_MIN", "TENANT_QUEUE_DEPTH"):
        monkeypatch.delenv(f"HELIX_SCHED_{k}", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = jsched.SchedConfig.from_profile(profile)
    got = tsched.SchedConfig.from_profile(profile)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tsched.make_scheduler(profile).name == \
        jsched.make_scheduler(profile).name


def test_constants_and_sanitize_class_match():
    assert tsched.SCHED_CLASSES == jsched.SCHED_CLASSES
    assert tsched.CLASS_HEADER == jsched.CLASS_HEADER
    assert tsched.SCHED_AUDIT_REASONS == jsched.SCHED_AUDIT_REASONS
    for raw in ["interactive", " BATCH ", "batch", "", None, 3, "vip",
                "Interactive\n"]:
        for default in ("", "interactive", "batch"):
            assert tsched.sanitize_class(raw, default) == \
                jsched.sanitize_class(raw, default)


# ---------------------------------------------------------------------------
# scripted queues (hypothesis)
# ---------------------------------------------------------------------------

_req_st = st.tuples(
    st.sampled_from(TENANTS),
    st.sampled_from(("interactive", "batch", "")),
    st.integers(1, 300),           # prompt length
    st.booleans(),                 # finished (aborted while queued)
    st.integers(0, 40),            # cached tokens
)


def _pair(cfg_kw, clock):
    cfg_j = jsched.SchedConfig(**cfg_kw)
    cfg_t = tsched.SchedConfig(**cfg_kw)
    mk = {"wfq": (jsched.WFQScheduler, tsched.WFQScheduler),
          "fifo": (jsched.FifoScheduler, tsched.FifoScheduler)}
    jcls, tcls = mk[cfg_kw.get("policy", "fifo")]
    return jcls(cfg_j, clock=clock), tcls(cfg_t, clock=clock)


def _collect(sched, cmod) -> dict:
    c = cmod.Collector()
    sched.collect(c, {"model": "m"})
    return c.families


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    policy=st.sampled_from(("wfq", "fifo")),
    reqs=st.lists(_req_st, min_size=0, max_size=64),
    weights=st.dictionaries(st.sampled_from(TENANTS),
                            st.floats(0.25, 4.0), max_size=4),
    admits=st.lists(st.integers(0, 63), max_size=24),
    rounds=st.integers(1, 3),
    default_class=st.sampled_from(("interactive", "batch")),
)
def test_scripted_queues_match_reference(policy, reqs, weights, admits,
                                         rounds, default_class):
    clock = itertools.count(0.0, 0.5).__next__
    j, t = _pair(dict(policy=policy, tenant_weights=weights,
                      default_class=default_class,
                      max_tenant_queue_depth=5), clock)
    queue = [
        _Req(id=f"r{i}", prompt_tokens=[1] * n, tenant=ten,
             sched_class=cls, finished=fin, cached_tokens=min(c, n),
             submit_time=float(i),
             admitted_time=(float(i) / 2 if i % 3 == 0 else None))
        for i, (ten, cls, n, fin, c) in enumerate(reqs)
    ]
    jq, tq = list(queue), list(queue)
    for _ in range(rounds):
        j.reorder(jq)
        t.reorder(tq)
        assert [r.id for r in tq] == [r.id for r in jq]
        for k in admits:
            if k < len(jq):
                j.note_admitted(jq[k])
                t.note_admitted(tq[k])
        live = [r for r in jq if not r.finished]
        vj, vt = j.pick_shed_victim(live), t.pick_shed_victim(live)
        assert (vt and vt.id) == (vj and vj.id)
        assert [r.id for r in t.preempt_order(live)] == \
            [r.id for r in j.preempt_order(live)]
        if vj is not None:
            j.note_shed_victim(vj)
            t.note_shed_victim(vt)
            j.note_preempt_victim(vj)
            t.note_preempt_victim(vt)
    for ten in TENANTS:
        depth = sum(1 for r in queue if r.tenant == ten)
        assert t.tenant_overflow(ten, depth) == j.tenant_overflow(ten, depth)
        if policy == "wfq":
            for cls in tsched.SCHED_CLASSES:
                assert t.normalized_service(cls, ten) == \
                    j.normalized_service(cls, ten)
    t.note_tenant_shed()
    j.note_tenant_shed()
    assert t.stats() == j.stats()
    assert _collect(t, tmetrics) == _collect(j, jmetrics)


# ---------------------------------------------------------------------------
# the adaptive prefill budget
# ---------------------------------------------------------------------------


class _Burn:
    """A scripted ``latency_fast_burn``: one value per call."""

    def __init__(self, values):
        self._it = iter(values)

    def latency_fast_burn(self):
        return next(self._it)


class _BadBurn:
    def latency_fast_burn(self):
        raise RuntimeError("advisory")


@pytest.mark.parametrize("cap,floor", [(4096, 512), (64, 16), (100, 256),
                                       (9, 1)])
def test_budget_trajectory_matches_reference(cap, floor):
    """Shrink while the burn exceeds 1 (down to the floor), hold inside
    the adapt interval, grow 1.25x back to the cap below 0.5."""
    now = [0.0]
    j, t = _pair(dict(policy="wfq", prefill_budget_tokens=cap,
                      prefill_budget_min_tokens=floor), lambda: now[0])
    script = ([(1.0, 3.0)] * 6 + [(0.3, 3.0)] * 3 + [(1.0, 0.7)] * 2
              + [(1.0, 0.1)] * 20 + [(1.0, 1.0)] + [(0.2, 0.0)] * 3)
    trajectory = []
    for dt, burn in script:
        now[0] += dt
        got = t.prefill_budget(_Burn([burn]))
        want = j.prefill_budget(_Burn([burn]))
        assert got == want
        trajectory.append(got)
    assert (t.budget_shrinks, t.budget_grows) == \
        (j.budget_shrinks, j.budget_grows)
    assert min(trajectory) == min(cap, floor)
    assert trajectory[-1] == cap
    assert (t.budget_shrinks > 0) == (floor < cap)
    now[0] += 5
    assert t.prefill_budget(_BadBurn()) == j.prefill_budget(_BadBurn())
    assert t.prefill_budget(None) == j.prefill_budget(None)
    fifo_j, fifo_t = _pair(dict(policy="fifo", prefill_budget_tokens=cap),
                           lambda: now[0])
    assert fifo_t.prefill_budget(_Burn([3.0])) is None
    assert fifo_t.stats() == fifo_j.stats()


# ---------------------------------------------------------------------------
# engine level: the same submission script through both loops
# ---------------------------------------------------------------------------

GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=256,
                max_pages_per_seq=32, max_prefill_len=16)
VOCAB = 512


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig.tiny(vocab_size=VOCAB, dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(vocab_size=VOCAB, dtype="float32"), tp


def _script(seed: int) -> list:
    """(id, tenant, class header, prompt): a batch flood of tenant
    ``flood`` (weight 1), interleaved with chat traffic of tenant ``chat``
    (weight 2) and an unweighted tenant of the default class."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(10):
        out.append((f"flood-{i}", "flood", "batch",
                    [int(x) for x in rng.integers(2, VOCAB, size=12)]))
        if i % 3 == 1:
            out.append((f"chat-{i}", "chat", "interactive",
                        [int(x) for x in rng.integers(2, VOCAB, size=6)]))
        if i % 4 == 2:
            out.append((f"misc-{i}", "misc", "",
                        [int(x) for x in rng.integers(2, VOCAB, size=9)]))
    return out


class _Events:
    def __init__(self):
        self.tokens, self.error, self.reason = [], None, None
        self.done = threading.Event()

    def __call__(self, ev):
        if ev.error:
            self.error = ev.error
        elif ev.token_id >= 0:
            self.tokens.append(ev.token_id)
        if ev.finished:
            self.reason = ev.finish_reason
            self.done.set()


def _run_script(loop, mod, smod, script):
    """Submit the whole script before the loop starts (so both loops take
    it from their inbox in one pass), with a step-counting clock and a
    scripted burn; returns (events by id, admission order)."""
    ticks = itertools.count(0.0, 1.0)
    loop.sched.clock = lambda: next(ticks)
    burns = iter([3.0, 3.0, 3.0] + [0.2] * 10_000)
    loop.slo.latency_fast_burn = lambda: next(burns)
    order = []
    note = loop.sched.note_admitted

    def spy(req):
        order.append(req.id)
        note(req)

    loop.sched.note_admitted = spy
    events = {}
    for rid, tenant, cls, prompt in script:
        events[rid] = _Events()
        loop.submit(mod.Request(
            id=rid, prompt_tokens=list(prompt), stop_token_ids=(1,),
            sampling=smod.SamplingParams(max_tokens=6, temperature=0.0),
            tenant=tenant, sched_class=cls), events[rid])
    loop.start()
    try:
        for rid, ev in events.items():
            assert ev.done.wait(120), rid
    finally:
        loop.stop()
    return events, order


@pytest.mark.parametrize("policy", ["wfq", "fifo"])
def test_engine_loops_schedule_the_same(weights, policy):
    jcfg, jp, tcfg, tp = weights
    slo = {"ttft_p95_seconds": 1.0,
           "sched": {"policy": policy,
                     "tenant_weights": {"chat": 2, "flood": 1},
                     "max_tenant_queue_depth": 6,
                     "prefill_budget_tokens": 64,
                     "prefill_budget_min_tokens": 16}}
    script = _script(3)
    jl = jloop.EngineLoop(
        jengine.Engine(jcfg, jp, jengine.EngineConfig(
            **GEOMETRY, attn_backend="reference")), "m",
        slo_targets=slo, sched_config=slo)
    tl = tloop.EngineLoop(
        tengine.Engine(tcfg, tp, tengine.EngineConfig(**GEOMETRY),
                       device="cpu"), "m",
        slo_targets=slo, sched_config=slo)
    jev, jorder = _run_script(jl, jengine, jsampling, script)
    tev, torder = _run_script(tl, tengine, tsampling, script)
    j429 = sorted(r for r, e in jev.items() if e.error)
    t429 = sorted(r for r, e in tev.items() if e.error)
    assert t429 == j429 == [f"flood-{i}" for i in range(6, 10)]
    assert all(tev[r].error.startswith("queue_full: tenant 'flood'")
               for r in t429)
    assert [tev[r].error for r in t429] == [jev[r].error for r in j429]
    assert torder == jorder
    for rid in jev:
        assert tev[rid].tokens == jev[rid].tokens, rid
        assert tev[rid].reason == jev[rid].reason, rid
    assert tl.sched.stats() == jl.sched.stats()
    st = tl.sched.stats()
    assert st["tenant_queue_sheds"] == 4
    if policy == "wfq":
        # strict priority: every chat request admits before any flood
        # request queued with it, and the budget shrank under the burn
        first_flood = min(torder.index(r) for r in torder
                          if r.startswith("flood"))
        assert all(torder.index(r) < first_flood for r in torder
                   if r.startswith("chat"))
        assert st["budget_shrinks"] >= 2 and st["budget_grows"] >= 1
    else:
        assert torder == [r for r, *_ in script if r not in t429]
    assert tl.slo.stats()["sheds"] == jl.slo.stats()["sheds"] == 4

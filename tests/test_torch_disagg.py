"""The disaggregated prefill handoff in the port, against the JAX package.

- **``export_prefill``**: the reference's ``TestExportPrefill`` on the
  port's engine (refused before the first token; at the first token a
  snapshot whose continuation on another engine is bit-identical to an
  uninterrupted run, greedy and seeded); the port's snapshot at the first
  token agrees with the reference's on every field, page bytes included.
- **The loop's staging** (``_disagg_tick``): each rung (``snapshot``,
  ``completed``, ``local``, ``gone``) and the async loop with a step in
  flight, where the tick reconciles before it exports.
- **The reference's HTTP suite** (``tests/test_disagg.py::
  TestDisaggHTTP``) with a port prefill runner and a port decode runner
  (tiny float32 engines behind the port's server) under the reference's
  ``ControlPlane`` with ``HELIX_POOL_DISAGG=1``: the handoff equal to
  colocated serving with every counter, the unreachable peer, the corrupt
  page, the prefill runner down, non-stream requests, the pools' status
  and the ``/metrics`` families.
- **Across backends**: a reference prefill runner hands off to a port
  decode runner, and a port prefill runner to a reference decode runner,
  under the same control plane; both streams equal colocated serving.
- **The stub's plan** (``ControlStub.disagg_request``, the card's
  stand-in for the control plane): each rung against port runners.

Every comparison is exact (token text, counters, JSON fields).
"""

import asyncio
import dataclasses
import json
import os
import threading
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helix_tpu.engine import engine as jengine
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.serving import migration as jmigration
from helix_tpu.serving.engine_loop import EngineLoop as JLoop
from helix_tpu.serving.registry import ModelRegistry as JRegistry
from helix_tpu.serving.registry import ServedModel as JServed
from helix_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer
from helix_tpu.testing import faults as jfaults
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine.sampling import SamplingParams
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.serving import migration
from helix_tpu_torch.serving.engine_loop import EngineLoop
from helix_tpu_torch.serving.openai_api import OpenAIServer
from helix_tpu_torch.serving.registry import ModelRegistry, ServedModel
from helix_tpu_torch.serving.tokenizer import ByteTokenizer
from helix_tpu_torch.testing import faults
from helix_tpu_torch.testing.control_stub import ControlStub

VOCAB = 512
MODEL = "m1"
TOK = ByteTokenizer()
JTOK = JByteTokenizer()
# the reference suite's engine (tests/test_disagg.py::_engine)
GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=64,
                max_pages_per_seq=32, max_prefill_len=64)
GREEDY = dict(temperature=0.0, max_tokens=16)
SEEDED = dict(temperature=0.9, top_p=0.9, seed=77, presence_penalty=0.3,
              max_tokens=16)


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
def _no_faults():
    yield
    faults.disarm()
    jfaults.disarm()


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(
        JModelConfig.tiny(vocab_size=VOCAB, dtype="float32"), name=MODEL)
    jp = jinit(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    cfg = dataclasses.replace(
        ModelConfig.tiny(vocab_size=VOCAB, dtype="float32"), name=MODEL)
    return jcfg, jp, cfg, tp


def _port(weights, eos=(), **kw):
    *_, cfg, tp = weights
    return tengine.Engine(cfg, tp, tengine.EngineConfig(
        **{**GEOMETRY, **kw}, eos_token_ids=tuple(eos)), device="cpu")


def _ref(weights, eos=(), **kw):
    jcfg, jp, _, _ = weights
    return jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **{**GEOMETRY, **kw}, eos_token_ids=tuple(eos),
        attn_backend="reference"))


def _run(eng, req):
    eng.add_request(req)
    while not req.finished:
        eng.step()
    return list(req.output_tokens)


def _to_first_token(eng, req):
    eng.add_request(req)
    while not req.output_tokens and eng.has_work():
        eng.step()


# ---------------------------------------------------------------------------
# export_prefill (the reference's TestExportPrefill)
# ---------------------------------------------------------------------------


def test_export_prefill_refused_before_the_first_token(weights):
    eng = _port(weights)
    req = tengine.Request(id="pre-early", prompt_tokens=list(range(7, 30)),
                          sampling=SamplingParams(temperature=0.0,
                                                  max_tokens=8))
    eng.add_request(req)
    assert eng.export_prefill("pre-early") is None     # still queued
    assert eng.export_prefill("unknown") is None
    assert eng.num_prefill_exports == 0
    eng.abort("pre-early")
    while eng.has_work():
        eng.step()


@pytest.mark.parametrize("samp", [GREEDY, SEEDED], ids=["greedy", "seeded"])
def test_handoff_at_first_token_is_bit_identical(weights, samp):
    """Prefill on A, ship at the first token, continue on B: A's tokens
    and B's new ones are an uninterrupted run's, which is the reference
    engine's run."""
    prompt = list(range(11, 41))
    jref = _run(_ref(weights), jengine.Request(
        id="ref", prompt_tokens=list(prompt),
        sampling=jengine.SamplingParams(**samp)))
    ref = _run(_port(weights), tengine.Request(
        id="ref", prompt_tokens=list(prompt),
        sampling=SamplingParams(**samp)))
    assert ref == jref
    eng_a, eng_b = _port(weights), _port(weights)
    req = tengine.Request(id="handoff", prompt_tokens=list(prompt),
                          sampling=SamplingParams(**samp))
    _to_first_token(eng_a, req)
    snap = eng_a.export_prefill("handoff")
    assert snap is not None and snap.has_kv
    assert eng_a.num_prefill_exports == 1
    cut = len(snap.output_tokens)
    eng_a.abort("handoff")
    while eng_a.has_work():
        eng_a.step()
    cont = eng_b.import_request(migration.wire_to_snapshot(
        migration.snapshot_to_wire(snap)))
    while not cont.finished:
        eng_b.step()
    assert snap.output_tokens + cont.output_tokens[cut:] == ref


def test_prefill_snapshot_equals_the_reference(weights):
    """At the first token both packages export the same snapshot: every
    wire field but the page bytes (f32 K/V from two backends' arithmetic)
    and the digests over them equal, the pages' dtypes and shapes too."""
    prompt = list(range(11, 41))
    docs = []
    for mod, eng, smod in ((tengine, _port(weights), SamplingParams),
                           (jengine, _ref(weights),
                            jengine.SamplingParams)):
        req = mod.Request(id="same", prompt_tokens=list(prompt),
                          sampling=smod(**SEEDED))
        _to_first_token(eng, req)
        snap = eng.export_prefill("same")
        docs.append((migration if mod is tengine else jmigration)
                    .snapshot_to_wire(snap))
        assert eng.num_prefill_exports == 1

    def meta(doc):
        return {k: v for k, v in doc.items()
                if k not in ("pages", "page_checksums", "meta_checksum")}

    def shapes(doc):
        return [{f: (a["dtype"], a["shape"]) if a else None
                 for f, a in p.items()} for p in doc["pages"]]

    assert meta(docs[0]) == meta(docs[1])
    assert shapes(docs[0]) == shapes(docs[1]) and docs[0]["pages"]


# ---------------------------------------------------------------------------
# the loop's staging: every rung of _disagg_tick
# ---------------------------------------------------------------------------


def _staged(loop, req):
    """Stage, submit, and wait for the one callback: (kind, wire, events)."""
    got, events, done = [], [], threading.Event()

    def on_export(kind, wire):
        got.append((kind, wire))
        done.set()

    loop.stage_disagg_export(req.id, on_export)
    loop.submit(req, events.append)
    assert done.wait(60)
    time.sleep(0.05)
    assert len(got) == 1
    return got[0][0], got[0][1], events


def test_tick_snapshot_rung(weights):
    loop = EngineLoop(_port(weights), "m1").start()
    try:
        req = tengine.Request(id="snap", prompt_tokens=list(range(7, 30)),
                              sampling=SamplingParams(**GREEDY))
        kind, wire, _ev = _staged(loop, req)
        assert kind == "snapshot" and wire["request_id"] == "snap"
        assert wire["pages"] and wire["output_tokens"]
        st = loop.stats()["migration"]
        assert (st["prefill_exports"], st["disagg_exports"]) == (1, 1)
        # the request kept decoding here: the caller aborts on a
        # confirmed ship
        loop.abort("snap")
    finally:
        loop.stop()


def test_tick_completed_rung(weights):
    """A request that finishes in its first step (one token) is served
    from the buffered events."""
    loop = EngineLoop(_port(weights), "m1").start()
    try:
        req = tengine.Request(id="short", prompt_tokens=list(range(7, 30)),
                              sampling=SamplingParams(temperature=0.0,
                                                      max_tokens=1))
        kind, wire, events = _staged(loop, req)
        assert (kind, wire) == ("completed", None)
        assert events and events[-1].finished
        assert loop.stats()["migration"]["prefill_exports"] == 0
    finally:
        loop.stop()


def test_tick_local_rung(weights, monkeypatch):
    """An export the engine refuses (or that raises) keeps the request
    here: ``local``, and it runs to its end."""
    eng = _port(weights)
    monkeypatch.setattr(eng, "export_prefill", lambda rid: None)
    loop = EngineLoop(eng, "m1").start()
    try:
        req = tengine.Request(id="loc", prompt_tokens=list(range(7, 30)),
                              sampling=SamplingParams(**GREEDY))
        kind, wire, events = _staged(loop, req)
        assert (kind, wire) == ("local", None)
        deadline = time.monotonic() + 60
        while not (events and events[-1].finished):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert len(events) == GREEDY["max_tokens"]
        assert loop.stats()["migration"]["disagg_exports"] == 0
    finally:
        loop.stop()


def test_tick_gone_rung(weights):
    """A request aborted before its first token: ``gone``.  A staged id
    whose request never reached the engine fires nothing (the reference's
    tick reads a staged request not yet drained from the inbox as gone,
    which its handler answers 502)."""
    loop = EngineLoop(_port(weights), "m1")
    got = []
    loop.stage_disagg_export("ghost", lambda kind, wire: got.append(kind))
    loop.stage_disagg_export("aborted",
                             lambda kind, wire: got.append(kind))
    req = tengine.Request(id="aborted", prompt_tokens=list(range(7, 30)),
                          sampling=SamplingParams(**GREEDY))
    events = []
    loop.submit(req, events.append)
    loop.abort("aborted")
    loop.start()
    try:
        deadline = time.monotonic() + 30
        while not got:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        time.sleep(0.2)
        assert got == ["gone"] and events == []
        assert "ghost" in loop._disagg_cb
    finally:
        loop.stop()


def test_tick_reconciles_a_step_in_flight(weights):
    """With the async loop a decode step is in flight while the staged
    request already has tokens; the tick reconciles before the export, so
    the handoff never degrades to ``local`` (``export_request`` refuses
    an unreconciled step), and the continuation elsewhere is exact."""
    prompt = list(range(11, 41))
    ref = _run(_port(weights), tengine.Request(
        id="ref", prompt_tokens=list(prompt),
        sampling=SamplingParams(**GREEDY)))
    loop = EngineLoop(_port(weights, enable_async_loop=True), "m1").start()
    try:
        # a decoder keeps the pipeline busy while the staged one admits
        busy = tengine.Request(id="busy", prompt_tokens=list(range(50, 70)),
                               sampling=SamplingParams(temperature=0.0,
                                                       max_tokens=200))
        started = threading.Event()
        loop.submit(busy, lambda ev: started.set())
        assert started.wait(60)
        deadline = time.monotonic() + 60
        while loop.pipelined_steps == 0:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        req = tengine.Request(id="staged", prompt_tokens=list(prompt),
                              sampling=SamplingParams(**GREEDY))
        kind, wire, events = _staged(loop, req)
        assert kind == "snapshot"
        snap = migration.wire_to_snapshot(wire)
        loop.abort("staged")
        loop.abort("busy")
        assert loop.pipelined_steps > 0
    finally:
        loop.stop()
    eng_b = _port(weights)
    cont = eng_b.import_request(snap)
    while not cont.finished:
        eng_b.step()
    assert cont.output_tokens == ref


# ---------------------------------------------------------------------------
# the reference's HTTP suite with port runners
# ---------------------------------------------------------------------------


def _serve_app(app, holder):
    started = threading.Event()
    box = {}

    def run():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        from aiohttp import web

        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        box["port"] = site._server.sockets[0].getsockname()[1]
        holder.setdefault("loops", []).append(loop)
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(10)
    return box["port"]


def _port_side(weights, name):
    """A port runner: the tiny float32 engine behind the port's server."""
    registry = ModelRegistry()
    loop = EngineLoop(_port(weights, eos=TOK.eos_ids), f"{name}-m1").start()
    registry.register(ServedModel(name=MODEL, loop=loop, tokenizer=TOK,
                                  context_length=256))
    api = OpenAIServer(registry)
    httpd = api.start()
    return {"loop": loop, "api": api, "httpd": httpd,
            "url": f"http://127.0.0.1:{httpd.server_address[1]}"}


def _jax_side(weights, name, holder):
    """A reference runner: the JAX engine behind its aiohttp server."""
    from helix_tpu.serving.openai_api import OpenAIServer as JServer

    registry = JRegistry()
    loop = JLoop(_ref(weights, eos=JTOK.eos_ids), f"{name}-m1").start()
    registry.register(JServed(name=MODEL, loop=loop, tokenizer=JTOK,
                              context_length=256))
    port = _serve_app(JServer(registry).build_app(), holder)
    return {"loop": loop, "url": f"http://127.0.0.1:{port}"}


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


@pytest.fixture(scope="module")
def cluster(weights):
    """The reference control plane (``HELIX_POOL_DISAGG=1``) with a port
    prefill runner, a port decode runner, and a reference runner of each
    role, all on the same weights; ``roles(pre, dec)`` heartbeats the two
    named runners into the pools and every other one out."""
    from helix_tpu.control.server import ControlPlane

    prior = os.environ.get("HELIX_POOL_DISAGG")
    os.environ["HELIX_POOL_DISAGG"] = "1"
    holder: dict = {}
    sides = {"r-pre": _port_side(weights, "r-pre"),
             "r-dec": _port_side(weights, "r-dec"),
             "j-pre": _jax_side(weights, "j-pre", holder),
             "j-dec": _jax_side(weights, "j-dec", holder)}
    cp = ControlPlane()
    cp_url = f"http://127.0.0.1:{_serve_app(cp.build_app(), holder)}"

    def heartbeat(rid, role):
        status_code, _ = _post(
            f"{cp_url}/api/v1/runners/{rid}/heartbeat",
            {"runner_id": rid, "address": sides[rid]["url"],
             "accelerators": [],
             "profile": {"name": "p", "status": "running",
                         "models": [MODEL]},
             "saturation": {}, "role": role}, timeout=10)
        assert status_code == 200

    def roles(pre, dec):
        for rid in sides:
            if rid not in (pre, dec):
                cp.router.remove(rid)
        heartbeat(pre, "prefill")
        heartbeat(dec, "decode")

    roles("r-pre", "r-dec")
    yield types.SimpleNamespace(sides=sides, cp=cp, cp_url=cp_url,
                                roles=roles)
    if prior is None:
        os.environ.pop("HELIX_POOL_DISAGG", None)
    else:
        os.environ["HELIX_POOL_DISAGG"] = prior
    cp.stop()
    for side in sides.values():
        side["loop"].stop(join=False)
        if "httpd" in side:
            side["httpd"].shutdown()
    for lp in holder.get("loops", []):
        lp.call_soon_threadsafe(lp.stop)


_MSG = [{"role": "user", "content": "split the pools, keep the tokens"}]


def _reference_content(url, max_tokens=40):
    status, raw = _post(f"{url}/v1/chat/completions", {
        "model": MODEL, "temperature": 0, "max_tokens": max_tokens,
        "messages": _MSG})
    assert status == 200, raw
    return json.loads(raw)["choices"][0]["message"]["content"]


def _stream_chat(url, max_tokens=40):
    content, errors, finish = [], [], None
    req = urllib.request.Request(
        f"{url}/v1/chat/completions",
        data=json.dumps({"model": MODEL, "temperature": 0,
                         "max_tokens": max_tokens, "stream": True,
                         "messages": _MSG}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data:"):
                continue
            payload = line[5:].strip()
            if payload == "[DONE]":
                break
            doc = json.loads(payload)
            if "error" in doc:
                errors.append(doc["error"])
                continue
            delta = doc["choices"][0]["delta"].get("content", "")
            if delta:
                content.append(delta)
            if doc["choices"][0].get("finish_reason"):
                finish = doc["choices"][0]["finish_reason"]
    return "".join(content), finish, errors


def _imported(side):
    return side["loop"].stats()["migration"]["imported"]


def test_http_handoff_stream_bit_identical_to_colocated(cluster):
    cluster.roles("r-pre", "r-dec")
    pre, dec = cluster.sides["r-pre"], cluster.sides["r-dec"]
    ref = _reference_content(dec["url"])
    assert ref == _reference_content(pre["url"])
    exports = pre["loop"].stats()["migration"]["prefill_exports"]
    imported = _imported(dec)
    handoffs = cluster.cp.router.pool_handoffs
    shipped = migration.XFER_STATS.snapshot()["prefill_handoffs"]
    content, finish, errors = _stream_chat(cluster.cp_url)
    assert errors == [], errors
    assert content == ref
    assert finish in ("stop", "length")
    assert pre["loop"].stats()["migration"]["prefill_exports"] == \
        exports + 1
    assert _imported(dec) == imported + 1
    assert cluster.cp.router.pool_handoffs == handoffs + 1
    assert migration.XFER_STATS.snapshot()["prefill_handoffs"] == \
        shipped + 1


def test_http_peer_unreachable_degrades_locally_bit_identical(cluster):
    cluster.roles("r-pre", "r-dec")
    dec = cluster.sides["r-dec"]
    ref = _reference_content(dec["url"])
    imported = _imported(dec)
    faults.arm(seed=3, rules=[
        {"point": "transfer", "peer": "r-dec", "mode": "drop"}])
    content, _finish, errors = _stream_chat(cluster.cp_url)
    faults.disarm()
    assert errors == [], errors
    assert content == ref
    assert _imported(dec) == imported


def test_http_corrupt_page_rejected_pre_mutation_then_degrades(cluster):
    cluster.roles("r-pre", "r-dec")
    dec = cluster.sides["r-dec"]
    ref = _reference_content(dec["url"])
    failures = dec["loop"].migration_failures
    faults.arm(seed=5, rules=[
        {"point": "transfer", "peer": "r-dec", "mode": "corrupt",
         "page": 0}])
    content, _finish, errors = _stream_chat(cluster.cp_url)
    faults.disarm()
    assert errors == [], errors
    assert content == ref
    assert dec["loop"].migration_failures > failures
    assert not dec["loop"].engine.has_work()


def test_http_prefill_runner_down_falls_back_to_decode_pool(cluster):
    cluster.roles("r-pre", "r-dec")
    ref = _reference_content(cluster.sides["r-dec"]["url"])
    fallbacks = cluster.cp.router.pool_handoff_fallbacks
    jfaults.arm(seed=7, rules=[
        {"point": "dispatch", "runner": "r-pre", "mode": "connect_error",
         "times": 1}])
    content, _finish, errors = _stream_chat(cluster.cp_url)
    jfaults.disarm()
    assert errors == [], errors
    assert content == ref
    assert cluster.cp.router.pool_handoff_fallbacks > fallbacks


def test_http_non_stream_requests_route_to_decode_pool(cluster):
    cluster.roles("r-pre", "r-dec")
    pre_loop = cluster.sides["r-pre"]["loop"]
    before = pre_loop.stats()["generated_tokens"]
    status, _raw = _post(f"{cluster.cp_url}/v1/chat/completions", {
        "model": MODEL, "temperature": 0, "max_tokens": 8,
        "messages": _MSG})
    assert status == 200
    assert pre_loop.stats()["generated_tokens"] == before


def test_http_non_stream_ignores_the_header(cluster):
    """A non-stream body that carries the disagg headers is served where
    it lands, as the reference's gate does."""
    pre = cluster.sides["r-pre"]
    exports = pre["loop"].stats()["migration"]["prefill_exports"]
    req = urllib.request.Request(
        f"{pre['url']}/v1/chat/completions",
        data=json.dumps({"model": MODEL, "temperature": 0, "max_tokens": 8,
                         "messages": _MSG}).encode(),
        headers={"Content-Type": "application/json",
                 migration.DISAGG_HEADER: "prefill",
                 migration.DISAGG_PEER_ID_HEADER: "r-dec",
                 migration.DISAGG_PEER_ADDR_HEADER:
                     cluster.sides["r-dec"]["url"]})
    with urllib.request.urlopen(req, timeout=60) as r:
        doc = json.loads(r.read())
    assert doc["choices"][0]["message"]["content"] == \
        _reference_content(pre["url"], max_tokens=8)
    assert pre["loop"].stats()["migration"]["prefill_exports"] == exports


def test_http_cluster_status_reports_pools(cluster):
    cluster.roles("r-pre", "r-dec")
    status, raw = _get(f"{cluster.cp_url}/v1/cluster/status")
    assert status == 200
    doc = json.loads(raw)
    assert doc["pools"]["disagg_enabled"] is True
    assert doc["pools"]["roles"]["prefill"] == 1
    assert doc["pools"]["roles"]["decode"] == 1
    roles = {r["id"]: r["role"] for r in doc["runners"]}
    assert roles == {"r-pre": "prefill", "r-dec": "decode"}


def test_http_metrics_render_disagg_families(cluster):
    cluster.roles("r-pre", "r-dec")
    _stream_chat(cluster.cp_url, max_tokens=8)
    _s, run = _get(f"{cluster.sides['r-pre']['url']}/metrics")
    assert "helix_xfer_attempts_total" in run
    assert "helix_xfer_prefill_handoffs_total" in run
    _s, cp = _get(f"{cluster.cp_url}/metrics")
    assert 'helix_cp_pool_runners{role="prefill"} 1' in cp
    assert "helix_cp_pool_handoffs_total" in cp
    assert "helix_cp_pool_disagg_enabled 1" in cp


@pytest.mark.parametrize("pre,dec", [("j-pre", "r-dec"), ("r-pre", "j-dec")],
                         ids=["reference-to-port", "port-to-reference"])
def test_http_handoff_across_backends(cluster, pre, dec):
    """The snapshot crosses packages in both directions: the stream
    equals colocated serving on either backend."""
    cluster.roles(pre, dec)
    try:
        ref = _reference_content(cluster.sides[dec]["url"])
        assert ref == _reference_content(cluster.sides[pre]["url"])
        imported = _imported(cluster.sides[dec])
        handoffs = cluster.cp.router.pool_handoffs
        content, finish, errors = _stream_chat(cluster.cp_url)
        assert errors == [], errors
        assert content == ref and finish in ("stop", "length")
        assert _imported(cluster.sides[dec]) == imported + 1
        assert cluster.cp.router.pool_handoffs == handoffs + 1
    finally:
        cluster.roles("r-pre", "r-dec")


# ---------------------------------------------------------------------------
# the control stub's handoff plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stub_pair(weights):
    """Two port runners heartbeating into a ``ControlStub``."""
    sides = {"p": _port_side(weights, "p"), "d": _port_side(weights, "d")}
    stub = ControlStub().start()
    for rid, role in (("p", "prefill"), ("d", "decode")):
        _post(f"{stub.url}/api/v1/runners/{rid}/heartbeat", {
            "runner_id": rid, "address": sides[rid]["url"], "role": role,
            "profile": {"name": "p", "status": "running",
                        "models": [MODEL]}})
    yield types.SimpleNamespace(stub=stub, sides=sides)
    stub.stop()
    for side in sides.values():
        side["loop"].stop(join=False)
        side["httpd"].shutdown()


def test_stub_plan_takes_each_rung(stub_pair):
    stub, sides = stub_pair.stub, stub_pair.sides
    body = {"messages": _MSG, "temperature": 0, "max_tokens": 24}
    ref = _reference_content(sides["d"]["url"], max_tokens=24)
    out = stub.disagg_request(MODEL, body, "p", "d")
    assert (out["rung"], out["peer"], out["errors"]) == ("handoff", "d", [])
    assert out["text"] == ref and out["finish"] in ("stop", "length")
    faults.arm(seed=1, rules=[
        {"point": "transfer", "peer": "d", "mode": "drop"}])
    out = stub.disagg_request(MODEL, body, "p", "d")
    faults.disarm()
    assert (out["rung"], out["text"], out["errors"]) == (
        "prefill_local", ref, [])
    # /v1/completions takes the same gate
    cbody = {"prompt": "split the pools, keep the tokens",
             "temperature": 0, "max_tokens": 24}
    _s, raw = _post(sides["d"]["url"] + "/v1/completions",
                    {"model": MODEL, **cbody})
    out = stub.disagg_request(MODEL, cbody, "p", "d",
                              path="/v1/completions")
    assert (out["rung"], out["errors"]) == ("handoff", [])
    assert out["text"] == json.loads(raw)["choices"][0]["text"]
    # the prefill node's address refuses connections: the fallback
    # dispatch serves the request on the decode node
    sides["p"]["httpd"].shutdown()
    sides["p"]["httpd"].server_close()
    out = stub.disagg_request(MODEL, body, "p", "d")
    assert (out["rung"], out["text"]) == ("fallback", ref)
    assert out["attempt_error"]


# ---------------------------------------------------------------------------
# reference behaviours the port matches (ROADMAP C)
# ---------------------------------------------------------------------------


def test_export_and_encode_run_on_the_engine_thread_like_reference(
        weights, monkeypatch):
    """The handoff's page gather, blake2b checksums and wire encode run
    on the prefill node's engine thread in both packages (the reference's
    ``_disagg_tick``): the handler only ships."""
    from helix_tpu.serving import engine_loop as jloop

    for pkg in ("port", "reference"):
        threads = []
        if pkg == "port":
            mod, eng = migration, _port(weights)
            loop = EngineLoop(eng, "m1")
            req = tengine.Request(id="t", prompt_tokens=list(range(7, 30)),
                                  sampling=SamplingParams(**GREEDY))
        else:
            mod, eng = jmigration, _ref(weights)
            loop = jloop.EngineLoop(eng, "m1")
            req = jengine.Request(id="t", prompt_tokens=list(range(7, 30)),
                                  sampling=jengine.SamplingParams(**GREEDY))
        to_wire = mod.snapshot_to_wire
        monkeypatch.setattr(mod, "snapshot_to_wire", lambda snap: (
            threads.append(threading.current_thread()), to_wire(snap))[1])
        loop.start()
        try:
            kind, wire, _ev = _staged(loop, req)
            assert kind == "snapshot" and wire["pages"]
            assert threads == [loop._thread], pkg
        finally:
            loop.abort("t")
            loop.stop()
        monkeypatch.undo()


def test_reference_tick_reads_an_undrained_staged_request_as_gone(weights):
    """The reference's tick looks a staged request up in the engine
    before its submit has left the loop's inbox, and fires ``gone`` (its
    handler then answers 502 ``disagg_failed``); the port's waits until
    the request reached the engine."""
    from helix_tpu.serving import engine_loop as jloop

    got = {"reference": [], "port": []}
    jl = jloop.EngineLoop(_ref(weights), "m1")
    jl.stage_disagg_export("r", lambda kind, wire: got["reference"].append(
        kind))
    jl.submit(jengine.Request(id="r", prompt_tokens=list(range(7, 30)),
                              sampling=jengine.SamplingParams(**GREEDY)),
              lambda ev: None)
    assert jl._handoff_work()
    jl._disagg_tick()
    tl = EngineLoop(_port(weights), "m1")
    tl.stage_disagg_export("r", lambda kind, wire: got["port"].append(kind))
    tl.submit(tengine.Request(id="r", prompt_tokens=list(range(7, 30)),
                              sampling=SamplingParams(**GREEDY)),
              lambda ev: None)
    assert not tl._handoff_work()
    tl._disagg_tick()
    assert got == {"reference": ["gone"], "port": []}
    tl._drain_inbox()          # the submit reaches the engine
    assert not tl._handoff_work()   # no token yet: nothing to do
    assert "r" in tl._disagg_cb


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_seeded_handoff_to_a_speculating_decoder_like_reference(weights,
                                                                spec):
    """A seeded request exported at its first token and continued on a
    decode engine, against the same request colocated on that engine's
    configuration: without speculation the tokens are the colocated ones
    (the equality the HTTP tests hold); with speculation on at both ends
    both packages give the same handoff and colocated tokens, whether or
    not those two agree (keys spent per drafted position and an
    acceptance EMA outside the snapshot: ROADMAP C)."""
    prompt = [int(x) for x in np.random.default_rng(0).integers(4, 250, 40)]
    samp = dict(temperature=0.8, max_tokens=60, seed=4321)
    kw = dict(enable_spec_decode=spec, spec_tokens=4)
    res = {}
    for pkg in ("port", "reference"):
        mod = tengine if pkg == "port" else jengine
        make = ((lambda: _port(weights, **kw)) if pkg == "port"
                else (lambda: _ref(weights, **kw)))
        smod = SamplingParams if pkg == "port" else jengine.SamplingParams
        colo = _run(make(), mod.Request(id="c", prompt_tokens=prompt,
                                        sampling=smod(**samp)))
        a, b = make(), make()
        req = mod.Request(id="h", prompt_tokens=prompt,
                          sampling=smod(**samp))
        _to_first_token(a, req)
        snap = a.export_prefill("h")
        cont = b.import_request(snap)
        while not cont.finished:
            b.step()
        res[pkg] = (list(cont.output_tokens), colo)
    assert res["port"] == res["reference"]
    handed, colo = res["port"]
    if not spec:
        assert handed == colo

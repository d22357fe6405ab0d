"""In-process hot-swap in the port: ``helix_tpu_torch.engine.residency``
against ``helix_tpu.engine.residency``, the server's residency surface,
the node's profile blocks, the loop's ``device_idle_ratio`` and the
Phi-3 family's shapes (group 1, head dim 96).

- Accounting: ``model_param_count``, ``estimate_model_bytes`` and
  ``host_tier_pages`` equal the reference's as integers for every catalog
  entry and the ``v5e1-hotswap`` entries as written (13,553,137,664 B and
  15,788,350,054 B); ``served_model_bytes`` equals the reference's on the
  tiny config in float32, bf16 and int8 weights over an int8 pool.
- The manager: every case of ``tests/test_residency.py``
  ``TestResidencyManager`` and ``TestAsyncPrefetch`` on tiny port models,
  and one scripted series of acquire / prefetch / evict / busy-acquire
  calls through both managers: the same resident sets, loads, evictions,
  return values and error texts.
- The server: a ``MemoryError`` from the registry answers 503
  ``overloaded_error`` with its text, ``/admin/prefetch`` answers 200,
  404 and 409; ``model@adapter`` resolution, ``POST /v1/adapters`` and
  ``/v1/models``' adapter entries; each status and body equals the
  reference server's.
- Phi-3-shaped parity (2 layers, H = KVH = 4, D 96, E 384, V 512):
  logits against ``helix_tpu.models.llama.forward``, float32 ``atol
  1e-4``; bf16 ``atol 1.2e-2``: logits up to |x| ~ 1.5, and the bf16
  elementwise chains that XLA keeps in float32 inside a fusion where
  PyTorch rounds each op (``tests/test_torch_model.py``) are six times
  as wide as the tiny config's, measured at 8.2e-3 to 9.5e-3 over six
  seeds (3.2e-3 at E 64).  Greedy tokens identical to the JAX ``Engine``
  (reference attention) in float32 and with bf16 weights over an int8
  pool.
"""

import asyncio
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from helix_tpu.engine import adapters as jad
from helix_tpu.engine import engine as jengine
from helix_tpu.engine import residency as jres
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models import common as jcommon
from helix_tpu.models import llama as jllama
from helix_tpu.ops.quant import quantize_params as jquantize
from helix_tpu.serving import engine_loop as jloop
from helix_tpu.serving import registry as jregistry
from helix_tpu.serving import tokenizer as jtokenizer
from helix_tpu_torch import cli
from helix_tpu_torch.control import node_agent as tagent
from helix_tpu_torch.control.profile import ServingProfile
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import residency as tres
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.models import common as tcommon
from helix_tpu_torch.models import llama as tllama
from helix_tpu_torch.ops.quant import quantize_params as tquantize
from helix_tpu_torch.serving import engine_loop as tloop
from helix_tpu_torch.serving import registry as tregistry
from helix_tpu_torch.serving import sched as tsched
from helix_tpu_torch.serving import tokenizer as ttokenizer
from helix_tpu_torch.serving.openai_api import OpenAIServer
from helix_tpu_torch.serving.tokenizer import ByteTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOTSWAP = os.path.join(ROOT, "profiles", "v5e1-hotswap.yaml")
GEOMETRY = dict(max_decode_batch=1, page_size=4, num_pages=32,
                max_pages_per_seq=8, max_prefill_len=32)


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


def _profile():
    with open(HOTSWAP) as f:
        return yaml.safe_load(f)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def _engine_blocks():
    blocks = {"defaults": {}}
    for m in _profile()["models"]:
        blocks[m["name"]] = m["engine"]
    return blocks


@pytest.mark.parametrize("name", sorted(tcommon.CATALOG))
def test_param_count_matches_reference(name):
    assert (tres.model_param_count(tcommon.CATALOG[name])
            == jres.model_param_count(jcommon.CATALOG[name]))


@pytest.mark.parametrize("quantization", [None, "int8"])
@pytest.mark.parametrize("block", sorted(_engine_blocks()))
@pytest.mark.parametrize("name", sorted(tcommon.CATALOG))
def test_estimate_matches_reference(name, block, quantization):
    engine = _engine_blocks()[block]
    want = jres.estimate_model_bytes(jcommon.CATALOG[name], engine,
                                     quantization)
    got = tres.estimate_model_bytes(tcommon.CATALOG[name], engine,
                                    quantization)
    assert got == want and isinstance(got, int)


def test_profile_entries_as_written():
    """The ``v5e1-hotswap`` entries as the profile writes them: the
    Llama entry fits the 14 GiB budget, the Phi-3 entry does not (a fault
    of the reference profile, ROADMAP C)."""
    prof = _profile()
    got = {m["name"]: tres.estimate_model_bytes(
        tcommon.CATALOG[m["name"]], m["engine"], m.get("quantization"))
        for m in prof["models"]}
    assert got == {"meta-llama/Meta-Llama-3-8B-Instruct": 13_553_137_664,
                   "microsoft/Phi-3-mini-4k-instruct": 15_788_350_054}
    budget = prof["residency"]["hbm_budget_bytes"]
    assert budget == 15_032_385_536
    assert got["meta-llama/Meta-Llama-3-8B-Instruct"] <= budget
    assert got["microsoft/Phi-3-mini-4k-instruct"] > budget
    # cut to 1024 pages, Phi-3 fits alone and never beside Llama
    phi = dict(prof["models"][1]["engine"], num_pages=1024)
    cut = tres.estimate_model_bytes(tcommon.CATALOG[
        "microsoft/Phi-3-mini-4k-instruct"], phi)
    assert cut == 12_097_362_534
    assert cut <= budget < cut + got["meta-llama/Meta-Llama-3-8B-Instruct"]


@pytest.mark.parametrize("budget", [1 << 33, 1 << 34])
@pytest.mark.parametrize("block", sorted(_engine_blocks()))
@pytest.mark.parametrize("name", sorted(tcommon.CATALOG))
def test_host_tier_pages_match_reference(name, block, budget):
    engine = _engine_blocks()[block]
    jcfg, tcfg = jcommon.CATALOG[name], tcommon.CATALOG[name]
    jcache = jengine.EngineConfig(**engine).cache_config(dtype=jcfg.dtype)
    tcache = tengine.EngineConfig(**engine).cache_config(dtype=tcfg.dtype)
    assert (tres.host_tier_pages(tcfg, tcache, budget)
            == jres.host_tier_pages(jcfg, jcache, budget))


def test_host_pool_budget_bytes(monkeypatch):
    monkeypatch.delenv("HELIX_KV_HOST_POOL_BYTES", raising=False)
    assert tres.host_pool_budget_bytes(7) == jres.host_pool_budget_bytes(7)
    monkeypatch.setenv("HELIX_KV_HOST_POOL_BYTES", "1234")
    assert tres.host_pool_budget_bytes() == jres.host_pool_budget_bytes()


@pytest.mark.parametrize("weights", ["float32", "bfloat16", "int8"])
def test_served_model_bytes_matches_reference(weights):
    """Weights + pools + scale pools of a live model, each side building
    its own tiny model (the port's ``quantize_params`` against the
    reference's), over an int8 KV pool."""
    dtype = "float32" if weights == "int8" else weights
    jcfg = jcommon.ModelConfig.tiny(dtype=dtype)
    tcfg = tcommon.ModelConfig.tiny(dtype=dtype)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tllama.init_params(tcfg, 0, device="cpu")
    if weights == "int8":
        jp, tp = jquantize(jp), tquantize(tp)
    geo = dict(GEOMETRY, kv_cache_dtype="int8")
    je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **geo, attn_backend="reference"))
    te = tengine.Engine(tcfg, tp, tengine.EngineConfig(**geo), device="cpu")
    jm = jregistry.ServedModel(name="m", loop=jloop.EngineLoop(je, "m"),
                               tokenizer=None)
    tm = tregistry.ServedModel(name="m", loop=tloop.EngineLoop(te, "m"),
                               tokenizer=None)
    for headroom in (0.0, 0.10):
        assert (tres.served_model_bytes(tm, headroom)
                == jres.served_model_bytes(jm, headroom))
    assert tres.tree_bytes(tp) == jres.tree_bytes(jp)


@pytest.mark.parametrize("over", [
    {}, {"tie_word_embeddings": True}, {"attention_bias": True},
    {"qk_norm": True}, {"num_heads": 4, "num_kv_heads": 4, "head_dim": 96},
])
def test_int8_init_equals_quantized_init(over):
    """``init_params(..., quantization="int8")``, which quantizes each
    weight as it is drawn (the int8 build never holds the bf16 model),
    equals ``quantize_params(init_params(...))`` to the byte."""
    cfg = tcommon.ModelConfig.tiny(**over)
    fused = tllama.init_params(cfg, 5, device="cpu", quantization="int8")
    whole = tquantize(tllama.init_params(cfg, 5, device="cpu"))

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v

    a, b = dict(leaves(fused)), dict(leaves(whole))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert a[("layers", "wq", "weight")].dtype == torch.int8


def test_estimate_close_to_measured():
    m = _t_model("estimate-check")
    measured = tres.served_model_bytes(m, headroom=0.0)
    est = tres.estimate_model_bytes(m.loop.engine.model_cfg, GEOMETRY,
                                    headroom=0.0)
    assert 0.8 < est / measured < 1.3, (est, measured)
    tres.release_served_model(m)


# ---------------------------------------------------------------------------
# the manager (tests/test_residency.py on port models)
# ---------------------------------------------------------------------------


def _seed(name: str) -> int:
    return zlib.crc32(name.encode()) % 1000


def _t_model(name: str) -> tregistry.ServedModel:
    cfg = tcommon.ModelConfig.tiny(dtype="float32", name=name)
    params = tllama.init_params(cfg, _seed(name), device="cpu")
    eng = tengine.Engine(cfg, params, tengine.EngineConfig(**GEOMETRY),
                         device="cpu")
    return tregistry.ServedModel(
        name=name, loop=tloop.EngineLoop(eng, name).start(),
        tokenizer=ByteTokenizer())


def _j_model(name: str) -> jregistry.ServedModel:
    cfg = jcommon.ModelConfig.tiny(dtype="float32", name=name)
    params = jllama.init_params(cfg, jax.random.PRNGKey(_seed(name)))
    eng = jengine.Engine(cfg, params, jengine.EngineConfig(
        **GEOMETRY, attn_backend="reference"))
    return jregistry.ServedModel(
        name=name, loop=jloop.EngineLoop(eng, name).start(),
        tokenizer=jtokenizer.ByteTokenizer())


def _unit() -> int:
    return tres.served_model_bytes(_t_model("probe"), headroom=0.0)


def _busy(model, mod) -> None:
    """Park an unfinished request so the engine reports work (the loop
    frozen, so it cannot drain it mid-test)."""
    model.loop.stop(join=True)
    model.loop.engine.add_request(mod.Request(
        id="busy", prompt_tokens=[1, 2, 3],
        sampling=mod.SamplingParams(max_tokens=1000)))


class TestResidencyManager:
    def _mgr(self, budget_models: float):
        mgr = tres.ResidencyManager(
            int(_unit() * budget_models), build=_t_model,
            measure=lambda m: tres.served_model_bytes(m, headroom=0.0))
        for n in ("model-a", "model-b"):
            mgr.register_name(n)
        return mgr

    def test_lru_hot_swap(self):
        mgr = self._mgr(1.5)   # fits exactly one model
        a = mgr.acquire("model-a")
        assert mgr.resident_names() == ["model-a"]
        mgr.acquire("model-b")
        assert mgr.resident_names() == ["model-b"]  # a evicted (idle LRU)
        assert mgr.evictions == 1 and mgr.loads == 2
        mgr.acquire("model-b")  # hit, no reload
        assert mgr.loads == 2
        # the evicted model's engine let go of its tensors
        assert a.loop.stopped and a.loop.engine.params is None
        assert a.loop.engine.cache is None

    def test_budget_fits_both(self):
        mgr = self._mgr(3.0)
        mgr.acquire("model-a")
        mgr.acquire("model-b")
        assert mgr.resident_names() == ["model-a", "model-b"]
        assert mgr.evictions == 0

    def test_busy_model_not_evicted(self):
        mgr = self._mgr(1.5)
        a = mgr.acquire("model-a")
        _busy(a, tengine)
        with pytest.raises(MemoryError):
            mgr.acquire("model-b")
        assert a.loop.engine.params is not None   # untouched
        a.loop.engine.abort("busy")
        mgr.acquire("model-b")
        assert mgr.resident_names() == ["model-b"]

    def test_unknown_model_none(self):
        mgr = self._mgr(2)
        assert mgr.get("nope") is None


class TestAsyncPrefetch:
    def _mgr_with_gate(self, budget_models: float):
        gate = threading.Event()
        builds = []

        def build(name):
            builds.append(name)
            if name == "model-b":
                assert gate.wait(30), "test gate never opened"
            return _t_model(name)

        mgr = tres.ResidencyManager(
            int(_unit() * budget_models), build=build,
            measure=lambda m: tres.served_model_bytes(m, headroom=0.0))
        for n in ("model-a", "model-b"):
            mgr.register_name(n)
        return mgr, gate, builds

    def test_inflight_model_keeps_decoding_during_prefetch(self):
        mgr, gate, builds = self._mgr_with_gate(3.0)
        a = mgr.acquire("model-a")
        assert mgr.prefetch("model-b") is True
        try:
            a.loop.stop(join=True)   # single-owner stepping for the test
            toks = a.loop.engine.generate(
                [[1, 2, 3, 4, 5]],
                tsampling.SamplingParams(temperature=0.0, max_tokens=4))[0]
            assert len(toks) == 4
            assert "model-b" in builds     # load genuinely in flight
            assert mgr.resident_names() == ["model-a"]   # not swapped yet
        finally:
            gate.set()
        b = mgr.acquire("model-b")     # waits for the in-flight load
        assert b.name == "model-b"
        assert builds.count("model-b") == 1, "prefetch+acquire double-built"
        assert sorted(mgr.resident_names()) == ["model-a", "model-b"]
        assert "model-b" in mgr.swap_seconds
        assert "model-b" in mgr.load_seconds

    def test_sync_swap_records_latency(self):
        mgr, gate, _ = self._mgr_with_gate(1.5)
        gate.set()
        mgr.acquire("model-a")
        mgr.acquire("model-b")         # evicts a, builds b synchronously
        assert mgr.swap_seconds["model-b"] > 0
        assert (mgr.load_seconds["model-b"]
                >= mgr.swap_seconds["model-b"] * 0.5)

    def test_prefetch_declines_when_only_busy_models_fit(self):
        mgr, gate, builds = self._mgr_with_gate(1.5)
        gate.set()
        a = mgr.acquire("model-a")
        _busy(a, tengine)
        mgr._estimate = lambda name: mgr.budget  # force "must evict"
        assert mgr.prefetch("model-b") is False
        assert builds == ["model-a"]

    def test_prefetch_error_delivered_to_acquire(self):
        def build(name):
            raise RuntimeError("checkpoint corrupt")

        mgr = tres.ResidencyManager(int(_unit() * 2), build=build)
        mgr.register_name("model-a")
        assert mgr.prefetch("model-a") is True
        with pytest.raises(RuntimeError, match="checkpoint corrupt"):
            mgr.acquire("model-a")


def _scripted(res, mk, mod, with_estimate: bool) -> list:
    """One series of calls through ``res.ResidencyManager`` on models of
    one package; every model weighs one unit, the budget is 1.5 units.
    Returns a trace: (call, result or error text, resident set, loads,
    evictions) per step."""
    unit = 1 << 26
    mgr = res.ResidencyManager(
        unit * 3 // 2, build=mk, measure=lambda m: unit,
        estimate=(lambda name: unit) if with_estimate else None)
    for n in ("a", "b"):
        mgr.register_name(n)
    held = {}

    def prefetch_and_wait(name):
        out = mgr.prefetch(name)
        deadline = time.monotonic() + 60
        while name in mgr._loading and time.monotonic() < deadline:
            time.sleep(0.01)
        return out

    calls = [
        ("acquire", "a"), ("acquire", "b"), ("acquire", "b"),
        ("prefetch", "a"), ("acquire", "a"), ("busy", "a"),
        ("acquire", "b"), ("prefetch", "b"), ("idle", "a"),
        ("acquire", "b"), ("get", "nope"), ("prefetch", "a"),
        ("acquire", "a"), ("evict", "a"), ("acquire", "b"),
    ]
    trace = []
    for op, name in calls:
        try:
            if op == "acquire":
                held[name] = mgr.acquire(name)
                out = held[name].name
            elif op == "get":
                out = mgr.get(name)
            elif op == "prefetch":
                out = prefetch_and_wait(name)
            elif op == "busy":
                _busy(held[name], mod)
                out = None
            elif op == "idle":
                held[name].loop.engine.abort("busy")
                out = None
            else:
                out = mgr.evict(name)
        except MemoryError as e:
            out = f"MemoryError: {e}"
        trace.append((op, name, out, mgr.resident_names(), mgr.loads,
                      mgr.evictions))
    for name in mgr.resident_names():
        mgr.evict(name)
    return trace


@pytest.mark.parametrize("with_estimate", [True, False])
def test_scripted_sequence_matches_reference(with_estimate):
    got = _scripted(tres, _t_model, tengine, with_estimate)
    want = _scripted(jres, _j_model, jengine, with_estimate)
    assert got == want
    # the series reaches every branch: a busy refusal, a declined
    # prefetch (estimate path), an eviction by prefetch, a reload
    assert any(str(out).startswith("MemoryError") for _, _, out, *_ in got)
    assert got[-1][3] == ["b"] and got[-1][5] >= 4


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reference_server(registry):
    """The reference's aiohttp server on a thread: (base url, stop)."""
    from aiohttp import web

    from helix_tpu.serving.openai_api import OpenAIServer as JServer

    app = JServer(registry).build_app()
    port = _free_port()
    started = threading.Event()
    holder = {}

    def run():
        aloop = asyncio.new_event_loop()
        asyncio.set_event_loop(aloop)
        runner = web.AppRunner(app)
        aloop.run_until_complete(runner.setup())
        aloop.run_until_complete(
            web.TCPSite(runner, "127.0.0.1", port).start())
        holder["loop"], holder["runner"] = aloop, runner
        started.set()
        aloop.run_forever()
        aloop.run_until_complete(runner.cleanup())

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(30)

    def stop():
        holder["loop"].call_soon_threadsafe(holder["loop"].stop)

    return f"http://127.0.0.1:{port}", stop


def _port_server(registry):
    httpd = OpenAIServer(registry, inter_token_timeout=60).start()

    def stop():
        httpd.shutdown()
        httpd.server_close()

    return f"http://127.0.0.1:{httpd.server_address[1]}", stop


def _call(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _surface(res, registry_mod, mk, start):
    """Residency routes of one server: (status, body) per call."""
    out = {}
    # no residency manager behind the registry: 409
    base, stop = start(registry_mod.ModelRegistry())
    try:
        out["no_manager"] = _call(base, "/admin/prefetch", {"model": "a"})
    finally:
        stop()
    unit = 1 << 26
    mgr = res.ResidencyManager(4 * unit, build=mk, measure=lambda m: unit,
                               estimate=lambda n: 8 * unit
                               if n == "huge" else unit)
    for n in ("a", "huge"):
        mgr.register_name(n)
    base, stop = start(mgr)
    try:
        out["unknown"] = _call(base, "/admin/prefetch", {"model": "nope"})
        out["started"] = _call(base, "/admin/prefetch", {"model": "a"})
        deadline = time.monotonic() + 60
        while mgr.resident_names() != ["a"] and time.monotonic() < deadline:
            time.sleep(0.02)
        out["declined"] = _call(base, "/admin/prefetch", {"model": "huge"})
        out["too_big"] = _call(base, "/v1/chat/completions", {
            "model": "huge", "max_tokens": 2, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]})
        status, body = _call(base, "/v1/chat/completions", {
            "model": "a", "max_tokens": 2, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]})
        out["served"] = (status, body["object"])
        out["healthz"] = _call(base, "/healthz")
        models = _call(base, "/v1/models")
        out["models"] = (models[0], [m["id"] for m in models[1]["data"]])
    finally:
        stop()
        for name in mgr.resident_names():
            mgr.evict(name)
    return out


def test_server_residency_surface_matches_reference():
    got = _surface(tres, tregistry, _t_model, _port_server)
    want = _surface(jres, jregistry, _j_model, _reference_server)
    assert got == want
    assert got["no_manager"][0] == 409
    assert got["unknown"][0] == 404
    assert got["started"] == (200, {"model": "a", "prefetch": "started"})
    assert got["declined"] == (200, {"model": "huge",
                                     "prefetch": "declined"})
    status, body = got["too_big"]
    assert status == 503 and body["error"]["type"] == "overloaded_error"
    assert body["error"]["message"].startswith("cannot fit model 'huge'")
    assert got["served"] == (200, "chat.completion")
    assert got["healthz"][1]["models"] == ["a", "huge"]
    assert got["models"] == (200, ["a"])


def _adapter_models(loop_mod, reg_mod, tok_mod, mk_engine):
    """A registry of one package with ``tiny-ad`` (3 adapter slots of
    rank 4, adapter ``a1`` published) and ``tiny-plain`` (no pool)."""
    rng = np.random.default_rng(12)
    cfg = tcommon.ModelConfig.tiny(dtype="float32")
    dims = {"wq": (cfg.hidden_size, cfg.num_heads * cfg.head_dim),
            "wo": (cfg.num_heads * cfg.head_dim, cfg.hidden_size)}
    lora = {t: {"lora_a": rng.standard_normal(
                    (cfg.num_layers, i, 4)).astype(np.float32) * 0.1,
                "lora_b": rng.standard_normal(
                    (cfg.num_layers, 4, o)).astype(np.float32) * 0.1}
            for t, (i, o) in dims.items()}
    reg = reg_mod.ModelRegistry()
    for name, slots in (("tiny-ad", 3), ("tiny-plain", 0)):
        eng = mk_engine(name, dict(GEOMETRY, adapter_pool_slots=slots,
                                   adapter_rank=4))
        if slots:
            eng.publish_adapter("a1", lora, 2.0)
        reg.register(reg_mod.ServedModel(
            name=name, loop=loop_mod.EngineLoop(eng, name).start(),
            tokenizer=tok_mod.ByteTokenizer()))
    return reg


def _t_engine(name, kw):
    cfg = tcommon.ModelConfig.tiny(dtype="float32", name=name)
    return tengine.Engine(cfg, tllama.init_params(cfg, 5, device="cpu"),
                          tengine.EngineConfig(**kw), device="cpu")


def _j_engine(name, kw):
    cfg = jcommon.ModelConfig.tiny(dtype="float32", name=name)
    return jengine.Engine(cfg, jllama.init_params(cfg, jax.random.PRNGKey(5)),
                          jengine.EngineConfig(**kw,
                                               attn_backend="reference"))


def _adapter_surface(registry, start) -> dict:
    chat = {"max_tokens": 2, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]}
    base, stop = start(registry)
    out = {}
    try:
        for key, model in (("unknown", "tiny-ad@does-not-exist"),
                           ("hostile", "tiny-ad@../../etc/passwd"),
                           ("empty", "tiny-ad@"),
                           ("no_pool", "tiny-plain@a1"),
                           ("no_model", "nope@a1")):
            out[key] = _call(base, "/v1/chat/completions",
                             {**chat, "model": model})
        status, body = _call(base, "/v1/chat/completions",
                             {**chat, "model": "tiny-ad@a1"})
        out["served"] = (status, body["object"],
                         body["usage"]["completion_tokens"])
        status, body = _call(base, "/v1/completions", {
            "model": "tiny-ad@a1", "prompt": "ab", "max_tokens": 2})
        out["completion"] = (status, body["object"])
        for key, body in (
                ("bad_name", {"model": "tiny-ad", "name": "../evil",
                              "checkpoint": "/nope"}),
                ("no_ckpt", {"model": "tiny-ad", "name": "a2"}),
                ("pub_no_model", {"model": "nope", "name": "a2",
                                  "checkpoint": "/nope"}),
                ("pub_no_pool", {"model": "tiny-plain", "name": "a2",
                                 "checkpoint": "/nope"})):
            out[key] = _call(base, "/v1/adapters", body)
        status, body = _call(base, "/v1/models")
        out["models"] = (status, [(m["id"], m.get("parent"))
                                  for m in body["data"]])
    finally:
        stop()
        for name in registry.names():
            registry.unregister(name)
    return out


def test_adapter_http_surface_matches_reference():
    """``model@adapter`` resolution, ``POST /v1/adapters``' checks and
    ``/v1/models``' adapter entries: each status and body equals the
    reference server's."""
    got = _adapter_surface(_adapter_models(
        tloop, tregistry, ttokenizer, _t_engine), _port_server)
    want = _adapter_surface(_adapter_models(
        jloop, jregistry, jtokenizer, _j_engine), _reference_server)
    assert got == want
    for key in ("unknown", "hostile", "empty", "no_pool", "no_model"):
        assert got[key][0] == 404, key
    assert "not published" in got["unknown"][1]["error"]["message"]
    assert "does not serve adapters" in got["no_pool"][1]["error"]["message"]
    assert got["served"][:2] == (200, "chat.completion")
    assert got["completion"] == (200, "text_completion")
    assert got["bad_name"][0] == got["no_ckpt"][0] == 400
    assert got["pub_no_model"][0] == 404 and got["pub_no_pool"][0] == 409
    assert got["models"] == (200, [("tiny-ad", None),
                                   ("tiny-ad@a1", "tiny-ad"),
                                   ("tiny-plain", None)])


def test_adapter_checkpoint_publish_answers_a18(monkeypatch, tmp_path):
    """``POST /v1/adapters`` publishes a LoRA training checkpoint (the
    port's format, ROADMAP A18): 200 with the reference's body, the
    adapter listed in ``/v1/models`` and served; a missing checkpoint is
    a 404 with the reference store's text; the runner token gates the
    route; an adapter request that reaches a pool-less engine is a 400
    with the reference engine's text."""
    from helix_tpu_torch.serving import openai_api
    from helix_tpu_torch.training.checkpoint import save_checkpoint

    rng = np.random.default_rng(21)
    cfg = tcommon.ModelConfig.tiny(dtype="float32")
    E, HD = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    tree = {t: {"lora_a": torch.from_numpy(rng.standard_normal(
                    (cfg.num_layers, i, 4)).astype(np.float32) * 0.1),
                "lora_b": torch.from_numpy(rng.standard_normal(
                    (cfg.num_layers, 4, o)).astype(np.float32) * 0.1)}
            for t, (i, o) in (("wq", (E, HD)), ("wo", (HD, E)))}
    ckpt = str(tmp_path / "sft")
    save_checkpoint(ckpt, 7, tree, {"count": 7}, lora_scaling=2.0)
    reg = _adapter_models(tloop, tregistry, ttokenizer, _t_engine)
    base, stop = _port_server(reg)
    try:
        body = {"model": "tiny-ad", "name": "a2", "checkpoint": ckpt}
        status, out = _call(base, "/v1/adapters", body)
        assert status == 200, out
        assert out == {"id": "tiny-ad@a2", "object": "model",
                       "parent": "tiny-ad", "rank": 4, "scale": 2.0,
                       "bytes": sum(int(f[n].numel()) * 4 for f in
                                    tree.values() for n in f)}
        ids = [m["id"] for m in _call(base, "/v1/models")[1]["data"]]
        assert "tiny-ad@a2" in ids
        status, out = _call(base, "/v1/chat/completions", {
            "model": "tiny-ad@a2", "max_tokens": 2, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]})
        assert status == 200 and out["usage"]["completion_tokens"] == 2
        missing = str(tmp_path / "none")
        status, out = _call(base, "/v1/adapters",
                            {**body, "checkpoint": missing})
        with pytest.raises(FileNotFoundError) as ref:
            jad.AdapterStore("tiny-ad", {}, 2, 4).publish_checkpoint(
                "a2", missing)
        assert status == 404 and out["error"]["message"] == str(ref.value)
        monkeypatch.setenv("HELIX_RUNNER_TOKEN", "s3cret")
        assert _call(base, "/v1/adapters", body)[0] == 403
        plain = reg.get("tiny-plain")
        gen = OpenAIServer(reg).generate(
            plain, [1, 2, 3], tsampling.SamplingParams(max_tokens=2),
            adapter="a1")
        with pytest.raises(openai_api.EngineRequestError) as e:
            next(gen)
        status, err, _ = openai_api._engine_error(e.value)
        jeng = _j_engine("x", dict(GEOMETRY))
        assert status == 400 and err["error"]["message"] == \
            jeng.validate_request(jengine.Request(
                id="r", prompt_tokens=[1, 2, 3], adapter="a1"))
    finally:
        stop()
        for name in reg.names():
            reg.unregister(name)


def test_delegating_registry_takes_either_store():
    reg = tregistry.DelegatingRegistry()
    m = _t_model("plain")
    reg.register(m)
    assert reg.names() == ["plain"] and reg.get("plain") is m
    reg.unregister("plain")
    assert reg.names() == []
    mgr = tres.ResidencyManager(1 << 40, build=_t_model)
    mgr.register_name("lazy")
    reg = tregistry.DelegatingRegistry(mgr)
    assert reg.names() == ["lazy"] and reg.list() == []
    assert reg.get("lazy").name == "lazy"
    reg.unregister("lazy")          # the manager evicts
    assert mgr.resident_names() == [] and mgr.evictions == 1


# ---------------------------------------------------------------------------
# the node's profile blocks
# ---------------------------------------------------------------------------


def _args(profile_path, random_weights=True):
    return type("A", (), {"profile": str(profile_path), "engine": None,
                          "model": None, "random_weights": random_weights,
                          "seed": 0})


def _write(tmp_path, profile) -> str:
    p = tmp_path / "p.json"
    p.write_text(json.dumps(profile))
    return str(p)


def _applied(profile_path, build_model=None):
    """The registry of a node agent that applied the profile at
    ``profile_path`` as ``serve-node --profile <path> --random-weights``
    does, on the CPU without warmup."""
    agent = tagent.NodeAgent("t", build_model=build_model, device="cpu",
                             warmup=False, random_weights=True)
    state = agent.apply_profile(ServingProfile.from_dict(
        cli._load_profile(profile_path)))
    assert state.status == "running", state.error
    return agent.registry


def _entry(name="tiny-a", **extra):
    return {"name": name, "model_overrides": {"dtype": "float32"},
            "engine": dict(GEOMETRY), **extra}


@pytest.fixture
def no_weights(monkeypatch):
    """Fails the test if any weights are made."""
    def refuse(*a, **k):
        raise AssertionError("weights were made")

    monkeypatch.setattr(cli, "init_params", refuse)


@pytest.mark.parametrize("slo", [
    {"ttft_p95_seconds": 2.0},
    {"ttft_p95_seconds": 2.0, "sched": {"policy": "wfq"}},
])
def test_slo_block_raises_naming_a7(tmp_path, slo):
    """The slo block (ROADMAP A7) is served now: no refusal; the entry's
    targets reach the loop's SLO observer and its ``sched`` block picks
    the scheduler, as the reference node agent's ``_make_engine_loop``
    does.  (The name dates from when the port refused the block.)"""
    path = _write(tmp_path, {"models": [_entry(slo=slo)]})
    (spec,) = cli._model_specs(_args(path))
    assert spec["slo"] == slo
    reg = _applied(path)
    try:
        loop = reg.get("tiny-a").loop
        assert loop.slo.targets.ttft_p95_seconds == 2.0
        want = slo.get("sched", {}).get("policy", "fifo")
        assert loop.sched.name == want
        assert loop.sched.active == (want == "wfq")
    finally:
        reg.unregister("tiny-a")


@pytest.mark.parametrize("mesh", [{"tp": 2, "pp": 2}, {"tp": 1, "sp": 4},
                                  {"dp": 8}])
def test_mesh_beyond_one_device_raises_naming_a15(tmp_path, no_weights,
                                                  mesh):
    """A mesh axis other than ``tp`` is refused by name (A15b's later
    parts); ``tp`` alone is served (``tests/test_torch_tp.py``)."""
    path = _write(tmp_path, {"models": [_entry(mesh=mesh)]})
    with pytest.raises(NotImplementedError, match="mesh.*A15"):
        cli.main(["serve-node", "--profile", path, "--device", "cpu",
                  "--port", "0"])


def test_mesh_of_one_device_is_served(tmp_path):
    path = _write(tmp_path, {"models": [_entry(mesh={"tp": 1})]})
    reg = _applied(path)
    try:
        assert reg.names() == ["tiny-a"] and reg.get("tiny-a") is not None
    finally:
        reg.unregister("tiny-a")


def test_hotswap_profile_as_written_refused_before_weights(no_weights):
    """``serve-node --profile profiles/v5e1-hotswap.yaml
    --random-weights`` gets past ``_model_specs`` with nothing refused
    and nothing built: the Llama entry keeps its ``slo`` block with its
    WFQ ``sched`` (A7) and its adapter fields; Phi-3 has no ``slo``.
    (The name dates from when the port refused the profile as written.)"""
    llama, phi = cli._model_specs(_args(HOTSWAP))
    assert llama["name"] == "meta-llama/Meta-Llama-3-8B-Instruct"
    assert llama["slo"]["ttft_p95_seconds"] == 2.0
    assert llama["slo"]["sched"]["policy"] == "wfq"
    assert llama["engine"]["adapter_pool_slots"] == 8
    assert "Phi-3" in phi["name"] and phi["slo"] is None
    cfg = tsched.SchedConfig.from_profile(llama["slo"])
    assert (cfg.policy, cfg.max_tenant_queue_depth,
            cfg.prefill_budget_tokens, cfg.prefill_budget_min_tokens) == (
                "wfq", 64, 4096, 512)


def test_residency_profile_builds_the_manager_lazily(tmp_path):
    """A top-level ``residency`` block: a ResidencyManager with the
    block's budget, every name registered, nothing built until a
    request; the estimate is the reference node agent's (catalog config,
    the entry's engine block, its quantization)."""
    profile = {"residency": {"hbm_budget_bytes": 1 << 40},
               "models": [_entry("tiny-a"),
                          _entry("tiny-b", quantization="int8")]}
    path = _write(tmp_path, profile)
    built = []

    def build(**kw):
        built.append(kw["name"])
        return cli.build_served_model(**kw)

    reg = _applied(path, build_model=build)
    mgr = reg.inner
    assert isinstance(mgr, tres.ResidencyManager)
    assert mgr.budget == 1 << 40 and built == []
    assert reg.names() == ["tiny-a", "tiny-b"] and mgr.resident_names() == []
    for name, quant in (("tiny-a", None), ("tiny-b", "int8")):
        jcfg = jcommon.ModelConfig.tiny(name=name)
        assert mgr._estimate(name) == jres.estimate_model_bytes(
            jcfg, GEOMETRY, quant)
    served = reg.get("tiny-b")
    assert built == ["tiny-b"] and mgr.resident_names() == ["tiny-b"]
    assert served.loop.engine.params["layers"]["wq"]["weight"].dtype == \
        torch.int8
    reg.unregister("tiny-b")
    assert mgr.resident_names() == []


def test_residency_budget_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(tagent, "total_device_bytes", lambda device: 12345)
    reg = _applied(_write(tmp_path, {
        "residency": {"other": 1},
        "models": [dict(name="tiny-a", engine=dict(GEOMETRY))]}))
    assert reg.inner.budget == 12345 and reg.inner.resident_names() == []


# ---------------------------------------------------------------------------
# device_idle_ratio: the reference's charge
# ---------------------------------------------------------------------------

IDLE_WAIT = 0.6


def _idle_charge(loop, mod, recorded, records) -> tuple:
    """Serve one short request, idle IDLE_WAIT seconds, serve it again;
    returns (idle seconds charged over the second request's steps, the
    loop's device_idle_ratio over them)."""

    def serve(rid):
        done = threading.Event()
        loop.submit(mod.Request(
            id=rid, prompt_tokens=[5, 6, 7],
            sampling=mod.SamplingParams(temperature=0.0, max_tokens=2)),
            lambda ev: ev.finished and done.set())
        assert done.wait(120)

    serve("first")
    time.sleep(IDLE_WAIT)
    n0 = recorded()
    serve("second")
    time.sleep(0.1)     # the last step's record lands after its emission
    recs = records(recorded() - n0)
    return (sum(r["idle_gap_s"] for r in recs),
            sum(r["idle_gap_s"] for r in recs)
            / sum(r["wall_s"] for r in recs))


def test_device_idle_ratio_charges_as_the_reference():
    """Both loops charge the wait for work as device idle and start a
    step's wall at its own dispatch: after an idle spell the first step's
    gap holds the whole wait, and the ratio exceeds 1."""
    tcfg = tcommon.ModelConfig.tiny(dtype="float32")
    jcfg = jcommon.ModelConfig.tiny(dtype="float32")
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tp = tllama.params_from_jax(jax.device_get(jp))
    jl = jloop.EngineLoop(jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **GEOMETRY, attn_backend="reference")), "j").start()
    tl = tloop.EngineLoop(tengine.Engine(
        tcfg, tp, tengine.EngineConfig(**GEOMETRY), device="cpu"),
        "t").start()
    try:
        j_gap, j_ratio = _idle_charge(
            jl, jengine, lambda: jl.flight.steps_recorded,
            lambda n: jl.flight.snapshot(recent=n)["recent"])
        t_gap, t_ratio = _idle_charge(
            tl, tengine, lambda: tl.window.recorded,
            lambda n: list(tl.window._ring)[-n:])
    finally:
        jl.stop()
        tl.stop()
    # the gap also holds the wake-up poll (50 ms) and the first step's
    # build, which a loaded test machine stretches: bounds, not equality
    for gap, ratio in ((j_gap, j_ratio), (t_gap, t_ratio)):
        assert IDLE_WAIT <= gap < IDLE_WAIT + 2.0, (gap, ratio)
        assert ratio > 1.0, (gap, ratio)
    assert abs(t_gap - j_gap) < 1.0, (t_gap, j_gap)
    assert tl.device_idle_ratio() > 1.0


# ---------------------------------------------------------------------------
# Phi-3's shapes: group 1, head dim 96
# ---------------------------------------------------------------------------

PHI3_TINY = dict(num_layers=2, num_heads=4, num_kv_heads=4, head_dim=96,
                 hidden_size=384, intermediate_size=512, vocab_size=512,
                 rope_theta=10000.0)


def _phi3_pair(dtype):
    jcfg = jcommon.ModelConfig.tiny(**PHI3_TINY, dtype=dtype)
    tcfg = tcommon.ModelConfig.tiny(**PHI3_TINY, dtype=dtype)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, tcfg, jp, tllama.params_from_jax(jax.device_get(jp))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 1.2e-2)])
def test_phi3_shaped_logits_match_jax(dtype, atol):
    jcfg, tcfg, jp, tp = _phi3_pair(dtype)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, tcfg.vocab_size, size=(2, 9)).astype(np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1)) + 3
    seg = np.ones_like(tok)
    j_logits, _ = jllama.forward(
        jp, jcfg, tok, pos,
        attn_fn=lambda q, k, v, c, p: jllama.prefill_attn_fn(
            q, k, v, c, p, segment_ids=seg, backend="reference"))
    t_logits, _ = tllama.forward(
        tp, tcfg, torch.from_numpy(tok), torch.from_numpy(pos),
        attn_fn=lambda q, k, v, c, p: tllama.prefill_attn_fn(
            q, k, v, c, p, segment_ids=torch.from_numpy(seg)))
    np.testing.assert_allclose(t_logits.float().numpy(),
                               np.asarray(j_logits, np.float32), atol=atol)


PHI3_GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=128,
                     max_pages_per_seq=16, max_prefill_len=16)


@pytest.mark.parametrize("dtype,kv", [("float32", "auto"),
                                      ("bfloat16", "int8")])
def test_phi3_shaped_greedy_tokens_match_jax_engine(dtype, kv):
    """Packed prompts, a chunked prompt, decode and a prefix hit at group
    1 and head dim 96: greedy tokens identical to the JAX engine."""
    jcfg, tcfg, jp, tp = _phi3_pair(dtype)
    geo = dict(PHI3_GEOMETRY, kv_cache_dtype=kv)
    je = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **geo, attn_backend="reference"))
    te = tengine.Engine(tcfg, tp, tengine.EngineConfig(**geo), device="cpu")
    prompts = [[1, 2, 3, 4, 5], [10, 11, 12], [(3 * i) % 29 + 1
                                               for i in range(40)]]
    js = jsampling.SamplingParams(temperature=0.0, max_tokens=8)
    ts = tsampling.SamplingParams(temperature=0.0, max_tokens=8)
    assert te.generate(prompts, ts) == je.generate(prompts, js)
    # the chunked prompt again: a prefix-cache hit on both
    assert te.generate(prompts[2:], ts) == je.generate(prompts[2:], js)
    assert te.prefix_cache_hits == je.prefix_cache_hits > 0

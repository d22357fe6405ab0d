"""The port's node agent, profiles and runner routes against the JAX package.

- **Profiles**: ``ServingProfile.from_dict(d).to_dict()``, ``validate()``
  and ``check_compatibility()`` (against the reference's CPU inventory, a
  v5e, an H100 and the port's own records) equal the reference's on every
  file under ``profiles/`` and on hypothesis dicts; a document both refuse
  raises the same error.
- **Runner halves of federation**: the trace export ring, ``merge_rollups``
  and ``adapter_residency_summary`` equal the reference's; the
  ``saturation`` fault point.
- **Apply**: a port agent and a reference ``NodeAgent`` apply the same
  dev-tiny-shaped profile (two chat models, spec decode, the host tier, an
  adapter pool, WFQ ``slo``) on the same float32 weights; after the same
  scripted traffic the heartbeat keys are equal, the saturation values are
  equal (tokens/s aside), the tenants block is the reference's
  ``merge_rollups`` of the engines' rollups and passes the reference's
  ``validate_tenant_rollup`` unchanged, the adapters block passes
  ``validate_adapter_block`` unchanged.  ``dev-tiny`` as written is
  served (its chat and embedding entries, through the agent's own
  builder), and so are ``dev-tiny-prefill`` and ``dev-tiny-decode`` (each
  heartbeats its role; ``HELIX_FILESTORE_KV_DIR`` arms the engine's
  filestore tier); an entry the port refuses (a vision-embedding entry
  on a mesh, A15b) fails the apply with nothing built, while an adapter
  merged at apply (A18) reaches the build function; an invalid profile
  fails with the reference's
  text; a diff re-apply keeps the kept model's loop object and frees the
  dropped one.
- **Through the reference control plane** (aiohttp, in process): the port
  runner (``cli.make_node``) heartbeats, polls and applies an assigned
  profile; a streamed greedy chat routed to it and to a JAX runner gives
  the same SSE frames (``id`` and ``created`` masked); ``drain: true``
  shows as ``draining`` in the next heartbeat, the survivor ships through
  ``migration-targets`` to the JAX runner and the client's stream resumes
  there with the undrained tokens, and ``on_drain`` runs once; an assigned
  invalid profile reports ``failed`` with the reference's text.
- **Routes**: ``/v1/messages`` frames (stream and not) equal the reference
  ``OpenAIServer``'s, ids masked; ``/logs``, ``/admin/profiler`` (CPU
  activity, 409 while one runs, 403 without the runner token) and
  ``/api/v1/state``.
- **serve-node** in a subprocess exits 0 after its drain, on SIGTERM and
  on a control-plane drain request.

Tolerances: every comparison is exact (tokens, frames, JSON values) except
the wall-clock rates ``tokens_per_sec`` and a tenant's ``goodput_tps``,
which are left out.
"""

import argparse
import asyncio
import copy
import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from helix_tpu.control import node_agent as jagent
from helix_tpu.control import profile as jprofile
from helix_tpu.device import detect as jdetect
from helix_tpu.engine import adapters as jadapters
from helix_tpu.engine import engine as jengine
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.obs import slo as jslo
from helix_tpu.obs import trace as jtrace
from helix_tpu.serving import registry as jregistry
from helix_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer
from helix_tpu_torch import cli
from helix_tpu_torch import device as tdevice
from helix_tpu_torch.control import node_agent as tagent
from helix_tpu_torch.control import profile as tprofile
from helix_tpu_torch.engine import adapters as tadapters
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.obs import slo as tslo
from helix_tpu_torch.obs import trace as ttrace
from helix_tpu_torch.obs.flight import SATURATION_KEYS
from helix_tpu_torch.serving import kv_filestore as tkvfs
from helix_tpu_torch.serving.openai_api import OpenAIServer
from helix_tpu_torch.serving.registry import ModelRegistry, ServedModel
from helix_tpu_torch.serving.tokenizer import ByteTokenizer
from helix_tpu_torch.testing import faults
from helix_tpu_torch.testing.control_stub import ControlStub

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILES = sorted(glob.glob(os.path.join(ROOT, "profiles", "*.yaml")))
VOCAB = 260     # the byte tokenizer's ids: every token decodes to a byte
TOK = ByteTokenizer()
JTOK = JByteTokenizer()
# dev-tiny's chat entry (profiles/dev-tiny.yaml), geometry and features
DEV_ENGINE = dict(max_decode_batch=2, page_size=4, num_pages=256,
                  max_pages_per_seq=64, max_prefill_len=1024,
                  enable_spec_decode=True, spec_tokens=4,
                  host_pool_bytes=16 * 1024 * 1024, adapter_pool_slots=3,
                  adapter_rank=8)
DEV_SLO = {"ttft_p95_seconds": 30.0, "queue_wait_p95_seconds": 20.0,
           "sched": {"policy": "wfq", "default_class": "interactive",
                     "max_tenant_queue_depth": 32,
                     "prefill_budget_tokens": 1024,
                     "prefill_budget_min_tokens": 128}}
PLAIN_ENGINE = dict(max_decode_batch=4, page_size=4, num_pages=128,
                    max_pages_per_seq=48, max_prefill_len=64)


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


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig.tiny(vocab_size=VOCAB, dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(vocab_size=VOCAB, dtype="float32"), tp


def _port_build(weights, built=None):
    """The port agent's builder on the shared weights (it takes
    ``cli.build_served_model``'s keywords): the port engine on the CPU
    and the loop ``cli.make_engine_loop`` makes of the entry."""
    *_, cfg, tp = weights

    def build(name, engine=None, slo=None, **_kw):
        if built is not None:
            built.append(name)
        ecfg = tengine.EngineConfig(eos_token_ids=tuple(TOK.eos_ids),
                                    **(engine or {}))
        eng = tengine.Engine(dataclasses.replace(cfg, name=name), tp,
                             ecfg, device="cpu")
        return ServedModel(name=name, loop=cli.make_engine_loop(eng, name,
                                                                slo),
                           tokenizer=TOK, context_length=256)

    return build


def _jax_build(weights):
    """The reference agent's builder on the same weights (its
    ``_make_engine_loop``; the reference attention on the CPU)."""
    jcfg, jp, *_ = weights

    def build(pm):
        ecfg = jengine.EngineConfig(eos_token_ids=tuple(JTOK.eos_ids),
                                    attn_backend="reference", **pm.engine)
        eng = jengine.Engine(dataclasses.replace(jcfg, name=pm.name), jp,
                             ecfg)
        return jregistry.ServedModel(
            name=pm.name, loop=jagent._make_engine_loop(eng, pm),
            tokenizer=JTOK, context_length=256)

    return build


def _profile_doc(name, models=("tiny-chat",), engine=None, slo=None,
                 vendor="cpu"):
    return {"name": name, "requirement": {"chips": 1, "vendor": vendor},
            "models": [{"name": m, "kind": "chat",
                        "engine": dict(engine or PLAIN_ENGINE),
                        **({"slo": slo} if slo else {})} for m in models]}


def _both(doc):
    return (tprofile.ServingProfile.from_dict(copy.deepcopy(doc)),
            jprofile.ServingProfile.from_dict(copy.deepcopy(doc)))


# ---------------------------------------------------------------------------
# profiles
# ---------------------------------------------------------------------------


def _h100(i=0):
    return {"index": i, "vendor": "nvidia", "arch": "h100",
            "device_kind": "NVIDIA H100 80GB HBM3",
            "total_memory_bytes": 85_045_231_616, "used_memory_bytes": 0,
            "free_memory_bytes": 85_045_231_616, "core_on_chip": 1,
            "process_index": 0, "coords": None, "driver": "cuda-12.8"}


def _inventories() -> list:
    v5e = [{"index": i, "vendor": "tpu", "arch": "v5e",
            "device_kind": "TPU v5 lite", "total_memory_bytes": 16 << 30}
           for i in range(8)]
    return [
        [a.to_dict() for a in jdetect.detect_accelerators()],
        [a.to_dict() for a in tdevice.detect_accelerators("cpu")],
        v5e, v5e[:1], [_h100()], [_h100(i) for i in range(4)], [],
    ]


def _compat(mod, prof, inv) -> list:
    return [v.to_dict() for v in mod.check_compatibility(prof, inv)]


@pytest.mark.parametrize("path", PROFILES,
                         ids=[os.path.basename(p) for p in PROFILES])
def test_profiles_equal_reference(path):
    with open(path) as f:
        text = f.read()
    t = tprofile.ServingProfile.from_yaml(text)
    j = jprofile.ServingProfile.from_yaml(text)
    assert t.to_dict() == j.to_dict()
    assert t.validate() == j.validate()
    assert t.model_names == j.model_names
    assert tprofile.ServingProfile.from_yaml(t.to_yaml()).to_dict() == \
        j.to_dict()
    for inv in _inventories():
        assert _compat(tprofile, t, inv) == _compat(jprofile, j, inv)


_names = st.sampled_from(["m", "tiny-chat", "", "org/model-7b"])
_mesh = st.fixed_dictionaries({}, optional={
    "tp": st.integers(1, 4), "dp": st.integers(1, 2), "sp": st.integers(1, 2),
    "device_offset": st.integers(0, 3), "bogus": st.integers(0, 9)})
_model = st.fixed_dictionaries({"name": _names}, optional={
    "kind": st.sampled_from(["chat", "embedding", "vision"]),
    "quantization": st.sampled_from([None, "int8"]),
    "mesh": _mesh,
    "engine": st.dictionaries(st.sampled_from(["num_pages", "page_size"]),
                              st.integers(1, 64), max_size=2),
    "context_length": st.one_of(st.none(), st.integers(1, 8192)),
    "adapter_scale": st.one_of(st.none(), st.floats(0.5, 4.0)),
    "multihost": st.sampled_from([
        {}, {"role": "leader"}, {"role": "follower"}, {"role": "bogus"},
        {"role": "follower", "leader_url": "http://h:1", "standby": "yes"},
        {"role": "leader", "standby": True}]),
    "slo": st.sampled_from([{}, {"ttft_p95_seconds": 2.0}]),
})
_doc = st.fixed_dictionaries({"name": _names, "models": st.lists(
    _model, max_size=3)}, optional={
    "requirement": st.fixed_dictionaries({}, optional={
        "chips": st.integers(0, 8),
        "generation": st.sampled_from(["", "v5e", "h100"]),
        "vendor": st.sampled_from(["tpu", "nvidia", "cpu"]),
        "min_hbm_bytes": st.sampled_from([0, 1 << 30, 100 << 30])}),
    "residency": st.sampled_from([None, {"hbm_budget_bytes": 1 << 30}]),
    "role": st.sampled_from(["mixed", "prefill", "Decode", "bogus", None]),
})


@settings(max_examples=120, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(doc=_doc)
def test_profile_hypothesis_equal_reference(doc):
    def parse(mod):
        try:
            return mod.ServingProfile.from_dict(copy.deepcopy(doc)), None
        except Exception as e:  # noqa: BLE001 — compared below
            return None, (type(e), str(e))

    t, terr = parse(tprofile)
    j, jerr = parse(jprofile)
    assert terr == jerr
    if j is None:
        return
    assert t.to_dict() == j.to_dict()
    assert t.validate() == j.validate()
    for inv in _inventories():
        assert _compat(tprofile, t, inv) == _compat(jprofile, j, inv)


def test_accelerator_records_carry_the_reference_fields():
    assert [f.name for f in dataclasses.fields(tdevice.AcceleratorStatus)] \
        == [f.name for f in dataclasses.fields(jdetect.AcceleratorStatus)]
    (rec,) = tdevice.detect_accelerators("cpu")
    ref = jdetect.detect_accelerators()[0].to_dict()
    assert set(rec.to_dict()) == set(ref)
    assert (rec.vendor, rec.arch, rec.device_kind) == (
        ref["vendor"], ref["arch"], ref["device_kind"]) == ("cpu",) * 3
    assert tdevice.gpu_arch("NVIDIA H100 80GB HBM3") == "h100"
    assert tdevice.gpu_arch("NVIDIA GeForce RTX 4090") == "unknown"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdevice.detect_accelerators()


def test_hotswap_profile_needs_a_tpu_and_its_nvidia_copy_fits_an_h100():
    """The as-written profile has no ``vendor``: it asks for a ``tpu``
    chip, so an H100 inventory gives the ``chips`` violation (and no
    ``generation`` one: no tpu arch to compare); the copy with
    ``{vendor: nvidia, chips: 1}`` gives none."""
    path = os.path.join(ROOT, "profiles", "v5e1-hotswap.yaml")
    with open(path) as f:
        text = f.read()
    t = tprofile.ServingProfile.from_yaml(text)
    inv = [_h100()]
    assert _compat(tprofile, t, inv) == [
        {"constraint": "chips", "want": ">=1 tpu", "have": "0"}]
    doc = t.to_dict()
    doc["requirement"] = {"vendor": "nvidia", "chips": 1}
    copy_ = tprofile.ServingProfile.from_dict(doc)
    assert tprofile.check_compatibility(copy_, inv) == []
    assert jprofile.check_compatibility(
        jprofile.ServingProfile.from_dict(doc), inv) == []


# ---------------------------------------------------------------------------
# the runner halves of federation
# ---------------------------------------------------------------------------


def _export(mod, cap):
    store = mod.TraceStore(max_traces=4, max_spans_per_trace=3)
    store.record("aaaaaaaa0", "before", 1.0, 2.0)   # not exported
    store.enable_export(cap=cap)
    for i in range(7):
        store.record(f"trace{i % 3:05d}", f"s{i}", 10.0 + i, 10.5 + i,
                     plane="engine", n=i)
    store.record("", "ignored", 0.0, 1.0)
    first = store.drain_export(limit=2)
    rest = store.drain_export()
    strip = [[{k: v for k, v in s.items() if not k.endswith("_unix")}
              for s in part] for part in (first, rest)]
    durations = [round(s["end_unix"] - s["start_unix"], 9)
                 for s in first + rest]
    return strip, durations, store.export_dropped, store.dropped_spans


def test_trace_export_ring_equals_reference():
    assert _export(ttrace, 4) == _export(jtrace, 4)
    off = ttrace.TraceStore()
    off.record("trace00000", "x", 0.0, 1.0)
    assert off.drain_export() == [] and jtrace.TraceStore().drain_export() \
        == []


@pytest.mark.parametrize("env,want", [({}, True), (
    {"HELIX_TRACE_FEDERATION": "0"}, False), (
    {"HELIX_TRACE_FEDERATION": "off"}, False), (
    {"HELIX_TRACE_EXPORT_BATCH": "9999", "HELIX_TRACE_BUFFER": "x"}, True)])
def test_federation_knobs_equal_reference(monkeypatch, env, want):
    for k in ("HELIX_TRACE_FEDERATION", "HELIX_TRACE_EXPORT_BATCH",
              "HELIX_TRACE_BUFFER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert ttrace.federation_enabled() == jtrace.federation_enabled() == want
    assert ttrace.export_batch() == jtrace.export_batch()
    assert ttrace.export_buffer() == jtrace.export_buffer()


def test_dropped_span_counter_counts_the_export_ring():
    from helix_tpu_torch.obs.metrics import Registry

    store = ttrace.TraceStore()
    store.enable_export(cap=16)
    for i in range(20):
        store.record("trace00000", f"s{i}", 0.0, 1.0)
    reg = Registry()
    reg.register_callback(lambda c: ttrace.collect_trace_metrics(c, store))
    assert "helix_trace_dropped_spans_total 4" in reg.render()


_entry = st.fixed_dictionaries({
    "tenant": st.sampled_from(["a", "b", "c", "d", "__other__", 7]),
    "requests": st.integers(0, 50), "generated_tokens": st.integers(0, 999),
    "prompt_tokens": st.integers(0, 999), "sheds": st.integers(0, 5),
    "goodput_tps": st.floats(0, 100), "burn_rate_fast": st.floats(0, 9),
    "ttft_p95_seconds": st.floats(0, 5)})


@settings(max_examples=150, deadline=None)
@given(rollups=st.lists(st.one_of(
    st.fixed_dictionaries({"top": st.lists(_entry, max_size=6)}, optional={
        "demotions": st.integers(0, 4)}), st.just("junk")), max_size=4),
    top_k=st.integers(1, 4))
def test_merge_rollups_equals_reference(rollups, top_k):
    assert tslo.merge_rollups(copy.deepcopy(rollups), top_k) == \
        jslo.merge_rollups(copy.deepcopy(rollups), top_k)


def test_adapter_residency_summary_equals_reference(monkeypatch):
    def model(name, ids):
        pool = types.SimpleNamespace(resident_ids=lambda: list(ids))
        return types.SimpleNamespace(name=name, loop=types.SimpleNamespace(
            engine=types.SimpleNamespace(adapter_pool=pool)))

    models = [model("m2", ["z", "a"]), model("m1", ["b"]),
              types.SimpleNamespace(name="x", loop=None),
              model("m3", [f"a{i}" for i in range(200)])]
    assert tadapters.adapter_residency_summary(models) == \
        jadapters.adapter_residency_summary(models)
    assert len(tadapters.adapter_residency_summary(models)) == \
        tadapters.MAX_RESIDENCY_ENTRIES == jadapters.MAX_RESIDENCY_ENTRIES


def test_saturation_fault_point_sets_only_schema_keys():
    agent = tagent.NodeAgent("r1", device="cpu")
    faults.arm(rules=[{"point": "saturation", "runner": "r1", "times": 1,
                       "set": {"kv_occupancy": 0.99, "queue_depth": 40,
                               "bogus": 1}}])
    sat = agent.saturation_summary()
    assert list(sat) == list(SATURATION_KEYS)
    assert sat["kv_occupancy"] == 0.99 and sat["queue_depth"] == 40
    assert agent.saturation_summary()["kv_occupancy"] == 0.0  # times: 1
    assert tagent.NodeAgent("r2", device="cpu").saturation_summary() == {
        k: 0.0 if isinstance(v, float) else 0 for k, v in sat.items()}


# ---------------------------------------------------------------------------
# apply: the port agent beside the reference agent
# ---------------------------------------------------------------------------


def _lora(cfg, seed, rank=8):
    rng = np.random.default_rng(seed)
    out = {}
    for t, (fan_in, fan_out) in tadapters.target_dims(cfg).items():
        if t not in ("wq", "wv"):
            continue
        out[t] = {
            "lora_a": (rng.standard_normal((cfg.num_layers, fan_in, rank))
                       / np.sqrt(fan_in)).astype(np.float32),
            "lora_b": (rng.standard_normal((cfg.num_layers, rank, fan_out))
                       * 0.05).astype(np.float32),
        }
    return out


# (model, tenant, prompt, adapter): one request at a time, so the prefix
# cache sees the same order on both sides
SCRIPT = [
    ("tiny-chat", "acme", list(range(7, 40)), ""),
    ("tiny-chat", "acme", list(range(7, 40)) + [9, 9], ""),
    ("tiny-chat-2", "zeta", list(range(50, 71)), ""),
    ("tiny-chat", "beta", list(range(80, 97)), "a1"),
    ("tiny-chat-2", "acme", list(range(7, 30)), ""),
    ("tiny-chat", "", list(range(100, 112)), ""),
]


def _run_script(agent, mod, smod, weights):
    cfg = weights[2] if mod is tengine else weights[0]
    pack = tadapters.pack_lora_tree if mod is tengine \
        else jadapters.pack_lora_tree
    for m in agent._live_models():
        m.loop.engine.adapter_store.publish(
            pack("a1", _lora(cfg, 5), 2.0), persist=False)
    outs = []
    for i, (model, tenant, prompt, adapter) in enumerate(SCRIPT):
        served = agent.registry.get(model)
        done = threading.Event()
        req = mod.Request(
            id=f"s{i}", prompt_tokens=list(prompt),
            sampling=smod.SamplingParams(temperature=0.0, max_tokens=12),
            stop_token_ids=tuple(served.tokenizer.eos_ids),
            tenant=tenant or "anonymous", adapter=adapter)
        served.loop.submit(req, lambda ev, d=done: (
            d.set() if ev.finished or ev.error else None))
        assert done.wait(120), f"request {i} did not finish"
        outs.append(list(req.output_tokens))
    return outs


def test_apply_and_heartbeat_equal_reference(weights, monkeypatch):
    from helix_tpu.engine import sampling as jsampling
    from helix_tpu_torch.engine import sampling as tsampling

    monkeypatch.setenv("HELIX_TENANT_TOP_K", "2")
    doc = _profile_doc("dev-tiny-chat", ("tiny-chat", "tiny-chat-2"),
                       DEV_ENGINE, DEV_SLO)
    t_prof, j_prof = _both(doc)
    ta = tagent.NodeAgent("r1", build_model=_port_build(weights),
                          device="cpu")
    ja = jagent.NodeAgent("r1", build_model=_jax_build(weights))
    try:
        ts, js = ta.apply_profile(t_prof), ja.apply_profile(j_prof)
        assert ts.to_dict() == js.to_dict()
        assert ts.status == "running"
        assert ts.models == ["tiny-chat", "tiny-chat-2"]
        t_out = _run_script(ta, tengine, tsampling, weights)
        j_out = _run_script(ja, jengine, jsampling, weights)
        assert t_out == j_out
        tb, jb = ta.heartbeat_payload(), ja.heartbeat_payload()
        assert list(tb) == list(jb)
        assert {k: v for k, v in tb["saturation"].items()
                if k != "tokens_per_sec"} == \
            {k: v for k, v in jb["saturation"].items()
             if k != "tokens_per_sec"}
        assert list(tb["saturation"]) == list(SATURATION_KEYS)
        assert tb["profile"] == jb["profile"]
        assert tb["adapters"] == jb["adapters"] == ["tiny-chat@a1"]
        assert jadapters.validate_adapter_block(tb["adapters"]) == \
            tb["adapters"]
        assert (tb["role"], tb["draining"], tb["drain_deadline_ts"]) == (
            jb["role"], jb["draining"], jb["drain_deadline_ts"])
        assert tb["multihost"] == tb["canary"] == tb["ctx"] == {}
        # the tenants block: the reference's merge of the same rollups
        rolls = [m.loop.slo.rollup() for m in ta._live_models()]
        for m, r in zip(ta._live_models(), rolls):
            monkeypatch.setattr(m.loop.slo, "rollup", lambda r=r: r)
        block = ta.tenant_summary()
        assert block == jslo.merge_rollups(copy.deepcopy(rolls), top_k=2)
        assert jslo.validate_tenant_rollup(copy.deepcopy(block)) == block
        # four tenants bounded to the top 2 and the fold
        assert block["tracked"] == 4 and len(block["top"]) == 3
        assert block["top"][0]["tenant"] == "acme"
        assert block["top"][-1]["tenant"] == "__other__"
        assert set(block["top"][0]) == set(tslo.TENANT_KEYS) | {"tenant"}
    finally:
        ta.stop()
        ja.stop()


def test_refused_profile_fails_before_anything_is_built(weights):
    """A profile with an entry the port refuses (a vision entry on a
    two-device mesh: A15b, vision on a mesh) fails its apply by name,
    every entry checked before anything is built.  An ``adapter:`` is no
    longer refused (A18): a chat entry's reaches the build function with
    its ``adapter_scale``, and a vision-embedding entry's is dropped, as
    the reference node agent ignores it."""
    with open(os.path.join(ROOT, "profiles", "dev-tiny.yaml")) as f:
        doc = yaml.safe_load(f)
    doc["models"][0].update(adapter="/ckpt/lora", adapter_scale=0.5)
    doc["models"].append({"name": "tiny-vembed", "kind": "vision-embedding",
                          "adapter": "/ckpt/lora"})
    doc["models"].append({"name": "tiny-vl", "kind": "vision",
                          "mesh": {"tp": 2}})
    doc["requirement"]["chips"] = 2
    prof = tprofile.ServingProfile.from_dict(doc)
    built = []
    agent = tagent.NodeAgent("r1", build_model=_port_build(weights, built),
                             device="cpu")
    state = agent.apply_profile(prof)
    assert state.status == "failed" and built == []
    assert ("tiny-vl: a vision entry on a mesh" in state.error
            and "ROADMAP A15b: vision on a mesh" in state.error)
    # the chat and the embedding entries are served
    assert "tiny-chat" not in state.error and "tiny-embed" not in state.error
    assert "tiny-vembed" not in state.error
    assert "adapter" not in state.error
    assert agent.registry.names() == []
    assert isinstance(agent.apply_exception, NotImplementedError)
    del doc["models"][-1]
    specs = {sp["name"]: sp for sp in cli.model_specs(
        tprofile.ServingProfile.from_dict(doc))}
    assert (specs["tiny-chat"]["adapter"],
            specs["tiny-chat"]["adapter_scale"]) == ("/ckpt/lora", 0.5)
    assert "adapter" not in specs["tiny-vembed"]


def test_dev_tiny_as_written_serves_both_entries():
    """``profiles/dev-tiny.yaml`` as written, through the agent's own
    builder (``cli.build_served_model``) on the CPU: the chat entry with
    every engine field (its ``attn_backend: reference`` dropped: the
    wrappers run their plain versions on CPU tensors) and the embedding
    entry (the reference's tiny encoder); the heartbeat lists both,
    saturation counts the chat engine's slots only, and both answer."""
    with open(os.path.join(ROOT, "profiles", "dev-tiny.yaml")) as f:
        prof = tprofile.ServingProfile.from_yaml(f.read())
    agent = tagent.NodeAgent("r1", device="cpu", warmup=False)
    try:
        state = agent.apply_profile(prof)
        assert state.status == "running", state.error
        assert state.models == ["tiny-chat", "tiny-embed"]
        embed = agent.registry.get("tiny-embed")
        assert embed.kind == "embedding" and embed.loop is None
        assert embed.embedder.max_batch == 32
        chat = agent.registry.get("tiny-chat")
        ecfg = chat.loop.engine.cfg
        assert (ecfg.enable_spec_decode, ecfg.spec_tokens,
                ecfg.host_pool_bytes, ecfg.adapter_pool_slots,
                ecfg.attn_backend) == (True, 4, 16777216, 3, None)
        beat = agent.heartbeat_payload()
        assert beat["profile"]["models"] == ["tiny-chat", "tiny-embed"]
        assert beat["saturation"]["slots_total"] == 2
        api = OpenAIServer(agent.registry)
        httpd = api.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            status, out = _post(url + "/v1/embeddings", {
                "model": "tiny-embed", "input": ["dev", "profile"]})
            assert status == 200
            vecs = np.array([d["embedding"] for d in json.loads(out)["data"]])
            assert vecs.shape == (2, 32)
            assert np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-5)
            status, out = _post(url + "/v1/chat/completions", {
                "model": "tiny-chat", "max_tokens": 4, "temperature": 0,
                "messages": [{"role": "user", "content": "hi"}]})
            assert status == 200, out
        finally:
            httpd.shutdown()
    finally:
        agent.stop()


@pytest.mark.parametrize("how", ["prefill", "decode", "env"])
def test_disagg_profiles_as_written_serve_their_role(monkeypatch, tmp_path,
                                                    how):
    """``profiles/dev-tiny-prefill.yaml`` and ``dev-tiny-decode.yaml`` as
    written, through the agent's own builder on the CPU: each is served,
    heartbeats its role (``HELIX_POOL_ROLE=prefill`` beating a profile
    without one), and with ``HELIX_FILESTORE_KV_DIR`` set its engine's
    filestore tier is armed on that directory with the engine's geometry
    namespace, as the reference's node agent arms it."""
    name = "decode" if how == "decode" else "prefill"
    with open(os.path.join(ROOT, "profiles",
                           f"dev-tiny-{name}.yaml")) as f:
        doc = yaml.safe_load(f)
    if how == "env":
        doc.pop("role")
        monkeypatch.setenv("HELIX_POOL_ROLE", "prefill")
    monkeypatch.setenv("HELIX_FILESTORE_KV_DIR", str(tmp_path))
    agent = tagent.NodeAgent("r1", device="cpu", warmup=False)
    try:
        state = agent.apply_profile(tprofile.ServingProfile.from_dict(doc))
        assert state.status == "running", state.error
        assert agent.pool_role() == name
        assert agent.heartbeat_payload()["role"] == name
        eng = agent.registry.get("tiny-chat").loop.engine
        assert eng.cfg.enable_spec_decode == (name == "decode")
        fs = eng.kv_filestore
        assert fs is not None
        assert fs.store.root == os.path.realpath(str(tmp_path))
        assert fs.namespace == tkvfs.KVFilestore.namespace_for(
            "tiny-chat", eng.cache_cfg.page_size, eng.model_cfg.num_layers,
            eng.model_cfg.num_kv_heads, eng.model_cfg.head_dim,
            eng.cache_cfg.dtype)
        api = OpenAIServer(agent.registry)
        httpd = api.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            status, out = _post(url + "/v1/chat/completions", {
                "model": "tiny-chat", "max_tokens": 4, "temperature": 0,
                "messages": [{"role": "user",
                              "content": "a prompt long enough to fill "
                                         "a few pages"}]})
            assert status == 200, out
            fs.flush()
            assert fs.stores > 0
        finally:
            httpd.shutdown()
    finally:
        agent.stop()


def test_invalid_profile_fails_with_reference_text(weights):
    doc = _profile_doc("bad", ("m", "m"))
    doc["models"][0]["mesh"] = {"tp": 2}
    t_prof, j_prof = _both(doc)
    built = []
    ts = tagent.NodeAgent("r1", build_model=_port_build(weights, built),
                          device="cpu").apply_profile(t_prof)
    js = jagent.NodeAgent("r1", build_model=lambda pm: None).apply_profile(
        j_prof)
    assert ts.to_dict() == js.to_dict() and ts.status == "failed"
    assert "claims devices [0,2)" in ts.error and built == []


def test_diff_apply_keeps_the_kept_loop_and_frees_the_dropped(weights):
    built = []
    agent = tagent.NodeAgent("r1", build_model=_port_build(weights, built),
                             device="cpu")
    p = {n: tprofile.ServingProfile.from_dict(_profile_doc(n, models))
         for n, models in (("p1", ("a",)), ("p2", ("a", "b")),
                           ("p3", ("b",)))}
    try:
        assert agent.apply_profile(p["p1"]).status == "running"
        loop_a = agent.registry.get("a").loop
        assert agent.apply_profile(p["p2"]).models == ["a", "b"]
        assert agent.registry.get("a").loop is loop_a and built == ["a", "b"]
        loop_b = agent.registry.get("b").loop
        assert agent.apply_profile(p["p3"]).models == ["b"]
        assert agent.registry.names() == ["b"] and built == ["a", "b"]
        assert agent.registry.get("b").loop is loop_b
        # the dropped model's loop is stopped and its engine released
        assert loop_a.stopped and loop_a.engine.params is None
        assert agent.apply_profile(None).status == "running"
        assert agent.registry.names() == [] and loop_b.stopped
    finally:
        agent.stop()


def test_residency_profile_through_the_agent(weights):
    built = []
    agent = tagent.NodeAgent("r1", build_model=_port_build(weights, built),
                             device="cpu")
    doc = _profile_doc("hot", ("tiny-a", "tiny-b"))
    doc["residency"] = {"hbm_budget_bytes": 1 << 40}
    try:
        state = agent.apply_profile(tprofile.ServingProfile.from_dict(doc))
        assert state.status == "running" and built == []
        assert state.progress == {"tiny-a": "lazy", "tiny-b": "lazy"}
        assert agent._live_models() == []
        assert agent.registry.get("tiny-b") is not None
        assert built == ["tiny-b"]
        assert [m.name for m in agent._live_models()] == ["tiny-b"]
        assert agent.heartbeat_payload()["saturation"]["slots_total"] == 4
    finally:
        agent.stop()


@pytest.mark.parametrize("env,want", [
    ({"HELIX_SPEC_TOKENS": "3"}, {"enable_spec_decode": True,
                                  "spec_tokens": 3}),
    ({"HELIX_SPEC_TOKENS": "0"}, {"enable_spec_decode": False}),
    ({"HELIX_ASYNC_LOOP": "off"}, {"enable_async_loop": False}),
    ({"HELIX_ASYNC_LOOP": "1"}, {"enable_async_loop": True}),
    ({"HELIX_MAX_PAGES_PER_SEQ": "7"}, {"max_pages_per_seq": 7}),
    ({}, {"max_model_len": 300, "max_pages_per_seq": 75, "num_pages": 128}),
])
def test_operator_overrides_beat_the_profile(monkeypatch, env, want):
    """The reference node agent's build rules: its operator knobs beat
    the entry's engine block, and a ``context_length`` caps requests
    with page tables that hold it (300 tokens of 4-token pages need 75
    pages per sequence; the 128-page pool already holds 76)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pm = tprofile.ProfileModel(
        name="tiny-chat", context_length=300,
        engine={**PLAIN_ENGINE, "enable_spec_decode": True,
                "enable_async_loop": True},
        model_overrides={"dtype": "float32"})
    agent = tagent.NodeAgent("r1", device="cpu", warmup=False)
    state = agent.apply_profile(tprofile.ServingProfile(name="p",
                                                        models=(pm,)))
    try:
        assert state.status == "running", state.error
        cfg = agent.registry.get("tiny-chat").loop.engine.cfg
        assert {k: getattr(cfg, k) for k in want} == want
        assert cfg.max_model_len == 300
    finally:
        agent.stop()


def test_migrated_sampled_request_under_speculation_like_reference(weights):
    """Reference behaviour (ROADMAP C): keys are spent at every drafted
    position and the acceptance EMA that decides the drafts is not in the
    snapshot, so a sampled request exported while its speculation is
    EMA-disabled re-probes on the importer and draws other tokens than an
    undrained run; without speculation the draws are the same.  Both
    packages, the same weights, the same tokens and the same point of
    difference."""
    from helix_tpu.engine import sampling as jsampling
    from helix_tpu_torch.engine import sampling as tsampling

    jcfg, jp, cfg, tp = weights
    prompt = [int(x) for x in np.random.default_rng(0).integers(4, 250, 40)]

    def run(mod, smod, spec, export_at=None):
        geo = dict(max_decode_batch=4, page_size=16, num_pages=128,
                   max_pages_per_seq=32, max_prefill_len=64,
                   enable_spec_decode=spec, spec_tokens=4)
        if mod is tengine:
            make = lambda: tengine.Engine(  # noqa: E731
                cfg, tp, tengine.EngineConfig(**geo), device="cpu")
        else:
            make = lambda: jengine.Engine(  # noqa: E731
                jcfg, jp, jengine.EngineConfig(**geo,
                                               attn_backend="reference"))
        a = make()
        r = mod.Request(id="s", prompt_tokens=prompt,
                        sampling=smod.SamplingParams(temperature=0.8,
                                                     max_tokens=120,
                                                     seed=4321))
        a.add_request(r)
        n = 0
        while a.has_work():
            a.step()
            n += 1
            if n == export_at:
                disabled = a.spec_disabled_slots()
                b = make()
                r = b.import_request(a.export_request("s"))
                while b.has_work():
                    b.step()
                return list(r.output_tokens), disabled
        return list(r.output_tokens), None

    for spec in (False, True):
        outs = {}
        for mod, smod in ((tengine, tsampling), (jengine, jsampling)):
            ref, _ = run(mod, smod, spec)
            got, disabled = run(mod, smod, spec, export_at=40)
            diff = next((i for i, (x, y) in enumerate(zip(ref, got))
                         if x != y), None)
            outs[mod.__name__] = (ref, got, disabled, diff)
        t, j = outs.values()
        assert t == j
        ref, got, disabled, diff = t
        if spec:
            assert disabled == 1 and diff is not None and diff > 40
        else:
            assert got == ref


# ---------------------------------------------------------------------------
# through the reference control plane
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


def _node_args(cp_url, runner_id="port-1", **kw):
    return argparse.Namespace(**{
        "profile": None, "model": None, "runner_id": runner_id,
        "host": "127.0.0.1", "port": 0, "control_plane": cp_url,
        "heartbeat_interval": 0.2, "advertise": None, "device": "cpu",
        "engine": None, "seed": 0, "no_warmup": True,
        "random_weights": False, "tunnel": False, **kw})


def _wait(pred, timeout=120.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _sse(url, body, timeout=120) -> list:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    frames = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().rstrip("\n")
            if line.startswith("data: "):
                frames.append(line[6:])
    return frames


def _masked(frames) -> list:
    out = []
    for f in frames:
        if f == "[DONE]":
            out.append(f)
            continue
        doc = json.loads(f)
        for k in ("id", "created"):
            doc.pop(k, None)
        out.append(doc)
    return out


@pytest.fixture(scope="module")
def fleet(weights):
    """The reference control plane with a JAX runner (reference agent +
    aiohttp OpenAIServer) and a port runner (``cli.make_node``), both
    serving ``tiny-chat`` on the same weights, mid-stream failover on."""
    from helix_tpu.control.server import ControlPlane
    from helix_tpu.serving.openai_api import OpenAIServer as JServer

    prior = os.environ.get("HELIX_MIDSTREAM_FAILOVER")
    os.environ["HELIX_MIDSTREAM_FAILOVER"] = "1"
    holder: dict = {}
    cp = ControlPlane()
    cp_url = f"http://127.0.0.1:{_serve_app(cp.build_app(), holder)}"
    doc = _profile_doc("fleet-1")
    cp.store.upsert_profile("fleet-1", doc)
    cp.store.set_assignment("jax-1", "fleet-1")
    cp.store.set_assignment("port-1", "fleet-1")
    ja = jagent.NodeAgent("jax-1", build_model=_jax_build(weights),
                          heartbeat_url=cp_url, heartbeat_interval=0.2)
    jport = _serve_app(JServer(ja.registry).build_app(), holder)
    ja.address = f"http://127.0.0.1:{jport}"
    ja.start_heartbeat()
    agent, httpd = cli.make_node(_node_args(cp_url),
                                 build_model=_port_build(weights))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    drained = []
    agent.on_drain = lambda: drained.append(time.monotonic())
    yield types.SimpleNamespace(cp=cp, cp_url=cp_url, ja=ja, agent=agent,
                                httpd=httpd, drained=drained)
    if prior is None:
        os.environ.pop("HELIX_MIDSTREAM_FAILOVER", None)
    else:
        os.environ["HELIX_MIDSTREAM_FAILOVER"] = prior
    agent.stop()
    ja.stop()
    httpd.shutdown()
    cp.stop()
    for lp in holder.get("loops", []):
        lp.call_soon_threadsafe(lp.stop)


def _runners(cp) -> dict:
    return {st.id: st for st in cp.router.runners()}


def test_port_runner_applies_assignment_and_routes_like_jax(fleet):
    _wait(lambda: fleet.agent.state.status == "running"
          and fleet.ja.state.status == "running", what="both applies")
    _wait(lambda: all(r.routable and r.models == ["tiny-chat"]
                      for r in _runners(fleet.cp).values())
          and len(_runners(fleet.cp)) == 2, what="both routable")
    hb = fleet.cp.store.get_runner("port-1")
    assert hb["profile"]["name"] == "fleet-1"
    assert hb["accelerators"][0]["vendor"] == "cpu"
    assert list(hb["saturation"]) == list(SATURATION_KEYS)
    assert _runners(fleet.cp)["port-1"].meta["address"] == \
        fleet.agent.address
    body = {"model": "tiny-chat", "temperature": 0, "max_tokens": 16,
            "stream": True, "messages": [{"role": "user",
                                          "content": "route me"}]}
    served = {"port-1": fleet.agent.registry.get("tiny-chat").loop.engine,
              "jax-1": fleet.ja.registry.get("tiny-chat").loop.engine}
    before = {k: e.num_generated_tokens for k, e in served.items()}
    # the round robin of two idle runners: one chat each
    a = _masked(_sse(fleet.cp_url + "/v1/chat/completions", body))
    b = _masked(_sse(fleet.cp_url + "/v1/chat/completions", body))
    assert all(e.num_generated_tokens > before[k]
               for k, e in served.items())
    assert a == b and a[-1] == "[DONE]" and len(a) > 2


def test_control_plane_drain_ships_to_the_jax_runner(fleet, monkeypatch):
    """Two long streams through the control plane land one on each
    runner; a drain request for the port runner: its next heartbeat says
    ``draining`` with a future deadline, its survivor ships to the JAX
    runner through ``migration-targets``, the control plane resumes the
    client's stream there, and both clients get the undrained text;
    ``on_drain`` runs once."""
    _wait(lambda: len(_runners(fleet.cp)) == 2
          and all(r.routable for r in _runners(fleet.cp).values()),
          what="both routable")
    monkeypatch.setenv("HELIX_DRAIN_SECONDS", "0.05")
    # slow the port's steps so the stream is still running at the drain
    faults.arm(rules=[{"point": "engine_step", "mode": "slow",
                       "delay": 0.05}])
    msgs = [{"role": "user", "content": "drain me across the fleet"}]
    body = {"model": "tiny-chat", "temperature": 0, "max_tokens": 120,
            "messages": msgs}
    ref = json.loads(urllib.request.urlopen(urllib.request.Request(
        fleet.ja.address + "/v1/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}), timeout=120).read())
    want = ref["choices"][0]["message"]["content"]
    port_eng = fleet.agent.registry.get("tiny-chat").loop.engine
    jax_loop = fleet.ja.registry.get("tiny-chat").loop
    imported = jax_loop.stats()["migration"]["imported"]
    texts = [None, None]

    def client(i):
        frames = _sse(fleet.cp_url + "/v1/chat/completions",
                      {**body, "stream": True})
        texts[i] = "".join(
            json.loads(f)["choices"][0]["delta"].get("content", "")
            for f in frames if f != "[DONE]" and "choices" in json.loads(f))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
        time.sleep(0.3)
    _wait(lambda: any(s is not None for s in port_eng.slots),
          what="a stream on the port runner")
    t0, t_wall = time.monotonic(), time.time()
    fleet.cp._request_runner_drain("port-1")
    _wait(lambda: fleet.agent.draining, what="the drain to start")
    for t in threads:
        t.join(timeout=180)
    assert texts == [want, want]
    _wait(lambda: fleet.drained, what="on_drain")
    time.sleep(0.5)
    assert len(fleet.drained) == 1
    beat = fleet.cp.store.get_runner("port-1")
    assert beat["draining"] is True
    assert beat["drain_deadline_ts"] > t_wall
    assert port_eng.num_snapshots_exported >= 1
    assert jax_loop.stats()["migration"]["imported"] >= imported + 1
    assert fleet.drained[0] > t0
    assert _runners(fleet.cp)["port-1"].draining


def test_assigned_invalid_profile_reports_failed_like_reference(weights):
    stub = ControlStub().start()
    try:
        doc = _profile_doc("bad", ("m",))
        doc["models"][0]["mesh"] = {"tp": 2}
        stub.assign("r", doc)
        agent, httpd = cli.make_node(_node_args(stub.url, "r"),
                                     build_model=_port_build(weights))
        beat = stub.wait_for("r", lambda b: b["profile"]["status"]
                             == "failed", 60)
        ref = jagent.NodeAgent("r", build_model=lambda pm: None) \
            .apply_profile(jprofile.ServingProfile.from_dict(doc))
        assert beat["profile"]["error"] == ref.error
        assert beat["profile"]["name"] == "bad"
        polls = len(stub.polls["r"])
        _wait(lambda: len(stub.polls["r"]) > polls + 2, what="more polls")
        assert agent.state.status == "failed"   # not re-applied by name
        agent.stop()
        httpd.server_close()
    finally:
        stub.stop()


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers(weights):
    """The port's stdlib server and the reference's aiohttp server over
    the same tiny model."""
    from helix_tpu.serving.openai_api import OpenAIServer as JServer

    pm = tprofile.ProfileModel(name="tiny-chat", engine=PLAIN_ENGINE)
    jpm = jprofile.ProfileModel(name="tiny-chat", engine=PLAIN_ENGINE)
    t_served = _port_build(weights)(name=pm.name, engine=pm.engine)
    j_served = _jax_build(weights)(jpm)
    treg, jreg = ModelRegistry(), jregistry.ModelRegistry()
    treg.register(t_served)
    jreg.register(j_served)
    agent = tagent.NodeAgent("r1", registry=treg, device="cpu")
    api = OpenAIServer(agent.registry, state=agent.heartbeat_payload)
    httpd = api.start()
    holder: dict = {}
    jport = _serve_app(JServer(jreg).build_app(), holder)
    yield types.SimpleNamespace(
        url=f"http://127.0.0.1:{httpd.server_address[1]}",
        jurl=f"http://127.0.0.1:{jport}", agent=agent, api=api)
    httpd.shutdown()
    t_served.loop.stop()
    j_served.loop.stop()
    for lp in holder.get("loops", []):
        lp.call_soon_threadsafe(lp.stop)


def _post(url, body, headers=None, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _events(text) -> list:
    out = []
    for block in text.strip().split("\n\n"):
        name, data = block.split("\n")
        name = name[len("event: "):]
        doc = json.loads(data[len("data: "):])
        if doc["type"] == "message_start":
            doc["message"].pop("id")
        out.append((name, doc))
    return out


@pytest.mark.parametrize("stream", [False, True])
def test_messages_equal_reference(servers, stream):
    body = {"model": "tiny-chat", "max_tokens": 14, "temperature": 0,
            "system": "be brief", "stream": stream,
            "messages": [{"role": "user", "content": "hello there"}]}
    ts, tout = _post(servers.url + "/v1/messages", body)
    js, jout = _post(servers.jurl + "/v1/messages", body)
    assert ts == js == 200
    if stream:
        te, je = _events(tout), _events(jout)
        assert te == je
        assert [n for n, _ in te][:2] == ["message_start",
                                          "content_block_start"]
        assert te[-1][0] == "message_stop"
        text = "".join(d["delta"]["text"] for n, d in te
                       if n == "content_block_delta")
    else:
        tdoc, jdoc = json.loads(tout), json.loads(jout)
        assert tdoc.pop("id").startswith("msg_") and jdoc.pop("id")
        assert tdoc == jdoc
        text = tdoc["content"][0]["text"]
    # the same text as the chat route for the same messages
    _, chat = _post(servers.url + "/v1/chat/completions", {
        "model": "tiny-chat", "max_tokens": 14, "temperature": 0,
        "messages": [{"role": "system", "content": "be brief"},
                     {"role": "user", "content": "hello there"}]})
    assert json.loads(chat)["choices"][0]["message"]["content"] == text


def test_messages_errors(servers):
    body = {"model": "nope", "messages": []}
    ts, tout = _post(servers.url + "/v1/messages", body)
    js, _ = _post(servers.jurl + "/v1/messages", body)
    assert ts == js == 404 and "model_not_found" in tout
    ts, tout = _post(servers.url + "/v1/messages", {
        "model": "tiny-chat", "max_tokens": "x", "messages": []})
    assert ts == 400 and "invalid sampling parameters" in tout


def test_logs_tail(servers):
    import logging

    logging.getLogger("helix_tpu_torch.node_agent").warning(
        "runner r1: a line for the tail")
    doc = json.loads(urllib.request.urlopen(servers.url + "/logs?tail=5")
                     .read())
    assert any("a line for the tail" in e["line"] for e in doc["logs"])
    assert len(doc["logs"]) <= 5
    st, _ = _post(servers.url + "/logs", {})
    assert st == 404
    try:
        urllib.request.urlopen(servers.url + "/logs?tail=x")
        raise AssertionError("expected 400")
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_profiler_capture_one_at_a_time(servers, tmp_path, monkeypatch):
    monkeypatch.setenv("HELIX_PROFILER_DIR", str(tmp_path))
    out = {}

    def first():
        out["first"] = _post(servers.url + "/admin/profiler",
                             {"seconds": 1.0})

    t = threading.Thread(target=first)
    t.start()
    _wait(lambda: servers.api._profiler_lock.locked(), 30, "the capture")
    st, body = _post(servers.url + "/admin/profiler", {"seconds": 0.1})
    assert st == 409 and "already running" in body
    # a chat during the capture lands in the trace's host operators
    _post(servers.url + "/v1/chat/completions", {
        "model": "tiny-chat", "max_tokens": 4, "temperature": 0,
        "messages": [{"role": "user", "content": "profile me"}]})
    t.join(60)
    st, body = out["first"]
    assert st == 200, body
    doc = json.loads(body)
    assert doc["seconds"] == 1.0
    assert os.path.dirname(doc["log_dir"]) == str(tmp_path)
    with open(os.path.join(doc["log_dir"], "trace.json")) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    st, body = _post(servers.url + "/admin/profiler", {"seconds": "x"})
    assert st == 400
    monkeypatch.setenv("HELIX_RUNNER_TOKEN", "sekrit")
    st, _ = _post(servers.url + "/admin/profiler", {"seconds": 0.01})
    assert st == 403
    st, _ = _post(servers.url + "/admin/profiler", {"seconds": 0.01},
                  {"X-Runner-Token": "sekrit"})
    assert st == 200


def test_state_route_is_the_heartbeat_body(servers, monkeypatch):
    # with federation off: each body drains the span ring (below)
    monkeypatch.setenv("HELIX_TRACE_FEDERATION", "0")
    doc = json.loads(urllib.request.urlopen(servers.url + "/api/v1/state")
                     .read())
    beat = servers.agent.heartbeat_payload()
    for d in (doc, beat):
        d.pop("ts")
        d.pop("disk")
        # wall-clock rates move between the two reads
        d["saturation"].pop("tokens_per_sec")
        for e in (d["tenants"] or {}).get("top", []):
            e.pop("goodput_tps")
    assert doc == beat
    assert doc["profile"]["models"] == ["tiny-chat"]
    bare = OpenAIServer(servers.agent.registry).start()
    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{bare.server_address[1]}/api/v1/state")
        raise AssertionError("expected 404 without an agent")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    finally:
        bare.shutdown()


def test_state_route_drains_the_span_ring_like_reference(servers):
    """Reference behaviour (ROADMAP C): ``/api/v1/state`` builds a
    heartbeat body, which pops the pending trace spans, so spans read
    there never reach the control plane.  The port matches it."""
    tid = "statetrace01"
    servers.agent.trace_store.record(tid, "probe", 0.0, 1.0)
    doc = json.loads(urllib.request.urlopen(servers.url + "/api/v1/state")
                     .read())
    assert tid in [s["trace_id"] for s in doc["traces"]["spans"]]
    assert tid not in [s["trace_id"] for s in
                       servers.agent.trace_summary().get("spans", [])]
    jstore = jtrace.TraceStore()
    jstore.enable_export()
    jstore.record(tid, "probe", 0.0, 1.0)
    assert len(jstore.drain_export()) == 1 and jstore.drain_export() == []


# ---------------------------------------------------------------------------
# serve-node in a subprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["sigterm", "control_plane"])
def test_serve_node_exits_zero_after_its_drain(how):
    """``sigterm``: a node started with ``--model`` (no assignment poll,
    as the reference's ``--profile`` node) drains on SIGTERM and exits
    0.  ``control_plane``: a node started without a profile applies the
    one assigned to it, and a drain request ends the process with 0."""
    stub = ControlStub().start()
    env = {**os.environ, "HELIX_DRAIN_SECONDS": "0.2",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    engine = {"max_decode_batch": 2, "num_pages": 64,
              "max_pages_per_seq": 16, "max_prefill_len": 64}
    argv = [sys.executable, "-m", "helix_tpu_torch", "serve-node",
            "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
            "--no-warmup", "--runner-id", "sub", "--control-plane", stub.url,
            "--heartbeat-interval", "0.2"]
    if how == "sigterm":
        argv += ["--model", "tiny-chat"]
        for k, v in engine.items():
            argv += ["--engine", f"{k}={v}"]
    else:
        stub.assign("sub", _profile_doc("sub-1", engine=engine))
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        stub.wait_for("sub", lambda b: b["profile"]["status"] == "running",
                      120)
        if how == "sigterm":
            proc.send_signal(signal.SIGTERM)
        else:
            stub.request_drain("sub")
        rc = proc.wait(timeout=120)
        err = proc.stderr.read()
        assert rc == 0, err[-2000:]
        assert stub.last("sub")["draining"] is True
        assert "model tiny-chat drained" in err
        assert "serving" in proc.stdout.read()
        if how == "control_plane":
            assert "control plane requested drain" in err
    finally:
        if proc.poll() is None:
            proc.kill()
        stub.stop()


def test_tunnel_is_refused_by_name(capsys):
    """``--tunnel`` is served (``tests/test_torch_tunnel.py``); without
    ``--control-plane`` to dial it is refused with the reference's
    text."""
    assert cli.main(["serve-node", "--tunnel", "--device", "cpu"]) == 2
    assert "--tunnel requires --control-plane" in capsys.readouterr().err

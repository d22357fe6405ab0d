"""The port's observability modules against the JAX package's.

- Registry (``obs/metrics.py``): the same metrics, samples and
  collectors render byte-identical Prometheus text in both packages;
  ``format_value``, ``escape_label_value`` and ``validate_metric_name``
  agree; ``testing/metric_families.parse_exposition`` reads every
  rendered line back.
- Flight recorder (``obs/flight.py``): the same step records give the
  same snapshot (anomalies, frozen tails, trailing p99) and the same
  window ratios; ``SATURATION_KEYS`` is the reference's tuple;
  ``RateTracker`` agrees on a scripted clock.
- Traces (``obs/trace.py``): the same spans give the same documents and
  Chrome events (up to each package's monotonic-to-wall anchor), the same
  per-trace cap and LRU; trace-id adoption agrees.
- ``/metrics`` shape: a tiny JAX ``EngineLoop`` behind the reference's
  ``OpenAIServer`` and the port's loop behind the port's server, after the
  same traffic: for every family both mint, the name, type and label keys
  are equal, and equal to the list ``helix_tpu_torch/testing/
  metric_families.json`` gives (the list ``chip_smoke.py`` holds the
  card's scrape to).
- Port lint: ``helix_*`` exposition is built only under
  ``helix_tpu_torch/obs/``, tenant-labelled series only in ``obs/slo.py``
  and ``helix_sched_*`` names and the scheduler's audit reasons only in
  ``serving/sched.py`` (contracts 2, 4 and 5 of the reference's
  ``tools/lint_metrics.py``, whose patterns are reused), and the scan
  finds planted violations.
- The obs modules and the scheduler import in a fresh interpreter without
  jax, helix_tpu or aiohttp.
"""

import importlib.util
import math
import os
import subprocess
import sys
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helix_tpu.engine import engine as jengine
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.obs import flight as jflight
from helix_tpu.obs import metrics as jmetrics
from helix_tpu.obs import trace as jtrace
from helix_tpu.serving import engine_loop as jloop
from helix_tpu.serving import kv_filestore as jkvfs
from helix_tpu.serving import openai_api as jopenai
from helix_tpu.serving import registry as jregistry
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.obs import flight as tflight
from helix_tpu_torch.obs import metrics as tmetrics
from helix_tpu_torch.obs import trace as ttrace
from helix_tpu_torch.serving import engine_loop as tloop
from helix_tpu_torch.serving import kv_filestore as tkvfs
from helix_tpu_torch.serving import openai_api as topenai
from helix_tpu_torch.serving import registry as tregistry
from helix_tpu_torch.serving import sched as tsched
from helix_tpu_torch.testing.metric_families import (
    check_scrape,
    metric_families,
    parse_exposition,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "helix_tpu_torch")


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


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _fill_registry(mod, seed: int):
    """The same metrics, samples and collectors in one package's
    registry; returns the registry."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    c = reg.counter("helix_requests_total", "Requests",
                    labelnames=("model", "outcome"))
    g = reg.gauge("helix_queue_depth", labelnames=("model",))
    h = reg.histogram("helix_ttft_seconds", "TTFT",
                      labelnames=("model",))
    fast = reg.histogram("helix_step_seconds", buckets=mod.FAST_BUCKETS)
    plain = reg.counter("helix_plain_total")
    models = ['m"1', "m\\2", "m\n3", "llama"]
    for i in range(40):
        m = models[i % len(models)]
        c.labels(model=m, outcome=("ok", "err")[i % 2]).inc(
            int(rng.integers(1, 5)))
        g.labels(model=m).set(float(rng.normal()) * 10 ** int(
            rng.integers(-3, 6)))
        h.labels(model=m).observe(float(rng.exponential(0.5)))
        fast.observe(float(rng.exponential(0.003)))
    plain.inc(3)
    solo = mod.Histogram("helix_inter_token_seconds",
                         buckets=mod.FAST_BUCKETS, labelnames=("kind",))
    for v in rng.exponential(0.02, size=25):
        solo.labels(kind="decode").observe(float(v))
    values = [0, 1, -2, 3.5, 1e20, 1e-9, float("nan"), float("inf"),
              -float("inf"), True, 12345678901234, 2.0 ** 53, 0.1 + 0.2]

    def collect(col):
        for i, v in enumerate(values):
            col.gauge("helix_values", v, {"i": str(i)}, help="edge values")
        col.counter("helix_cb_total", 7, {"model": "x"})
        col.metric(solo, {"model": "x"})

    reg.register_callback(collect)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_renders_byte_identical(seed):
    want = _fill_registry(jmetrics, seed).render()
    got = _fill_registry(tmetrics, seed).render()
    assert got == want
    fams = parse_exposition(got)
    assert fams["helix_ttft_seconds"] == ("histogram", ("model",))
    assert fams["helix_requests_total"] == ("counter", ("model", "outcome"))
    assert fams["helix_values"] == ("gauge", ("i",))


def test_value_helpers_agree():
    for v in [0, -1, 2.5, 1e15, 1e16, 1e-12, float("nan"), float("inf"),
              -float("inf"), False, 3.0, 10 ** 20, 0.30000000000000004]:
        assert tmetrics.format_value(v) == jmetrics.format_value(v)
    for s in ['a"b', "c\\d", "e\nf", "plain", ""]:
        assert tmetrics.escape_label_value(s) == \
            jmetrics.escape_label_value(s)
    for name in ["helix_ok_total", "helix_Bad", "other_x", "helix_a b"]:
        outs = []
        for mod in (jmetrics, tmetrics):
            try:
                outs.append(mod.validate_metric_name(name))
            except ValueError:
                outs.append(None)
        assert outs[0] == outs[1], name
    assert tmetrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS
    assert tmetrics.FAST_BUCKETS == jmetrics.FAST_BUCKETS


@pytest.mark.parametrize("bad", [
    "helix_x 1",                          # sample before its TYPE
    "# TYPE helix_x gauge\nhelix_x{a=1} 2",   # unquoted label value
    "# TYPE helix_x gauge\nhelix_x one",      # not a number
    "# TYPE helix_x gauge\n# TYPE helix_x gauge",
    "# TYPE helix_x summary",
])
def test_parse_exposition_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_exposition(bad)


def test_engine_loop_obs_families_agree():
    j, t = jmetrics.EngineLoopObs(), tmetrics.EngineLoopObs()
    for mod, o in ((jmetrics, j), (tmetrics, t)):
        for i, m in enumerate((o.queue_wait, o.ttft, o.inter_token,
                               o.step_seconds, o.host_build,
                               o.emit_seconds)):
            m.observe(0.001 * (i + 1))
    jc, tc = jmetrics.Collector(), tmetrics.Collector()
    j.collect(jc, {"model": "m"})
    t.collect(tc, {"model": "m"})
    assert tc.families == jc.families


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def _records(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(120):
        rec = {"step": i, "ts": 1000.0 + i,
               "duration": float(rng.exponential(0.05)),
               "slots_busy": int(rng.integers(0, 3)),
               "generated_tokens": int(rng.integers(0, 2)),
               "prefill_tokens": int(rng.integers(0, 2)) * 16,
               "padding_tokens": int(rng.integers(0, 8)),
               "idle_gap_s": float(rng.exponential(0.01)),
               "wall_s": float(rng.exponential(0.05))}
        if i in (50, 90):
            rec["duration"] = 3.0    # slow step once the baseline exists
        if i == 70:
            rec["anomaly"] = "step_failure"
        out.append(rec)
    return out


@pytest.mark.parametrize("seed", [0, 5])
def test_flight_recorder_agrees(seed):
    j, t = jflight.FlightRecorder(), tflight.FlightRecorder()
    for rec in _records(seed):
        assert t.record_step(dict(rec)) == j.record_step(dict(rec))
    for rec in (j, t):
        rec.note_anomaly("quarantine", request_id="r1", detail="x")
    js, ts = j.snapshot(recent=32), t.snapshot(recent=32)

    def strip(doc):
        for a in doc["anomalies"]:
            a["record"].pop("ts", None)
            a.pop("ts", None)
        return doc

    assert strip(ts) == strip(js)
    assert ts["anomalies_total"] >= 3
    for num, den in (("idle_gap_s", ("wall_s",)),
                     ("padding_tokens", ("padding_tokens",
                                         "prefill_tokens"))):
        assert t.window_ratio(num, den) == j.window_ratio(num, den)
    # the port's window accessors read the same ring
    assert t.recorded == t.steps_recorded == 120
    assert t.records(5) == js["recent"][-5:]


def test_saturation_keys_and_rate_tracker_agree():
    assert tflight.SATURATION_KEYS == jflight.SATURATION_KEYS
    j, t = jflight.RateTracker(10.0, 1.0), tflight.RateTracker(10.0, 1.0)
    v = 0
    for i in range(60):
        v += i % 7
        now = 100.0 + 0.4 * i
        assert t.rate(v, now=now) == j.rate(v, now=now)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


def test_trace_store_agrees():
    j = jtrace.TraceStore(max_traces=3, max_spans_per_trace=4)
    t = ttrace.TraceStore(max_traces=3, max_spans_per_trace=4)
    for store in (j, t):
        for k in range(5):
            tid = f"trace-{k:04d}-abcd"
            for s in range(6 if k == 4 else 2):
                store.record(tid, f"span{s}", 10.0 + s, 10.5 + s,
                             plane="engine", request_id=f"r{k}", n=s)
        store.record("", "ignored", 0.0, 1.0)
    assert t.ids() == j.ids() and len(t) == len(j) == 3
    assert t.dropped_spans == j.dropped_spans == 2
    for tid in j.ids():
        jd, td = j.get(tid), t.get(tid)
        for d in (jd, td):
            for s in d["spans"]:
                s.pop("start_unix")
        assert td == jd
        jc, tc = j.chrome_trace(tid), t.chrome_trace(tid)
        for d in (jc, tc):
            for e in d["traceEvents"]:
                e.pop("ts", None)
        assert tc == jc
    assert t.get("nope") is None and t.chrome_trace("nope") is None
    jcol, tcol = jmetrics.Collector(), tmetrics.Collector()
    jtrace.collect_trace_metrics(jcol, j)
    ttrace.collect_trace_metrics(tcol, t)
    assert tcol.families == jcol.families


def test_trace_ids_agree():
    assert ttrace.TRACE_HEADER == jtrace.TRACE_HEADER
    for v in ["abcdefgh", "short", "x" * 64, "x" * 65, "bad id!", None, 3,
              "0123456789abcdef0123456789abcdef"]:
        assert ttrace.is_trace_id(v) == jtrace.is_trace_id(v)
        if isinstance(v, str) and jtrace.is_trace_id(v):
            assert ttrace.adopt_trace_id(v) == v
    assert ttrace.is_trace_id(ttrace.new_trace_id())
    assert ttrace.adopt_trace_id("<bad>") != "<bad>"


# ---------------------------------------------------------------------------
# /metrics shape against the reference's _collect_metrics
# ---------------------------------------------------------------------------

GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=128,
                max_pages_per_seq=32, max_prefill_len=16,
                host_pool_bytes=1 << 20, adapter_pool_slots=3,
                adapter_rank=4)
SLO = {"ttft_p95_seconds": 2.0, "queue_wait_p95_seconds": 1.0,
       "goodput_floor_tps": 5,
       "sched": {"policy": "wfq", "max_tenant_queue_depth": 8,
                 "prefill_budget_tokens": 64}}


class _Manager:
    """A registry with a residency manager's surface (``prefetch``,
    ``stats``) over one served model."""

    def __init__(self, served):
        self._served = served

    def list(self):
        return [self._served]

    def names(self):
        return [self._served.name]

    def get(self, name):
        return self._served if name == self._served.name else None

    def prefetch(self, name):
        return False

    def stats(self):
        return {"loads": 2, "evictions": 1, "used_bytes": 5 << 20,
                "budget_bytes": 1 << 30,
                "swap_seconds": {self._served.name: 0.25},
                "load_seconds": {self._served.name: 1.5}}


def _drive(loop, mod, tenants=("a", "b")):
    """Two greedy requests of two tenants through a started loop."""
    done = []
    for i, tenant in enumerate(tenants):
        ev = threading.Event()
        req = mod.Request(
            id=f"shape-{i}", prompt_tokens=[5 + i, 6, 7, 8, 9],
            sampling=(jengine.SamplingParams if mod is jengine
                      else tengine.SamplingParams)(
                max_tokens=4, temperature=0.0),
            tenant=tenant, trace_id=f"trace-shape-{i:04d}")
        loop.submit(req, lambda e, ev=ev: e.finished and ev.set())
        done.append(ev)
    for ev in done:
        assert ev.wait(60)


def build_scrapes():
    """(the reference's collected families, the port's scrape text) after
    the same traffic through equivalent loops."""
    jcfg = JModelConfig.tiny(dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    tcfg = ModelConfig.tiny(dtype="float32")
    jl = jloop.EngineLoop(jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **GEOMETRY, attn_backend="reference")), "m", slo_targets=SLO,
        sched_config=SLO).start()
    tl = tloop.EngineLoop(tengine.Engine(
        tcfg, tp, tengine.EngineConfig(**GEOMETRY), device="cpu"), "m",
        slo_targets=SLO, sched_config=SLO).start()
    # the filestore tier armed on both, so its series are in both scrapes
    for loop, mod in ((jl, jkvfs), (tl, tkvfs)):
        eng = loop.engine
        eng.kv_filestore = mod.filestore_for_engine(
            tempfile.mkdtemp(prefix="helix-obs-fs-"), eng.model_cfg,
            eng.cache_cfg)
    try:
        _drive(jl, jengine)
        _drive(tl, tengine)
    finally:
        jl.stop()
        tl.stop()
    for loop in (jl, tl):
        loop.engine.adapter_pool.note_rows({"ad1": 3})
    jserver = jopenai.OpenAIServer(_Manager(jregistry.ServedModel(
        name="m", loop=jl, tokenizer=None)))
    tserver = topenai.OpenAIServer(_Manager(tregistry.ServedModel(
        name="m", loop=tl, tokenizer=None)))
    jcol = jmetrics.Collector()
    jserver._collect_metrics(jcol)
    return jcol.families, tserver.render_metrics()


@pytest.fixture(scope="module")
def scrapes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HELIX_PEAK_FLOPS", "1e12")
        return build_scrapes()


def _families(fams: dict) -> dict:
    return {n: (f[0], tuple(sorted({k for _s, lbl, _v in f[2]
                                    for k in lbl} - {"le"})))
            for n, f in fams.items()}


def test_metrics_families_match_the_reference(scrapes):
    jfams, text = scrapes
    ref = _families(jfams)
    got = parse_exposition(text)
    both = set(ref) & set(got)
    assert len(both) >= 100
    for name in sorted(both):
        assert got[name] == ref[name], name
    # the port mints nothing the reference does not
    assert set(got) <= set(ref), sorted(set(got) - set(ref))
    # what the reference mints and the port leaves out: the quantities
    # the port does not have yet (ROADMAP lists each with its item)
    missing = set(ref) - set(got)
    assert all(n.startswith("helix_compiled_step_shapes")
               for n in missing), sorted(missing)
    # the MoE drop counter (A15a)
    assert "helix_moe_dropped_tokens_total" in got
    # the context cache's series
    ctx = {n for n in ref if n.startswith("helix_ctx_")}
    assert len(ctx) == 7 and ctx <= set(got)
    # the disaggregated handoff's counter and the filestore tier's series
    assert "helix_xfer_prefill_handoffs_total" in got
    fs = {n for n in ref if n.startswith("helix_filestore_kv_")}
    assert len(fs) == 7 and fs <= set(got)


def test_metric_families_list_is_the_reference_shape(scrapes):
    """The shared list equals the reference's shape for every family,
    and the port's scrape passes ``check_scrape`` against it."""
    jfams, text = scrapes
    ref = _families(jfams)
    listed = metric_families()
    assert set(listed) == set(parse_exposition(text))
    for name, shape in listed.items():
        assert shape == ref[name], name
    assert check_scrape(text) == []
    assert check_scrape(text.replace('model="m"', 'modl="m"', 1))
    assert check_scrape(text + "helix_bogus 1\n")


def test_metrics_values_follow_the_loop(scrapes):
    _jfams, text = scrapes
    lines = text.splitlines()

    def value(prefix):
        (line,) = [ln for ln in lines if ln.startswith(prefix + " ")]
        return float(line.rsplit(" ", 1)[1])

    assert value('helix_tenant_requests_total{model="m",tenant="a"}') == 1
    assert value('helix_sched_wfq_enabled{model="m"}') == 1
    assert value('helix_sched_admitted_requests_total{model="m",'
                 'class="interactive"}') == 2
    assert value('helix_residency_loads_total') == 2
    assert value('helix_model_swap_seconds{model="m"}') == 0.25
    assert value('helix_adapter_rows_applied_total{model="m",'
                 'adapter="ad1"}') == 3
    assert value('helix_ttft_seconds_count{model="m"}') == 2
    assert math.isfinite(value('helix_mfu_estimate{model="m"}'))


# ---------------------------------------------------------------------------
# port lint (contracts 2, 4 and 5 of tools/lint_metrics.py, for the port)
# ---------------------------------------------------------------------------


def _lint_module():
    spec = importlib.util.spec_from_file_location(
        "_lint_metrics", os.path.join(ROOT, "tools", "lint_metrics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_lint(root: str) -> list:
    """Violations of the port's exposition, tenant-label and scheduler
    vocabulary contracts under ``root`` (a ``helix_tpu_torch`` tree)."""
    lint = _lint_module()
    reasons = [__import__("re").compile(r"""["']{}["']""".format(r))
               for r in tsched.SCHED_AUDIT_REASONS]
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            in_obs = rel.startswith("obs" + os.sep)
            with open(path, encoding="utf-8") as f:
                lines = f.read().splitlines()
            for i, line in enumerate(lines, 1):
                where = f"{rel}:{i}"
                if not in_obs and (lint._ADHOC_FSTRING.search(line)
                                   or lint._ADHOC_TYPE.search(line)):
                    out.append(f"{where}: exposition outside obs/")
                if rel != os.path.join("obs", "slo.py") and (
                        lint._TENANT_NAME_RE.search(line)
                        or lint._TENANT_LABEL_CALL.search(line)):
                    out.append(f"{where}: tenant series outside obs/slo.py")
                if rel != os.path.join("serving", "sched.py") and (
                        lint._SCHED_NAME_RE.search(line)
                        or any(p.search(line) for p in reasons)):
                    out.append(f"{where}: scheduler vocabulary outside "
                               "serving/sched.py")
    return out


def test_port_lint_is_clean():
    assert _port_lint(PKG) == []


@pytest.mark.parametrize("line,what", [
    ('x = f"helix_foo{{a}} {{v}}"', "exposition"),
    ('x = "# TYPE helix_foo gauge"', "exposition"),
    ('c.gauge("helix_tenant_x", 1, {"tenant": t})', "tenant"),
    ('c.counter("helix_other_total", 1, {"model": m, "tenant": t})',
     "tenant"),
    ('c.gauge("helix_sched_x", 1)', "scheduler"),
    ('reason = "sched_shed_victim"', "scheduler"),
])
def test_port_lint_finds_planted_violations(tmp_path, line, what):
    (tmp_path / "serving").mkdir()
    (tmp_path / "serving" / "mod.py").write_text(line + "\n")
    found = _port_lint(str(tmp_path))
    assert found and what in found[0], found


def test_obs_and_sched_import_without_jax_or_aiohttp():
    code = (
        "import sys, importlib\n"
        "for m in ('metrics', 'flight', 'trace', 'slo'):\n"
        "    importlib.import_module('helix_tpu_torch.obs.' + m)\n"
        "importlib.import_module('helix_tpu_torch.serving.sched')\n"
        "importlib.import_module('helix_tpu_torch.serving.openai_api')\n"
        "importlib.import_module('helix_tpu_torch.testing.metric_families')\n"
        "for m in ('control.profile', 'control.node_agent', "
        "'serving.logbuf', 'cli', 'testing.control_stub', "
        "'control.tunnel', 'control.websocket', 'models.bge', "
        "'serving.tokenizer_json', 'testing.hf_checkpoint', "
        "'testing.tokenizer_fixtures', 'serving.kv_filestore', "
        "'control.filestore', 'serving.context_cache', 'ops.paged', "
        "'engine.engine', 'models.moe'):\n"
        "    importlib.import_module('helix_tpu_torch.' + m)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'helix_tpu', 'aiohttp', 'requests')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_port_imports_and_serves_images_with_heavy_packages_blocked():
    """Every module of the port, and ``chip_smoke.py``, import with
    ``jax``, ``helix_tpu``, ``PIL``, ``transformers``, ``aiohttp``,
    ``safetensors``, ``tokenizers`` and ``ml_dtypes`` made unimportable
    (the card's machine lacks most of them); the VL path then decodes a
    PNG, resizes, patchifies and runs a tiny tower and prompt there, and
    a tiny MoE layer runs."""
    code = (
        "import sys, importlib, pkgutil\n"
        "BLOCKED = ('jax', 'jaxlib', 'helix_tpu', 'PIL', 'transformers', "
        "'aiohttp', 'safetensors', 'tokenizers', 'ml_dtypes')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import helix_tpu_torch\n"
        "for m in pkgutil.walk_packages(helix_tpu_torch.__path__, "
        "'helix_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "import numpy as np\n"
        "from helix_tpu_torch.models import qwen2_vl as vl\n"
        "from helix_tpu_torch.serving import vision\n"
        "from helix_tpu_torch.serving.tokenizer import ByteTokenizer\n"
        "from helix_tpu_torch.testing.png import random_png\n"
        "import base64\n"
        "url = 'data:image/png;base64,' + base64.b64encode(random_png("
        "np.random.default_rng(0), 40, 60)).decode()\n"
        "vc = vl.VisionConfig.tiny(hidden_size=64)\n"
        "r = vision.VisionRunner(vc, vl.init_vision_params(vc, 0, "
        "device='cpu'), image_pad_id=264)\n"
        "out = r.prepare([{'role': 'user', 'content': [{'type': "
        "'image_url', 'image_url': {'url': url}}]}], ByteTokenizer())\n"
        "assert out['image_embeds'].shape[1] == 64\n"
        "import torch\n"
        "from helix_tpu_torch.models import moe\n"
        "from helix_tpu_torch.models.common import ModelConfig\n"
        "mc = ModelConfig.tiny(num_experts=4, dtype='float32')\n"
        "g = torch.Generator().manual_seed(0)\n"
        "ex = {k: {'weight': torch.randn(s, generator=g)} for k, s in "
        "(('w_gate', (4, 64, 128)), ('w_up', (4, 64, 128)), "
        "('w_down', (4, 128, 64)))}\n"
        "y, d = moe.moe_ffn(torch.randn(1, 6, 64, generator=g), "
        "torch.randn(64, 4, generator=g), ex, mc, torch.nn.functional.silu, "
        "return_dropped=True)\n"
        "assert y.shape == (1, 6, 64) and int(d) >= 0\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"

"""Request snapshots and migration in the port, and across the two packages.

- **Round trip in the port**: export mid-generation, through the wire
  (JSON), import into another engine and continue: greedy and seeded
  temperature 0.8 with penalties give the uninterrupted tokens, float32
  and int8 KV; a queued request travels without KV.
- **Refusals before mutation**: a corrupt page, corrupt meta, a wrong
  version or KV geometry fail with a typed ``SnapshotError`` and leave
  the engine as it was.
- **Across backends**: a JAX engine's snapshot imports into the port and
  continues with the JAX engine's tokens, and the port's into the JAX
  engine, for float32 and int8 pools.  The wire JSON that one package
  writes, decoded and written again by the other, is the same bytes
  (page checksums included), and both packages' exports at the same
  point agree on every field but the page bytes.
- **bf16 without ml_dtypes**: a bf16 wire page from the reference's
  encoder decodes in a fresh interpreter where ``ml_dtypes`` cannot be
  imported.
- ``PeerShipper`` with an injected ``post``; two port servers over HTTP:
  server A drains with a ``PeerShipper`` aimed at server B, the client
  stream ends with a ``migrated ... peer=`` frame, ``/v1/migrate/resume``
  on B continues it, every token exactly once.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.engine import engine as jengine
from helix_tpu.engine import sampling as jsampling
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.serving import migration as jmigration
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine import sampling as tsampling
from helix_tpu_torch.engine.engine import SNAPSHOT_VERSION, SnapshotError
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.serving import migration
from helix_tpu_torch.testing import faults

VOCAB = 512
GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=64,
                max_pages_per_seq=16, max_prefill_len=64)
PROMPT = list(range(7, 30))
SEEDED = dict(max_tokens=16, temperature=0.8, seed=77,
              presence_penalty=0.5, frequency_penalty=0.3)
GREEDY = dict(max_tokens=16, temperature=0.0)


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
    jp = jinit(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(vocab_size=VOCAB, dtype="float32"), tp


def _port(weights, **kw):
    *_, cfg, tp = weights
    return tengine.Engine(cfg, tp, tengine.EngineConfig(
        **{**GEOMETRY, **kw}), device="cpu")


def _ref(weights, **kw):
    jcfg, jp, _, _ = weights
    return jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **{**GEOMETRY, **kw}, attn_backend="reference"))


def _req(mod, smod, rid, samp, prompt=PROMPT):
    return mod.Request(id=rid, prompt_tokens=list(prompt),
                       sampling=smod.SamplingParams(**samp),
                       tenant="tenant-x", trace_id="trace-0123456789",
                       sched_class="interactive")


def _run(eng, req):
    eng.add_request(req)
    while not req.finished:
        eng.step()
    return list(req.output_tokens)


def _export_at(mod, smod, eng, rid, samp, cut):
    """Decode ``rid`` to ``cut`` tokens, snapshot it, drop it locally."""
    req = _req(mod, smod, rid, samp)
    eng.add_request(req)
    while len(req.output_tokens) < cut:
        eng.step()
    snap = eng.export_request(rid)
    assert snap is not None and snap.has_kv
    eng.abort(rid)
    return snap, list(req.output_tokens)


def _continue(eng, snap):
    req = eng.import_request(snap)
    assert (req.tenant, req.sched_class) == ("tenant-x", "interactive")
    while not req.finished:
        eng.step()
    return list(req.output_tokens)


def _engine_state(eng) -> tuple:
    return (eng.allocator.free_pages, len(eng.waiting), len(eng.preempted),
            sorted(eng._requests), eng.num_snapshots_imported)


# ---------------------------------------------------------------------------
# round trip in the port
# ---------------------------------------------------------------------------


# greedy with penalties: the shipped histogram decides tokens after the
# cut (an import that dropped it changes the continuation)
PENALISED = dict(GREEDY, presence_penalty=0.8, frequency_penalty=0.4)


@pytest.mark.parametrize("kv_dtype,samp", [
    ("auto", GREEDY), ("auto", SEEDED), ("int8", SEEDED),
    ("auto", PENALISED)],
    ids=["f32-greedy", "f32-seeded", "int8-seeded", "f32-penalised"])
def test_round_trip_through_the_wire_is_bit_identical(weights, kv_dtype,
                                                      samp):
    ref = _run(_port(weights, kv_cache_dtype=kv_dtype),
               _req(tengine, tsampling, "ref", samp))
    snap, head = _export_at(tengine, tsampling,
                            _port(weights, kv_cache_dtype=kv_dtype), "m",
                            samp, 6)
    wire = json.loads(json.dumps(migration.snapshot_to_wire(snap)))
    back = migration.wire_to_snapshot(wire)
    assert back.page_checksums == snap.page_checksums
    for a, b in zip(snap.pages, back.pages):
        for f in a:
            assert (a[f] is None and b[f] is None) or torch.equal(a[f], b[f])
    assert (back.key, back.token_counts) == (snap.key, snap.token_counts)
    got = _continue(_port(weights, kv_cache_dtype=kv_dtype), back)
    assert head == ref[:6] and got == ref


def test_queued_request_travels_without_kv(weights):
    eng = _port(weights)
    req = _req(tengine, tsampling, "q", GREEDY)
    eng.add_request(req)
    snap = eng.export_request("q")
    assert snap.position is None and not snap.pages and not snap.has_kv
    back = migration.wire_to_snapshot(migration.snapshot_to_wire(snap))
    assert _continue(_port(weights), back) == \
        _run(_port(weights), _req(tengine, tsampling, "r", GREEDY))


def test_export_ships_only_written_pages(weights):
    eng = _port(weights)
    req = _req(tengine, tsampling, "w", dict(max_tokens=40,
                                             temperature=0.0))
    eng.add_request(req)
    while len(req.output_tokens) < 3:
        eng.step()
    snap = eng.export_request("w")
    assert len(snap.pages) == -(-req.num_tokens // 4)
    assert snap.total_pages == -(-(len(PROMPT) + 40) // 4)


def _snapshot(weights, rid="bad"):
    snap, _ = _export_at(tengine, tsampling, _port(weights), rid, GREEDY, 4)
    return snap


def test_corrupt_page_rejected_before_any_mutation(weights):
    wire = migration.snapshot_to_wire(_snapshot(weights))
    flipped = jmigration._flip_wire_page(wire, 1)
    assert flipped["meta_checksum"] == wire["meta_checksum"]
    snap = migration.wire_to_snapshot(flipped)
    eng = _port(weights)
    before = _engine_state(eng)
    with pytest.raises(SnapshotError) as e:
        eng.import_request(snap)
    assert e.value.code == "snapshot_corrupt"
    assert _engine_state(eng) == before
    # a truncated page list cannot cover the written KV
    short = migration.wire_to_snapshot(wire)
    short.pages, short.page_checksums = short.pages[:1], \
        short.page_checksums[:1]
    with pytest.raises(SnapshotError, match="cover") as e:
        eng.import_request(short)
    assert e.value.code == "snapshot_corrupt"
    assert _engine_state(eng) == before


def test_corrupt_meta_and_wrong_version_rejected(weights):
    wire = migration.snapshot_to_wire(_snapshot(weights))
    bad = {**wire, "output_tokens": wire["output_tokens"][:-1] + [3]}
    with pytest.raises(SnapshotError) as e:
        migration.wire_to_snapshot(bad)
    assert e.value.code == "snapshot_corrupt"
    with pytest.raises(SnapshotError) as e:
        migration.wire_to_snapshot({**wire, "version": 99})
    assert e.value.code == "snapshot_unsupported"
    snap = migration.wire_to_snapshot(wire)
    snap.version = 99
    with pytest.raises(SnapshotError) as e:
        _port(weights).import_request(snap)
    assert e.value.code == "snapshot_unsupported"


@pytest.mark.parametrize("field,value", [
    ("page_size", 8), ("num_layers", 3), ("kv_heads", 1), ("head_dim", 8),
    ("kv_dtype", "int8")])
def test_geometry_mismatch_rejected(weights, field, value):
    snap = _snapshot(weights)
    setattr(snap, field, value)
    eng = _port(weights)
    before = _engine_state(eng)
    with pytest.raises(SnapshotError) as e:
        eng.import_request(snap)
    assert e.value.code == "snapshot_incompatible"
    assert _engine_state(eng) == before


def test_duplicate_import_rejected(weights):
    snap = _snapshot(weights)
    eng = _port(weights)
    eng.import_request(snap)
    with pytest.raises(SnapshotError) as e:
        eng.import_request(snap)
    assert e.value.code == "snapshot_duplicate"


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _wire_text(doc) -> str:
    return json.dumps(doc)


def _meta_only(doc) -> dict:
    return {k: v for k, v in doc.items()
            if k not in ("pages", "page_checksums", "meta_checksum")}


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("samp", [GREEDY, SEEDED], ids=["greedy", "seeded"])
def test_snapshots_cross_between_jax_and_the_port(weights, kv_dtype, samp):
    """JAX -> port and port -> JAX, through each package's own wire
    codec: the document written again by the other package is the same
    JSON text, and the continuation is the uninterrupted run's tokens,
    which both packages share."""
    cut = 6
    ref_j = _run(_ref(weights, kv_cache_dtype=kv_dtype),
                 _req(jengine, jsampling, "ref", samp))
    ref_t = _run(_port(weights, kv_cache_dtype=kv_dtype),
                 _req(tengine, tsampling, "ref", samp))
    assert ref_t == ref_j
    # JAX exports, the port imports
    snap_j, head_j = _export_at(jengine, jsampling,
                                _ref(weights, kv_cache_dtype=kv_dtype),
                                "x", samp, cut)
    wire_j = _wire_text(jmigration.snapshot_to_wire(snap_j))
    into_t = migration.wire_to_snapshot(json.loads(wire_j))
    assert _wire_text(migration.snapshot_to_wire(into_t)) == wire_j
    got_t = _continue(_port(weights, kv_cache_dtype=kv_dtype), into_t)
    # the port exports, JAX imports
    snap_t, head_t = _export_at(tengine, tsampling,
                                _port(weights, kv_cache_dtype=kv_dtype),
                                "x", samp, cut)
    wire_t = _wire_text(migration.snapshot_to_wire(snap_t))
    into_j = jmigration.wire_to_snapshot(json.loads(wire_t))
    assert _wire_text(jmigration.snapshot_to_wire(into_j)) == wire_t
    assert into_j.page_checksums == snap_t.page_checksums
    got_j = _continue(_ref(weights, kv_cache_dtype=kv_dtype), into_j)
    assert head_j == head_t == ref_j[:cut]
    assert got_t == got_j == ref_j
    # both exports at the same point: every field but the page bytes
    assert _meta_only(json.loads(wire_j)) == _meta_only(json.loads(wire_t))
    assert json.loads(wire_j)["pages"][0]["k"]["dtype"] == \
        json.loads(wire_t)["pages"][0]["k"]["dtype"]


@pytest.mark.parametrize("kv_dtype", ["auto", "int8", "bfloat16"])
def test_wire_codec_is_json_byte_for_byte(weights, kv_dtype):
    """``json_bytes`` writes the bytes ``json.dumps(...).encode()`` writes
    and ``json_loads`` reads what ``json.loads`` reads, for the port's and
    the reference's wires, a wire with a flipped page (plain dicts) and a
    filestore blob; the decoded pages are the same tensors, and the port's
    own wire takes the fast path (each page buffer comes back holding its
    decoded bytes)."""
    snap = _snapshot(weights) if kv_dtype == "auto" else _export_at(
        tengine, tsampling, _port(weights, kv_cache_dtype=kv_dtype), "c",
        GREEDY, 4)[0]
    wire = migration.snapshot_to_wire(snap)
    ref = jmigration.snapshot_to_wire(jmigration.wire_to_snapshot(
        json.loads(json.dumps(wire))))
    blob = {"namespace": "n", "tenant": "t\u00e9", "checksum": "00",
            "page": {f: migration._encode_array(snap.pages[0][f])
                     for f in snap.pages[0]}}
    for doc in (wire, ref, jmigration._flip_wire_page(wire, 0), blob,
                {**wire, "tenant": '"b64": "QUJD"\n\u2028'}):
        text = json.dumps(doc).encode()
        assert migration.json_bytes(doc) == text
        back = migration.json_loads(text)
        assert back == json.loads(text)
    # a member rewritten after the encode is written from its new text
    moved = migration.snapshot_to_wire(snap)
    moved["pages"][0]["k"]["b64"] = wire["pages"][1]["k"]["b64"]
    assert migration.json_bytes(moved) == json.dumps(moved).encode()
    fast = migration.json_loads(migration.json_bytes(wire))
    bufs = [p[f] for p in fast["pages"] for f in p if p[f] is not None]
    assert bufs and all(type(b) is migration._Buffer and b.current()
                        and b.raw is not None for b in bufs)
    got = migration.wire_to_snapshot(fast)
    want = migration.wire_to_snapshot(json.loads(json.dumps(wire)))
    for a, b in zip(got.pages, want.pages):
        for f in a:
            assert (a[f] is None and b[f] is None) or (
                a[f].dtype == b[f].dtype and torch.equal(a[f], b[f]))
    # a member mutated after the read is decoded from its new text
    fast["pages"][0]["k"]["b64"] = json.loads(json.dumps(wire))[
        "pages"][1]["k"]["b64"]
    assert torch.equal(migration._decode_array(fast["pages"][0]["k"]),
                       want.pages[1]["k"])


@pytest.mark.parametrize("text", [
    b'{"b64": "QUJD"}', b'{"b64": ""}', b'{"b64": "QQ=="}',
    b'{"b64": "QUI="}', b'{"b64": "===="}', b'{"b64": "AB=C"}',
    b'{"b64": "QQ==QUJD"}', b'{"b64": "QQ==\nAAA"}', b'{"b64": "QU\nJD"}',
    b'{"b64": "QU\x01J"}', b'{"b64": "QUJ\xc3\xa9"}', b'{"b64": "Q\\u0051=="}',
    b'{"x\\"b64": "QUJD"}', b'{"b64": "QUJD", "y": ["b64"]}',
    b'[{"b64": "QUJD"}]', b'{"b64": "QUJD"',
    b'{"a": {"b64": "QUJD"}, "b64": "QUJD"}',
    b'{"a": [{"c": {"b64": "QUJD"}, "b64": "QUJD"}], "b64": "QUJD"}',
    b'\xef\xbb\xbf{"b64": "QUJD"}', b'{"b64": "QUJD", "b": "\\u0000"}',
    b'{"b64": "QUJD", "s": "\\u0000' + b'0' * 16 + b':0"}',
    b'{"b64": "QUJD" "b64": "QUJD"}', b'{"b64":"QUJD"}'])
def test_json_loads_is_json_loads_on_hostile_text(text):
    """Texts that are not plain base64 in a whole ``b64`` string member
    (control characters, escapes, misplaced padding, a key that merely
    ends in ``b64``, invalid JSON) read as ``json.loads`` reads them,
    or raise what it raises."""
    try:
        want = json.loads(text)
    except ValueError as e:
        with pytest.raises(type(e)):
            migration.json_loads(text)
        return
    assert migration.json_loads(text) == want


def test_import_with_speculation_matches_reference(weights):
    """Speculation on at both ends: an imported request starts with
    fresh drafter state on the importer, in both packages, so tokens and
    spec counters after the import equal the JAX engine's."""
    spec = dict(enable_spec_decode=True, spec_tokens=3)
    prompt = [5, 6, 7, 8] * 6
    got = []
    for mod, smod, codec, mk in (
            (tengine, tsampling, migration, _port),
            (jengine, jsampling, jmigration, _ref)):
        req = mod.Request(id="s", prompt_tokens=list(prompt),
                          sampling=smod.SamplingParams(**GREEDY),
                          tenant="tenant-x", sched_class="interactive")
        src = mk(weights, **spec)
        src.add_request(req)
        while len(req.output_tokens) < 5:
            src.step()
        snap = src.export_request("s")
        dst = mk(weights, **spec)
        out = _continue(dst, codec.wire_to_snapshot(json.loads(
            json.dumps(codec.snapshot_to_wire(snap)))))
        got.append((out, dst.num_spec_steps, dst.num_spec_drafted_tokens,
                    dst.num_spec_accepted_tokens))
    assert got[0] == got[1]
    assert got[0][1] > 0


def test_parked_port_request_exports_to_jax(weights):
    """A request preempted to the port's host tier exports from the
    parked pages (host pool + device prefix) and continues in JAX."""
    samp = dict(SEEDED)
    ref = _run(_port(weights), _req(tengine, tsampling, "ref", samp))
    eng = _port(weights, host_pool_bytes=1 << 22)
    req = _req(tengine, tsampling, "p", samp)
    eng.add_request(req)
    while len(req.output_tokens) < 5:
        eng.step()
    assert eng.preempt("p")
    snap = eng.export_request("p")
    assert snap.has_kv and snap.total_pages == len(eng.preempted[0].table)
    into_j = jmigration.wire_to_snapshot(
        json.loads(_wire_text(migration.snapshot_to_wire(snap))))
    assert _continue(_ref(weights), into_j) == ref


def test_bf16_wire_decodes_without_ml_dtypes(tmp_path):
    """The reference encodes a bf16 page (numpy through ml_dtypes); the
    port decodes it where ``ml_dtypes`` cannot be imported, to the same
    bytes, and writes the same document back."""
    rng = np.random.default_rng(0)
    page = jnp.asarray(rng.standard_normal((2, 4, 2, 8)),
                       dtype=jnp.bfloat16)
    doc = jmigration._encode_array(np.asarray(page))
    assert doc["dtype"] == "bfloat16"
    path = tmp_path / "page.json"
    path.write_text(json.dumps(doc))
    code = (
        "import json, sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "from helix_tpu_torch.serving import migration as m\n"
        "from helix_tpu_torch.engine.kv_cache import raw_bytes\n"
        f"doc = json.load(open({str(path)!r}))\n"
        "t = m._decode_array(doc)\n"
        "assert str(t.dtype) == 'torch.bfloat16', t.dtype\n"
        "assert m._encode_array(t) == doc\n"
        "assert 'ml_dtypes' not in [k for k, v in sys.modules.items()"
        " if v is not None]\n"
        "print(raw_bytes(t).hex())\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == np.asarray(page).tobytes().hex()


# ---------------------------------------------------------------------------
# PeerShipper
# ---------------------------------------------------------------------------


class _Resp:
    def __init__(self, status_code):
        self.status_code = status_code


def test_peer_shipper_with_injected_post():
    calls = []

    def post(url, json=None, headers=None, timeout=None):
        calls.append((url, headers, timeout))
        return _Resp(422 if "bad" in url else 200)

    stats = migration.XferStats()
    wire = {"model": "m", "trace_id": "trace-0123456789",
            "pages": [{"k": {"b64": "AAAA"}, "v": None}]}
    ship = migration.PeerShipper(
        targets=[{"id": "bad", "address": "http://bad:1/", "models": ["m"]},
                 {"id": "good", "address": "http://good:2"},
                 {"id": "other", "address": "http://o:3", "models": ["z"]}],
        runner_token="tok", post=post, stats=stats,
        config=migration.XferConfig(attempt_timeout=5.0, max_attempts=1))
    assert ship(wire) == "good"
    assert [c[0] for c in calls] == ["http://bad:1/v1/migrate/import",
                                     "http://good:2/v1/migrate/import"]
    assert calls[1][1] == {"X-Runner-Token": "tok",
                           migration.TRACE_HEADER: "trace-0123456789"}
    snap = stats.snapshot()
    assert snap["attempts"]["rejected"] == 1 and snap["attempts"]["ok"] == 1
    assert snap["shipped_pages"] == 1 and snap["shipped_bytes"] == 4
    # every attempt dropped by the fault hook: backoff, then a typed error
    faults.arm(rules=[{"point": "transfer", "mode": "drop"}])
    sleeps = []
    ship = migration.PeerShipper(
        targets=[{"id": "good", "address": "http://good:2"}], post=post,
        sleep=sleeps.append, stats=stats,
        config=migration.XferConfig(max_attempts=3, backoff_base=0.1,
                                    backoff_cap=0.15, deadline=60.0))
    with pytest.raises(RuntimeError, match="injected transfer drop"):
        ship(wire)
    assert sleeps == [0.1, 0.15]
    # past the whole-transfer deadline
    faults.disarm()
    clock = iter([0.0, 100.0]).__next__
    ship = migration.PeerShipper(
        targets=[{"id": "good", "address": "http://good:2"}], post=post,
        clock=clock, stats=stats, config=migration.XferConfig(deadline=1.0))
    with pytest.raises(RuntimeError, match="deadline"):
        ship(wire)
    assert migration.parse_migrated_peer(
        migration.migrated_error("r1", "peer-b")) == "peer-b"
    assert migration.parse_migrated_peer("shutting_down: x") is None


@pytest.mark.parametrize("prefill", [False, True], ids=["drain", "handoff"])
def test_xfer_stats_and_handoff_counter_equal_reference(prefill):
    """``PeerShipper(prefill=True)`` counts a shipped snapshot as a
    disaggregated prefill handoff, as the reference's does; the drain
    shipper does not.  The stats snapshots of both packages agree key for
    key over the same ship, and so do the handoff headers' names."""
    wire = {"model": "m", "pages": [{"k": {"b64": "AAAA"}, "v": None}]}
    snaps = []
    for mod in (migration, jmigration):
        stats = mod.XferStats()
        ship = mod.PeerShipper(
            targets=[{"id": "d", "address": "http://d:1"}],
            post=lambda url, json=None, headers=None, timeout=None:
            _Resp(200), stats=stats, prefill=prefill,
            config=mod.XferConfig(max_attempts=1))
        assert ship(wire) == "d"
        snaps.append(stats.snapshot())
    snaps[0]["ship_seconds"] = snaps[1]["ship_seconds"] = 0.0
    assert snaps[0] == snaps[1]
    assert snaps[0]["prefill_handoffs"] == (1 if prefill else 0)
    assert (migration.DISAGG_HEADER, migration.DISAGG_PEER_ID_HEADER,
            migration.DISAGG_PEER_ADDR_HEADER) == (
        jmigration.DISAGG_HEADER, jmigration.DISAGG_PEER_ID_HEADER,
        jmigration.DISAGG_PEER_ADDR_HEADER)
    assert migration.XFER_PREFILL_HANDOFFS == jmigration.XFER_PREFILL_HANDOFFS


# ---------------------------------------------------------------------------
# two port servers: drain A, resume on B
# ---------------------------------------------------------------------------


class _IdTokenizer:
    """The byte tokenizer, but ``decode`` writes every id as ``<id>`` (a
    random-weight model draws ids past the 256 bytes) and no id ends a
    stream, so every run is ``max_tokens`` long."""

    eos_ids = ()

    def __init__(self, tok):
        self._tok = tok

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def decode(self, ids) -> str:
        return "".join(f"<{i}>" for i in ids)


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _frames(raw: str) -> list:
    return [f[6:] for f in raw.split("\n\n") if f.startswith("data: ")]


def test_two_servers_drain_and_resume_over_http():
    from helix_tpu_torch.cli import build_served_model
    from helix_tpu_torch.serving.openai_api import OpenAIServer
    from helix_tpu_torch.serving.registry import ModelRegistry

    name = "tiny-mig"
    geo = dict(max_decode_batch=2, page_size=4, num_pages=128,
               max_pages_per_seq=64, max_prefill_len=16, eos_token_ids=())
    servers = []
    for _ in range(3):
        served = build_served_model(name, device="cpu", seed=3,
                                    warmup=False, engine=geo,
                                    model_overrides={"dtype": "float32"})
        served.tokenizer = _IdTokenizer(served.tokenizer)
        reg = ModelRegistry()
        reg.register(served)
        httpd = OpenAIServer(reg, inter_token_timeout=60).start()
        servers.append((served, reg, httpd,
                        f"http://127.0.0.1:{httpd.server_address[1]}"))
    (sa, _ra, ha, url_a), (sb, _rb, hb, url_b), (sr, _rr, hr, url_r) = \
        servers
    body = {"model": name, "prompt": "migrate me", "max_tokens": 120,
            "temperature": 0}
    try:
        want = json.loads(_post(url_r + "/v1/completions",
                                body).read())["choices"][0]["text"]
        sa.loop.exporter = migration.PeerShipper(
            targets=[{"id": "peer-b", "address": url_b}])
        first = threading.Event()
        got = {}

        def client():
            with _post(url_a + "/v1/completions",
                       {**body, "stream": True}) as r:
                lines = [r.readline().decode()]
                first.set()
                got["raw"] = "".join(lines) + r.read().decode()

        t = threading.Thread(target=client)
        t.start()
        assert first.wait(60)
        sa.loop.stop(drain=0.01)
        t.join(60)
        frames = _frames(got["raw"])
        assert frames[-1] == "[DONE]"
        err = json.loads(frames[-2])["error"]
        assert err["code"] == "migrated"
        assert migration.parse_migrated_peer(err["message"]) == "peer-b"
        rid = err["message"].split()[2]
        seen = "".join(json.loads(f)["choices"][0]["text"]
                       for f in frames[:-2])
        assert 0 < len(seen) < len(want)
        # A is gone for new work: 503
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url_a + "/v1/completions", body)
        assert e.value.code == 503
        # the rest of the stream comes from B, each token once
        with _post(url_b + "/v1/migrate/resume",
                   {"request_id": rid, "emitted_chars": len(seen)}) as r:
            resumed = _frames(r.read().decode())
        assert resumed[-1] == "[DONE]"
        docs = [json.loads(f) for f in resumed[:-1]]
        assert all(d["request_id"] == rid for d in docs)
        assert docs[-1]["finish_reason"] == "length"
        assert seen + "".join(d["delta"] for d in docs) == want
        stats_b = sb.loop.stats()["migration"]
        assert stats_b["imported"] == 1
        assert sa.loop.stats()["migration"]["exported"] == 1
        # resumed once only
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url_b + "/v1/migrate/resume", {"request_id": rid})
        assert e.value.code == 404
        # a corrupt snapshot is refused with its typed code
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url_b + "/v1/migrate/import", {"version": 1})
        assert e.value.code == 422
        assert json.loads(e.value.read())["error"]["code"] == \
            "snapshot_corrupt"
        assert json.loads(_post(url_b + "/v1/completions", body).read())[
            "choices"][0]["text"] == want
    finally:
        for served, reg, httpd, _u in servers:
            httpd.shutdown()
            httpd.server_close()
            served.loop.stop()
            reg.unregister(name)


def test_migrate_endpoints_gate_sweep_and_typed_errors(monkeypatch):
    """``HELIX_RUNNER_TOKEN`` gates both migrate endpoints (403); an
    imported request whose stream nobody claims within the migration
    timeout is aborted and counted; ``kv_exhausted`` and ``migrated``
    engine errors answer 503 with their codes."""
    from helix_tpu_torch.cli import build_served_model, model_config
    from helix_tpu_torch.models.llama import init_params
    from helix_tpu_torch.serving.openai_api import (
        EngineRequestError,
        OpenAIServer,
        _engine_error,
    )
    from helix_tpu_torch.serving.registry import ModelRegistry

    name = "tiny-gate"
    geo = dict(max_decode_batch=2, page_size=4, num_pages=64,
               max_pages_per_seq=32, max_prefill_len=16, eos_token_ids=())
    over = {"dtype": "float32"}
    src = tengine.Engine(model_config(name, over),
                         init_params(model_config(name, over), 3,
                                     device="cpu"),
                         tengine.EngineConfig(**geo), device="cpu")
    req = _req(tengine, tsampling, "g", dict(GREEDY, max_tokens=60))
    src.add_request(req)
    while len(req.output_tokens) < 3:
        src.step()
    wire = migration.snapshot_to_wire(src.export_request("g"))
    served = build_served_model(name, device="cpu", seed=3, warmup=False,
                                engine=geo, model_overrides=over)
    reg = ModelRegistry()
    reg.register(served)
    httpd = OpenAIServer(reg, inter_token_timeout=60).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        monkeypatch.setenv("HELIX_RUNNER_TOKEN", "s3cret")
        for path, body in (("/v1/migrate/import", wire),
                           ("/v1/migrate/resume", {"request_id": "g"})):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + path, body)
            assert e.value.code == 403
        ok = urllib.request.urlopen(urllib.request.Request(
            url + "/v1/migrate/import", data=json.dumps(wire).encode(),
            headers={"Content-Type": "application/json",
                     "X-Runner-Token": "s3cret"}), timeout=60)
        assert json.loads(ok.read())["prior_tokens"] == 3
        # nobody resumes it: past the timeout the next call sweeps it
        monkeypatch.setenv("HELIX_MIGRATION_TIMEOUT", "0")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                url + "/v1/migrate/resume",
                data=json.dumps({"request_id": "g"}).encode(),
                headers={"Content-Type": "application/json",
                         "X-Runner-Token": "s3cret"}), timeout=60)
        assert e.value.code == 404
        assert served.loop.stats()["migration"]["failures"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        served.loop.stop()
        reg.unregister(name)
    for msg, code in (("kv_exhausted: waited", "kv_exhausted"),
                      (migration.migrated_error("r", "p"), "migrated")):
        status, body, headers = _engine_error(EngineRequestError(msg, "r"))
        assert status == 503 and body["error"]["code"] == code
        assert "Retry-After" in headers

"""The persistent KV filestore tier in the port, against the JAX package.

- **The reference's ``TestFilestoreTier``** on the port's engine: a warm
  restart serves the cached prefix bit-identically, a missing blob and a
  corrupt blob recompute (the corrupt one counted and dropped), the
  per-tenant quota rejects typed, the usage ledger survives a restart,
  geometry namespaces do not collide.
- **Byte-equal blobs**: for the same page arrays (float32, int8 with
  scales, bfloat16) ``put`` writes the reference's document byte for
  byte, ``namespace_for`` and the usage ledger are the reference's, and
  the reference reads the port's blob back.
- **Across packages**: blobs a reference engine wrote are restored by the
  port's engine, and the port's by the reference's, each giving the
  writer's tokens.
- **Writes land whole**: a reader that arrives in the middle of a write
  sees a miss, never a short blob (the reference writes in place, so its
  reader counts the blob corrupt and deletes it: ROADMAP C), also under a
  threaded stress; a full writer queue drops with a counter and never
  blocks.
- **The engine's rung**: restored pages re-adopt into the device prefix
  cache, adapter rows write under their seeded digests, and ``put_async``
  waits on the ``ready`` event before it reads.

Every comparison is exact (tokens, bytes, counters).
"""

import glob
import json
import os
import shutil
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu.control import filestore as jfilestore
from helix_tpu.engine import engine as jengine
from helix_tpu.models.common import ModelConfig as JModelConfig
from helix_tpu.models.llama import init_params as jinit
from helix_tpu.serving import kv_filestore as jkvfs
from helix_tpu_torch.control import filestore as tfilestore
from helix_tpu_torch.engine import adapters as tadapters
from helix_tpu_torch.engine import engine as tengine
from helix_tpu_torch.engine.kv_cache import PrefixCache
from helix_tpu_torch.engine.sampling import SamplingParams
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import params_from_jax
from helix_tpu_torch.serving import kv_filestore as tkvfs
from helix_tpu_torch.serving.kv_filestore import (
    KVFilestore,
    filestore_for_engine,
)

VOCAB = 512
GEOMETRY = dict(max_decode_batch=4, page_size=4, num_pages=64,
                max_pages_per_seq=32, max_prefill_len=64)


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


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig.tiny(vocab_size=VOCAB, dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, jp, ModelConfig.tiny(vocab_size=VOCAB, dtype="float32"), tp


def _port(weights, **kw):
    *_, cfg, tp = weights
    return tengine.Engine(cfg, tp, tengine.EngineConfig(**{**GEOMETRY, **kw}),
                          device="cpu")


def _ref(weights, **kw):
    jcfg, jp, _, _ = weights
    return jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **{**GEOMETRY, **kw}, attn_backend="reference"))


def _fs_engine(weights, root, ref=False):
    eng = _ref(weights) if ref else _port(weights)
    mod = jkvfs if ref else tkvfs
    eng.kv_filestore = mod.filestore_for_engine(root, eng.model_cfg,
                                                eng.cache_cfg)
    return eng


def _serve(eng, rid, prompt=None, tenant="tenant-a", ref=False):
    mod = jengine if ref else tengine
    req = mod.Request(
        id=rid, prompt_tokens=list(prompt or range(7, 30)),
        sampling=mod.SamplingParams(temperature=0.0, max_tokens=10),
        tenant=tenant)
    eng.add_request(req)
    while not req.finished:
        eng.step()
    # write-through is asynchronous: land it before reading counters or
    # "restarting" onto the same root
    eng.kv_filestore.flush()
    return list(req.output_tokens), req


def _blobs(root) -> list:
    return sorted(glob.glob(os.path.join(root, KVFilestore.OWNER, "*", "*",
                                         "*.json")))


# ---------------------------------------------------------------------------
# the reference's TestFilestoreTier on the port's engine
# ---------------------------------------------------------------------------


def test_warm_restart_serves_cached_prefix_bit_identically(weights,
                                                           tmp_path):
    root = str(tmp_path)
    cold = _fs_engine(weights, root)
    ref, _ = _serve(cold, "cold")
    assert cold.kv_filestore.stores > 0
    warm = _fs_engine(weights, root)   # a restarted process
    got, req = _serve(warm, "warm")
    assert got == ref
    assert req.cached_tokens > 0
    assert warm.filestore_restored_pages > 0
    assert warm.kv_filestore.hits > 0
    # restored pages re-adopted: the next sharer hits on the device
    hits = warm.kv_filestore.hits
    again, req2 = _serve(warm, "again")
    assert again == ref and req2.cached_tokens == req.cached_tokens
    assert warm.kv_filestore.hits == hits


def test_missing_blob_recomputes(weights, tmp_path):
    root = str(tmp_path)
    cold = _fs_engine(weights, root)
    ref, _ = _serve(cold, "cold")
    shutil.rmtree(os.path.join(root, KVFilestore.OWNER))
    warm = _fs_engine(weights, root)
    got, req = _serve(warm, "warm")
    assert got == ref
    assert req.cached_tokens == 0
    assert warm.kv_filestore.hits == 0


def test_corrupt_blob_dropped_and_recomputed(weights, tmp_path):
    root = str(tmp_path)
    cold = _fs_engine(weights, root)
    ref, _ = _serve(cold, "cold")
    blobs = _blobs(root)
    assert blobs
    with open(blobs[0]) as f:
        doc = json.load(f)
    doc["checksum"] = "00" * 16
    with open(blobs[0], "w") as f:
        f.write(json.dumps(doc))
    warm = _fs_engine(weights, root)
    got, _req = _serve(warm, "warm")
    assert got == ref                       # recompute, never wrong KV
    assert warm.kv_filestore.corrupt >= 1
    digest = os.path.basename(blobs[0])[:-len(".json")]
    if os.path.exists(blobs[0]):
        # dropped, then the recompute stored a good copy
        assert warm.kv_filestore.stores >= 1
        fresh = KVFilestore(root, warm.kv_filestore.namespace)
        assert fresh.get(digest) is not None


def test_tenant_quota_rejects_typed_never_errors(weights, tmp_path):
    eng = _port(weights)
    eng.kv_filestore = KVFilestore(str(tmp_path), "testns", quota_bytes=64)
    got, _ = _serve(eng, "q1", tenant="hog")
    assert got
    assert eng.kv_filestore.quota_rejects > 0
    assert eng.kv_filestore.stores == 0


def _page(fill=0.0, shape=(2, 4, 2, 4)):
    return {"k": np.full(shape, fill, np.float32),
            "v": np.full(shape, fill, np.float32),
            "k_scale": None, "v_scale": None}


def test_quota_ledger_survives_restart(tmp_path):
    a = KVFilestore(str(tmp_path), "ns", quota_bytes=0)
    assert a.put("ab" * 8, _page(), tenant="t1")
    b = KVFilestore(str(tmp_path), "ns", quota_bytes=0)
    assert b.usage("t1") == a.usage("t1") > 0
    assert b.contains("ab" * 8)
    got = b.get("ab" * 8)
    assert got is not None and tuple(got["k"].shape) == (2, 4, 2, 4)


def test_geometry_namespaces_do_not_collide(tmp_path):
    a = KVFilestore(str(tmp_path), "ns-a")
    b = KVFilestore(str(tmp_path), "ns-b")
    a.put("cd" * 8, _page(1.0, (1, 4, 1, 2)), tenant="t")
    assert not b.contains("cd" * 8)


# ---------------------------------------------------------------------------
# byte-equal blobs
# ---------------------------------------------------------------------------


def _pages(kind: str) -> tuple:
    """(numpy page for the reference, torch page for the port)."""
    rng = np.random.default_rng(3)
    shape = (2, 4, 2, 8)
    if kind == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.random(shape[:-1]).astype(np.float32)
        vs = rng.random(shape[:-1]).astype(np.float32)
        ref = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
    else:
        ref = {"k": rng.standard_normal(shape).astype(np.float32),
               "v": rng.standard_normal(shape).astype(np.float32),
               "k_scale": None, "v_scale": None}
    port = {f: None if a is None else torch.from_numpy(a.copy())
            for f, a in ref.items()}
    if kind == "bfloat16":
        import ml_dtypes

        port = {f: None if a is None else a.to(torch.bfloat16)
                for f, a in port.items()}
        ref = {f: None if a is None else
               a.view(np.uint16).reshape(a.shape).view(ml_dtypes.bfloat16)
               for f, a in ((f, None if t is None
                             else t.view(torch.int16).numpy())
                            for f, t in port.items())}
    return ref, port


@pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16"])
def test_blob_is_the_reference_document_byte_for_byte(tmp_path, kind):
    ref_page, port_page = _pages(kind)
    ns = KVFilestore.namespace_for("m", 4, 2, 2, 8, kind)
    assert ns == jkvfs.KVFilestore.namespace_for("m", 4, 2, 2, 8, kind)
    digest = PrefixCache.page_hashes(list(range(8)), 4, 2)[1]
    roots = [str(tmp_path / "ref"), str(tmp_path / "port")]
    assert jkvfs.KVFilestore(roots[0], ns).put(digest, ref_page, "t")
    assert KVFilestore(roots[1], ns).put(digest, port_page, "t")
    rel = os.path.join(KVFilestore.OWNER, ns, digest.hex()[:2],
                       digest.hex() + ".json")
    raw = [open(os.path.join(r, rel), "rb").read() for r in roots]
    assert raw[0] == raw[1]
    ledger = os.path.join(KVFilestore.OWNER, ns, "usage.json")
    assert open(os.path.join(roots[0], ledger), "rb").read() == \
        open(os.path.join(roots[1], ledger), "rb").read()
    # both layouts hold the key file where the reference keeps it
    for r in roots:
        assert os.path.getsize(os.path.join(r, ".signing-secret")) == 32
    # each package reads the other's blob back, verified
    got_ref = jkvfs.KVFilestore(roots[1], ns).get(digest)
    got_port = KVFilestore(roots[0], ns).get(digest)
    for f in ("k", "v", "k_scale", "v_scale"):
        if ref_page[f] is None:
            assert got_ref[f] is None and got_port[f] is None
            continue
        assert np.asarray(got_ref[f]).tobytes() == \
            np.asarray(ref_page[f]).tobytes()
        assert got_port[f].dtype == port_page[f].dtype
        assert torch.equal(got_port[f], port_page[f])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_engines_adopt_each_others_blobs(weights, tmp_path, writer):
    """One package's engine writes through, the other's restores from the
    same directory: the reader's tokens are the writer's, its prompt
    pages come from disk."""
    root = str(tmp_path)
    w = _fs_engine(weights, root, ref=writer == "reference")
    ref, _ = _serve(w, "w", ref=writer == "reference")
    assert w.kv_filestore.stores > 0
    r = _fs_engine(weights, root, ref=writer == "port")
    got, req = _serve(r, "r", ref=writer == "port")
    assert got == ref
    assert req.cached_tokens > 0 and r.filestore_restored_pages > 0
    assert r.kv_filestore.hits == w.kv_filestore.stores
    assert r.kv_filestore.corrupt == 0


# ---------------------------------------------------------------------------
# writes land whole
# ---------------------------------------------------------------------------


class _PausingFile:
    """A file whose ``write`` stops half way to run ``hook`` (a reader
    arriving mid-write), then writes the rest."""

    def __init__(self, f, hook):
        self._f, self._hook = f, hook

    def write(self, data):
        half = len(data) // 2
        self._f.write(data[:half])
        self._f.flush()
        self._hook()
        return half + self._f.write(data[half:])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_a_reader_mid_write_sees_a_miss_not_a_short_blob(tmp_path,
                                                        monkeypatch, pkg):
    """The reference writes the final path in place: a reader arriving in
    the middle reads a short blob, counts it corrupt and deletes it under
    the writer (and the writer's blob is then lost).  The port writes to a
    temporary name and renames: the reader sees a miss, then the whole
    blob."""
    mod, fsmod = ((jkvfs, jfilestore) if pkg == "reference"
                  else (tkvfs, tfilestore))
    root = str(tmp_path)
    writer = mod.KVFilestore(root, "ns")
    reader = mod.KVFilestore(root, "ns")
    seen = []
    blob = "ef" * 8

    def hook():
        seen.append(reader.get(blob))

    real_open = open

    def pausing_open(path, mode="r", *a, **kw):
        f = real_open(path, mode, *a, **kw)
        if "w" in mode and not str(path).endswith("usage.json") \
                and "usage.json.tmp" not in str(path):
            return _PausingFile(f, hook)
        return f

    monkeypatch.setattr(fsmod, "open", pausing_open, raising=False)
    stored = writer.put(blob, _page(2.0, (2, 64, 2, 16)), tenant="t")
    monkeypatch.undo()
    assert len(seen) == 1 and seen[0] is None
    if pkg == "reference":
        # counted corrupt and deleted under the writer, whose own put
        # then fails: the blob is lost
        assert reader.corrupt == 1
        assert not stored and writer.stores == 0
        assert not reader.contains(blob)
    else:
        assert stored
        assert (reader.corrupt, reader.misses) == (0, 1)
        assert reader.get(blob) is not None and reader.hits == 1


def test_concurrent_readers_never_count_a_corrupt_blob(tmp_path):
    """Writer threads store large blobs while reader threads poll the
    same digests (a short switch interval, more threads than cores): no
    reader ever counts a blob corrupt, and every blob lands."""
    root = str(tmp_path)
    digests = [f"{i:032x}" for i in range(24)]
    page = _page(1.5, (4, 64, 2, 16))
    readers = [KVFilestore(root, "ns") for _ in range(6)]
    writers = [KVFilestore(root, "ns") for _ in range(2)]
    stop = threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def read(fs):
        while not stop.is_set():
            for d in digests:
                fs.get(d)
                fs._known.clear()

    def write(fs, part):
        for d in part:
            assert fs.put(d, page, tenant="t")

    try:
        rs = [threading.Thread(target=read, args=(fs,)) for fs in readers]
        ws = [threading.Thread(target=write, args=(fs, digests[i::2]))
              for i, fs in enumerate(writers)]
        for t in rs + ws:
            t.start()
        for t in ws:
            t.join(120)
        stop.set()
        for t in rs:
            t.join(120)
        assert not any(t.is_alive() for t in rs + ws)
    finally:
        sys.setswitchinterval(old)
    assert sum(fs.corrupt for fs in readers) == 0
    assert sum(fs.stores for fs in writers) == len(digests)
    assert all(KVFilestore(root, "ns").get(d) is not None for d in digests)


def test_full_writer_queue_drops_and_never_blocks(tmp_path, monkeypatch):
    fs = KVFilestore(str(tmp_path), "ns")
    gate = threading.Event()
    real_put = fs.put

    def slow_put(*a, **kw):
        gate.wait(60)
        return real_put(*a, **kw)

    monkeypatch.setattr(fs, "put", slow_put)
    extra = 40
    t0 = time.monotonic()
    for i in range(tkvfs.WRITE_QUEUE_DEPTH + 1 + extra):
        fs.put_async(f"{i:032x}", _page(float(i)), tenant="t")
    elapsed = time.monotonic() - t0
    # one entry is with the writer, the queue holds its depth, the rest
    # are dropped without waiting
    deadline = time.monotonic() + 10
    while fs.store_drops < extra and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fs.store_drops in (extra, extra + 1)
    assert elapsed < 5.0
    gate.set()
    fs.flush(60)
    assert fs.stores == tkvfs.WRITE_QUEUE_DEPTH + 1 + extra - fs.store_drops


def test_put_async_waits_for_the_ready_event(tmp_path):
    """The writer reads a queued page only once its ``ready`` event has
    fired (on the card: recorded after the gather)."""
    fs = KVFilestore(str(tmp_path), "ns")
    fired = threading.Event()
    page = {f: torch.full((2, 4, 2, 4), 1.0) if f in ("k", "v") else None
            for f in ("k", "v", "k_scale", "v_scale")}

    class _Ready:
        def synchronize(self):
            fired.wait(60)
            page["k"].fill_(3.0)   # the "gather" lands just before

    fs.put_async("aa" * 16, page, tenant="t", ready=_Ready())
    time.sleep(0.2)
    assert fs.stores == 0
    fired.set()
    fs.flush(30)
    got = fs.get("aa" * 16)
    assert got is not None and float(got["k"][0, 0, 0, 0]) == 3.0


# ---------------------------------------------------------------------------
# the engine's rung
# ---------------------------------------------------------------------------


def test_engine_restore_equals_reference_counters(weights, tmp_path):
    """The same warm restart on both packages' engines: the same pages
    stored, restored and adopted, the same cached tokens."""
    out = []
    for ref in (True, False):
        root = str(tmp_path / ("ref" if ref else "port"))
        cold = _fs_engine(weights, root, ref=ref)
        toks_cold, _ = _serve(cold, "cold", prompt=range(3, 40), ref=ref)
        warm = _fs_engine(weights, root, ref=ref)
        toks, req = _serve(warm, "warm", prompt=range(3, 40), ref=ref)
        assert toks == toks_cold
        out.append((toks, req.cached_tokens, cold.kv_filestore.stores,
                    warm.kv_filestore.hits, warm.filestore_restored_pages,
                    len(_blobs(root))))
    assert out[0] == out[1]


def test_adapter_rows_write_under_seeded_digests(weights, tmp_path):
    """An adapter row's pages are keyed by its weights' seeded digests:
    nothing it writes lands under the base model's digests."""
    *_, cfg, _tp = weights
    eng = _port(weights, adapter_pool_slots=3, adapter_rank=4)
    eng.kv_filestore = filestore_for_engine(str(tmp_path), eng.model_cfg,
                                            eng.cache_cfg)
    rng = np.random.default_rng(5)
    lora = {}
    for t, (fan_in, fan_out) in tadapters.target_dims(cfg).items():
        if t not in eng.cfg.adapter_targets:
            continue
        lora[t] = {"lora_a": rng.standard_normal(
            (cfg.num_layers, fan_in, 4)).astype(np.float32) * 0.1,
                   "lora_b": rng.standard_normal(
            (cfg.num_layers, 4, fan_out)).astype(np.float32) * 0.05}
    eng.publish_adapter("a1", lora, 2.0)
    prompt = list(range(7, 30))
    req = tengine.Request(id="ad", prompt_tokens=prompt, adapter="a1",
                          sampling=SamplingParams(temperature=0.0,
                                                  max_tokens=4))
    eng.add_request(req)
    while not req.finished:
        eng.step()
    eng.kv_filestore.flush()
    base = {h.hex() for h in PrefixCache.page_hashes(
        prompt, 4, (len(prompt) - 1) // 4)}
    stored = {os.path.basename(p)[:-len(".json")] for p in
              _blobs(str(tmp_path))}
    assert stored and not stored & base

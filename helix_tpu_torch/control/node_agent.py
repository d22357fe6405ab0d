"""Node agent: applies serving profiles and heartbeats to the control plane.

The port's counterpart of ``helix_tpu/control/node_agent.py``.  The agent
owns the node's registry.  "Apply" diffs an assigned profile against the
models the node runs: models the new profile drops are torn down (their
device memory freed before anything new is built), models it adds are
built (each entry's ``cli.model_specs`` keyword set through
``cli.build_served_model``: weights on the card, the engine, its loop with
the profile's admission bounds, SLO targets and scheduler), and
models it keeps are left running, loop and all.  A profile with a
``residency`` block is served through the ``ResidencyManager`` (nothing
built until asked for).  The state goes out in the reference's lifecycle
strings (assigning | loading | running | failed).

Every ``heartbeat_interval`` seconds the agent POSTs the reference's
heartbeat body (``heartbeat_payload``: the accelerator inventory, the
profile state, the saturation summary, the tenant rollup, the resident
adapters, exported trace spans, the drain state) to
``{control_plane}/api/v1/runners/{id}/heartbeat`` and polls
``.../assignment``: a new profile name applies that profile (on the
heartbeat thread, as the reference does, so no heartbeat goes out while a
model builds), ``drain: true`` runs the graceful ladder (announce
``draining``, drain every loop for ``HELIX_DRAIN_SECONDS``, ship the
survivors to the peers the control plane names at
``.../migration-targets``) and then calls ``on_drain``.

HTTP goes through ``urllib``.  What the port does not have yet is sent as
the reference sends an idle block: ``multihost`` (ROADMAP A15b) and
``canary`` (A19) are ``{}``.  The ``ctx`` block is the context cache's
``stats_block`` (``serving.context_cache``) on the node's filestore
root.  A ``kind: vision`` entry is a chat engine with its vision tower
beside it; its residency estimate is the reference's, the text tower's
config only (the vision tower's bytes are not counted: ROADMAP C).  A
``kind: embedding`` entry is an
encoder with no engine loop (``cli.build_embedding_model``): it counts in
the registry, the heartbeat's model list and the residency estimate (the
reference's flat 256 MiB), not in the saturation summary.  An entry's
``mesh:`` is realised over the node's devices (``devices``, the visible
cards by default; the reference's ``helix_tpu/control/node_agent.py:
44-65``): a chat entry on more than one device is one engine over its
slice, tensor parallel over ``tp`` and expert parallel over ``ep`` (the
v5e8-mixtral entry's ``{ep: 4, tp: 2}``), an embedding (or any entry of one device) is committed
to its slice's first device, and a slice past the visible devices fails
the apply with the reference's text.  A profile the port cannot serve
(an adapter merged at apply, a mesh axis or option of a later A15b
part, unported engine fields) fails the apply with the refusal's text
before anything is built.  The profile's pool role
(``prefill | decode | mixed``, ``HELIX_POOL_ROLE`` beating it) is
heartbeated as ``role``; a prefill node hands each marked stream to a
decode node (``serving.openai_api``), and ``HELIX_FILESTORE_KV_DIR`` arms
each engine's persistent KV tier at build (``cli.build_served_model``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
import traceback
import urllib.error
import urllib.request
from typing import Callable, Optional

from helix_tpu_torch import cli
from helix_tpu_torch.control.profile import (
    MeshSpec,
    ServingProfile,
    pool_role,
)
from helix_tpu_torch.device import (
    DEFAULT_DEVICE,
    detect_accelerators,
    total_device_bytes,
)
from helix_tpu_torch.device.mesh import build_mesh, visible_devices
from helix_tpu_torch.engine.adapters import adapter_residency_summary
from helix_tpu_torch.engine.residency import (
    ResidencyManager,
    release_served_model,
)
from helix_tpu_torch.obs import trace as obs_trace
from helix_tpu_torch.obs.flight import SATURATION_KEYS
from helix_tpu_torch.obs.slo import merge_rollups, tenant_top_k_from_env
from helix_tpu_torch.serving.context_cache import context_cache_for
from helix_tpu_torch.serving.kv_filestore import kv_filestore_dir
from helix_tpu_torch.serving.migration import (
    PeerShipper,
    drain_seconds,
    http_post,
)
from helix_tpu_torch.serving.registry import (
    DelegatingRegistry,
    ModelRegistry,
    ServedModel,
)
from helix_tpu_torch.testing import faults

log = logging.getLogger("helix_tpu_torch.node_agent")


@dataclasses.dataclass
class ApplyState:
    status: str = "assigning"       # assigning|loading|starting|running|failed
    profile_name: str = ""
    models: list = dataclasses.field(default_factory=list)
    error: str = ""
    progress: dict = dataclasses.field(default_factory=dict)  # model -> phase

    def to_dict(self):
        return dataclasses.asdict(self)


def _get_json(url: str, headers: dict, timeout: float = 10.0) -> tuple:
    """(status, parsed body) of a GET; any HTTP status is a response."""
    req = urllib.request.Request(url, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, {}


class NodeAgent:
    """Owns the registry, the apply path and the heartbeat loop of one
    node.  A profile entry is realised from its ``cli.model_specs``
    keyword set (``engine``: fields that beat every entry's;
    ``random_weights``: a ``checkpoint`` drawn from ``seed`` instead) by
    ``build_model(device=, seed=, warmup=, **spec)``, which takes
    ``cli.build_served_model``'s keywords and is that by default (an
    entry's ``mesh`` arrives realised over ``devices``, as a
    ``device.mesh.Mesh``)."""

    def __init__(
        self,
        runner_id: str,
        registry: Optional[ModelRegistry] = None,
        build_model: Optional[Callable] = None,
        heartbeat_url: Optional[str] = None,
        heartbeat_interval: float = 30.0,
        address: str = "",
        runner_token: Optional[str] = None,
        *,
        device=DEFAULT_DEVICE,
        seed: int = 0,
        warmup: bool = True,
        random_weights: bool = False,
        engine: Optional[dict] = None,
        devices: Optional[list] = None,
    ):
        self.runner_id = runner_id
        # where the control plane reaches this node's OpenAI surface
        self.address = address
        self.registry = DelegatingRegistry(registry)
        self.state = ApplyState()
        # the exception of the last failed apply (serve-node raises it)
        self.apply_exception: Optional[BaseException] = None
        self.device = device
        # the devices a profile's ``mesh:`` slices are cut from
        self.devices = (list(devices) if devices is not None
                        else visible_devices(device))
        self.seed = seed
        self.random_weights = random_weights
        self.warmup = warmup
        self.engine_overrides = dict(engine or {})
        self._build_model = build_model or cli.build_served_model
        self.heartbeat_url = heartbeat_url
        self.heartbeat_interval = heartbeat_interval
        self.runner_token = (
            runner_token if runner_token is not None
            else os.environ.get("HELIX_RUNNER_TOKEN", "")
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        # once draining, the heartbeat says so and the control plane
        # routes no new work here; the deadline feeds its Retry-After
        self.draining = False
        self.drain_deadline_ts = 0.0
        # the applied profile's pool role; HELIX_POOL_ROLE beats it
        self.profile_role = "mixed"
        self._drain_stats: dict = {}
        self._drain_thread: Optional[threading.Thread] = None
        # called after a control-plane-requested drain has finished
        # (serve-node: the process sends itself SIGTERM and exits 0)
        self.on_drain: Optional[Callable[[], None]] = None
        # trace federation: completed spans ride out on each heartbeat
        self.trace_store = obs_trace.default_store()
        if obs_trace.federation_enabled():
            self.trace_store.enable_export()

    # ------------------------------------------------------------------
    def _build(self, spec: dict) -> ServedModel:
        """One ``cli.model_specs`` keyword set built on this node."""
        t0 = time.monotonic()
        if "mesh" in spec:
            spec = {**spec, "mesh": build_mesh(
                MeshSpec.from_dict(spec["mesh"]), self.devices)}
        served = self._build_model(device=self.device, seed=self.seed,
                                   warmup=self.warmup, **spec)
        log.info("runner %s: model %s built in %.1fs (profile %s)",
                 self.runner_id, spec["name"], time.monotonic() - t0,
                 self.state.profile_name)
        return served

    def _release(self, name: str) -> None:
        """Unregister ``name`` from the plain registry and free its
        device memory before returning (its loop stopped and joined, its
        tensors dropped)."""
        served = self.registry.inner.get(name)
        self.registry.unregister(name)
        if served is not None:
            release_served_model(served)

    def _teardown_all(self):
        inner = self.registry.inner
        if hasattr(inner, "resident_names"):
            for name in inner.resident_names():
                inner.evict(name)
        else:
            for name in list(inner.names()):
                self._release(name)

    def apply_profile(self, profile: Optional[ServingProfile]) -> ApplyState:
        """Diff-apply: never tears down a model the new profile keeps.
        A profile with a ``residency`` block swaps the backing store to
        the memory-accounted ``ResidencyManager`` (lazy load, LRU
        eviction of idle models)."""
        with self._lock:
            self.apply_exception = None
            if profile is None:
                self._teardown_all()
                self.registry.inner = ModelRegistry()
                self.state = ApplyState(status="running", profile_name="")
                self.profile_role = "mixed"
                return self.state
            self.profile_role = getattr(profile, "role", "mixed")
            errors = profile.validate()
            if errors:
                self.state = ApplyState(
                    status="failed", profile_name=profile.name,
                    error="; ".join(errors),
                )
                return self.state
            self.state = ApplyState(status="loading",
                                    profile_name=profile.name)
            try:
                # every entry is checked before anything is built
                specs = {spec["name"]: spec for spec in cli.model_specs(
                    profile, self.engine_overrides, self.random_weights,
                    self.seed)}
                if profile.residency:
                    self._apply_residency(profile, specs)
                else:
                    if hasattr(self.registry.inner, "resident_names"):
                        self._teardown_all()
                        self.registry.inner = ModelRegistry()
                    for name in list(self.registry.names()):
                        if name not in specs:
                            self._release(name)
                    for name in specs:
                        if self.registry.get(name) is None:
                            self.state.progress[name] = "loading"
                            self.registry.register(self._build(specs[name]))
                            self.state.progress[name] = "ready"
                self.state.status = "running"
                # the build is over: drop the step-duration samples the
                # flight recorders of kept loops banked while it ran
                for served in self._live_models():
                    flight = getattr(getattr(served, "loop", None),
                                     "flight", None)
                    if flight is not None:
                        flight.reset_baseline()
                # (the reference keeps multi-host followers out of this
                # list; the port refuses a multihost entry, A15b)
                self.state.models = sorted(specs)
            except Exception as e:  # noqa: BLE001 — reported via status
                self.apply_exception = e
                self.state.status = "failed"
                self.state.error = f"{e}\n{traceback.format_exc(limit=5)}"
                log.warning("runner %s: profile %s apply failed: %s",
                            self.runner_id, profile.name, e)
            return self.state

    def _apply_residency(self, profile: ServingProfile,
                         specs: dict) -> None:
        """Every entry registered with a ``ResidencyManager`` and none
        built: its budget is ``hbm_budget_bytes`` or the card's memory,
        its estimate ``cli.spec_bytes`` of the entry."""
        budget = int(profile.residency.get("hbm_budget_bytes")
                     or total_device_bytes(self.device))
        self._teardown_all()
        mgr = ResidencyManager(
            budget, lambda name: self._build(specs[name]),
            estimate=lambda name: cli.spec_bytes(specs[name]))
        for name in specs:
            mgr.register_name(name)
        self.registry.inner = mgr
        for name in specs:
            self.state.progress[name] = "lazy"

    # ------------------------------------------------------------------
    def _live_models(self) -> list:
        """Already-resident ServedModels, without building or blocking:
        a ``ResidencyManager``'s ``get`` builds and its ``list`` waits on
        the lock held across builds, so its resident dict is copied
        lock-free; a racing mutation yields [] for this pass."""
        try:
            inner = getattr(self.registry, "inner", self.registry)
            if hasattr(inner, "_resident"):
                return [r.model for r in list(inner._resident.values())]
            return self.registry.list()
        except Exception:  # noqa: BLE001 — callers must never die
            return []

    def saturation_summary(self) -> dict:
        """The node's saturation rollup, exactly ``SATURATION_KEYS``:
        slots and queue sum over engines, KV occupancy and the prefix
        hit rate pool across them, tokens/s sums their goodput."""
        slots_busy = slots_total = queue_depth = 0
        kv_used = kv_cap = 0
        hits = misses = 0
        drafted = accepted = 0
        host_used = host_budget = 0
        preempted = 0
        prefill_budget = 0
        adapters_resident = 0
        kv_cold_pages = 0
        tps = 0.0
        for m in self._live_models():
            loop = getattr(m, "loop", None)
            if loop is None or not hasattr(loop, "saturation"):
                continue
            sat = loop.saturation()
            slots_busy += sat["slots_busy"]
            slots_total += sat["slots_total"]
            queue_depth += sat["queue_depth"]
            prefill_budget += sat.get("prefill_budget_tokens", 0)
            tps += sat["tokens_per_sec"]
            eng = loop.engine
            kv_used += getattr(eng, "kv_pages_used", 0)
            kv_cap += getattr(eng, "kv_pages_capacity", 0)
            pc = getattr(eng, "prefix_cache", None)
            if pc is not None:
                hits += pc.hits
                misses += pc.misses
            drafted += getattr(eng, "num_spec_drafted_tokens", 0)
            accepted += getattr(eng, "num_spec_accepted_tokens", 0)
            hp = getattr(eng, "host_pool", None)
            if hp is not None:
                host_used += hp.used_bytes
                host_budget += hp.budget_bytes
            preempted += len(getattr(eng, "preempted", ()))
            adapters_resident += sat.get("adapters_resident", 0)
            kv_cold_pages += sat.get("kv_cold_pages", 0)
        out = {
            "kv_occupancy": round(kv_used / kv_cap, 4) if kv_cap else 0.0,
            "slots_busy": slots_busy,
            "slots_total": slots_total,
            # no canary probe rides the queues (A19): nothing to subtract
            "queue_depth": queue_depth,
            "tokens_per_sec": round(tps, 2),
            "prefix_hit_rate": (
                round(hits / (hits + misses), 4) if hits + misses else 0.0
            ),
            "spec_acceptance_ratio": (
                round(accepted / drafted, 4) if drafted else 0.0
            ),
            "kv_host_occupancy": (
                round(host_used / host_budget, 4) if host_budget else 0.0
            ),
            "preempted_requests": preempted,
            "prefill_budget_tokens": prefill_budget,
            "adapters_resident": adapters_resident,
            "kv_cold_pages": kv_cold_pages,
        }
        # a "saturation" fault rule sets reported keys (schema-filtered)
        inj = faults.active()
        if inj is not None:
            over = inj.saturation_override(self.runner_id)
            if over:
                out.update({k: v for k, v in over.items()
                            if k in SATURATION_KEYS})
        return {k: out[k] for k in SATURATION_KEYS}

    def tenant_summary(self) -> dict:
        """Each live engine's bounded tenant rollup merged across
        engines and bounded again (``merge_rollups``); {} while no
        engine has seen a tenant."""
        rollups = []
        for m in self._live_models():
            slo = getattr(getattr(m, "loop", None), "slo", None)
            if slo is None:
                continue
            try:
                rollups.append(slo.rollup())
            except Exception:  # noqa: BLE001 — heartbeat must never die
                continue
        if not any(r.get("top") for r in rollups):
            return {}
        return merge_rollups(rollups, top_k=tenant_top_k_from_env())

    def adapter_summary(self) -> list:
        """Bounded, sorted ``model@adapter`` ids resident on the node."""
        try:
            return adapter_residency_summary(self._live_models())
        except Exception:  # noqa: BLE001 — heartbeat must never die
            return []

    def trace_summary(self) -> dict:
        """Up to ``HELIX_TRACE_EXPORT_BATCH`` completed wire spans from
        the export ring; {} when federation is off or nothing waits."""
        try:
            if not obs_trace.federation_enabled():
                return {}
            spans = self.trace_store.drain_export()
            return {"spans": spans} if spans else {}
        except Exception:  # noqa: BLE001 — heartbeat must never die
            return {}

    def ctx_summary(self) -> dict:
        """The heartbeat's context-cache block: handle and token counts
        and the create / hit / miss / quota counters of the registry the
        HTTP surface serves (the per-root instance of
        ``context_cache_for``); {} while it is empty and idle."""
        try:
            return context_cache_for(kv_filestore_dir()).stats_block()
        except Exception:  # noqa: BLE001 — heartbeat must never die
            return {}

    def pool_role(self) -> str:
        """HELIX_POOL_ROLE beats the applied profile's ``role``."""
        return pool_role(self.profile_role)

    def heartbeat_payload(self) -> dict:
        """The reference's heartbeat body, key for key."""
        disk = shutil.disk_usage("/")
        return {
            "runner_id": self.runner_id,
            "address": self.address,
            "instance_id": os.environ.get("HELIX_INSTANCE_ID", ""),
            "accelerators": [a.to_dict()
                             for a in detect_accelerators(self.device)],
            "profile": {
                "name": self.state.profile_name,
                "status": self.state.status,
                "models": self.registry.names(),
                "error": self.state.error,
                "progress": self.state.progress,
            },
            "saturation": self.saturation_summary(),
            "tenants": self.tenant_summary(),
            "adapters": self.adapter_summary(),
            # multi-host serving (A15b) and canaries (A19) are not ported:
            # each block is the reference's idle block
            "multihost": {},
            "role": self.pool_role(),
            "traces": self.trace_summary(),
            "canary": {},
            "ctx": self.ctx_summary(),
            "draining": self.draining,
            "drain_deadline_ts": self.drain_deadline_ts,
            "disk": {"total": disk.total, "used": disk.used,
                     "free": disk.free},
            "ts": time.time(),
        }

    def _heartbeat_headers(self) -> dict:
        return ({"X-Runner-Token": self.runner_token}
                if self.runner_token else {})

    def _post_heartbeat(self):
        """One heartbeat POST; returns the response (``status_code``,
        ``body``) or raises."""
        return http_post(
            f"{self.heartbeat_url}/api/v1/runners/{self.runner_id}/"
            "heartbeat", json=self.heartbeat_payload(), timeout=10,
            headers=self._heartbeat_headers())

    def graceful_shutdown(self, drain: Optional[float] = None) -> dict:
        """The SIGTERM path: announce ``draining`` to the control plane
        now, let every engine loop drain in parallel for up to ``drain``
        seconds, and ship whatever is unfinished at the deadline to a
        peer runner as request snapshots.  Returns per-model migration
        stats."""
        if self.draining:
            # already draining (a SIGTERM during a requested drain):
            # wait for it rather than drain stopped loops again
            t = self._drain_thread
            if (t is not None and t is not threading.current_thread()
                    and t.is_alive()):
                t.join(timeout=120.0)
            return dict(self._drain_stats)
        if drain is None:
            drain = drain_seconds()
        self.draining = True
        self.drain_deadline_ts = time.time() + drain
        if self.heartbeat_url:
            try:
                self._post_heartbeat()
            except Exception:  # noqa: BLE001 — drain proceeds regardless
                log.warning("runner %s: could not announce drain to the "
                            "control plane", self.runner_id)
        shipper = None
        if self.heartbeat_url:
            shipper = PeerShipper(self.heartbeat_url, self.runner_id,
                                  runner_token=self.runner_token)
        loops = [(m.name, m.loop) for m in self._live_models()
                 if getattr(m, "loop", None) is not None]
        # every loop drains at once; each engine thread exports its own
        # survivors at the deadline
        for _name, loop in loops:
            if shipper is not None:
                loop.exporter = shipper
            loop.stop(drain=drain, join=False)
        deadline = time.monotonic() + drain + 30.0
        stats = {}
        for name, loop in loops:
            t = getattr(loop, "_thread", None)
            if t is not None and t.is_alive():
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            loop.stop(join=True)
            st = loop.stats().get("migration", {})
            stats[name] = st
            log.info("runner %s: model %s drained (exported=%s "
                     "failures=%s)", self.runner_id, name,
                     st.get("exported"), st.get("failures"))
        self.stop()
        self._drain_stats = stats
        return stats

    def _drain_async(self) -> None:
        """A drain the control plane asked for (the assignment poll said
        ``drain: true``): the graceful ladder off the heartbeat thread,
        then ``on_drain``."""
        if self.draining or self._drain_thread is not None:
            return
        log.info("runner %s: control plane requested drain — starting "
                 "the graceful ladder", self.runner_id)

        def run():
            try:
                self.graceful_shutdown()
            finally:
                cb = self.on_drain
                if cb is not None:
                    try:
                        cb()
                    except Exception:  # noqa: BLE001 — exit is best-effort
                        pass

        self._drain_thread = threading.Thread(target=run, name="helix-drain",
                                              daemon=True)
        self._drain_thread.start()

    def start_heartbeat(self, poll_assignment: bool = True):
        """Heartbeat and assignment poll every ``heartbeat_interval``
        seconds.  A new profile name applies that profile on this
        thread; ``drain: true`` starts the drain."""
        headers = self._heartbeat_headers()

        def run():
            while not self._stop.is_set():
                try:
                    r = self._post_heartbeat()
                    if r.status_code != 200:
                        log.warning("heartbeat rejected (%s): %s — check "
                                    "HELIX_RUNNER_TOKEN", r.status_code,
                                    r.body[:200])
                    if poll_assignment:
                        status, doc = _get_json(
                            f"{self.heartbeat_url}/api/v1/runners/"
                            f"{self.runner_id}/assignment", headers)
                        if status == 200:
                            if doc.get("drain"):
                                # a leaving node churns no profile
                                self._drain_async()
                            else:
                                prof = (ServingProfile.from_dict(
                                    doc["profile"])
                                    if doc.get("profile") else None)
                                name = prof.name if prof else ""
                                if name != self.state.profile_name:
                                    self.apply_profile(prof)
                except Exception:  # noqa: BLE001 — keep beating
                    pass
                self._stop.wait(self.heartbeat_interval)

        self._hb_thread = threading.Thread(target=run,
                                           name="helix-heartbeat",
                                           daemon=True)
        self._hb_thread.start()

    def stop(self):
        self._stop.set()
        for name in list(self.registry.names()):
            self.registry.unregister(name)

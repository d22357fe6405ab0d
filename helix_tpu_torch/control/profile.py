"""Serving profiles: which models a node serves, and on what.

The port's copy of ``helix_tpu/control/profile.py`` (the dataclasses,
their dict and YAML forms, ``validate`` and ``check_compatibility``), with
its own copy of the reference's ``MeshSpec`` dataclass and none of its
mesh building.  A profile read here gives the reference's ``to_dict()``,
``validate()`` and violations for the same document, so a control plane
stores, assigns and checks profiles for a torch runner as it does for a
JAX one.

Schema (YAML or JSON):

    name: v5e1-hotswap
    requirement: {chips: 1, vendor: nvidia}   # vendor defaults to "tpu"
    residency: {hbm_budget_bytes: 15032385536}
    models:
      - name: meta-llama/Meta-Llama-3-8B-Instruct
        quantization: int8
        engine: {kv_cache_dtype: int8, max_decode_batch: 16}
        slo: {ttft_p95_seconds: 2.0, sched: {policy: wfq}}

``check_compatibility`` compares the requirement with a heartbeat's
accelerator inventory (``device.detect_accelerators``): enough devices of
the vendor, the architecture (``generation``: "h100" on the card, "v5e"
on a TPU) and the least device memory.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named-axis layout over a number of devices (the reference's
    ``helix_tpu/device/mesh.py`` dataclass; ``device.mesh.build_mesh``
    realises it).  The port serves ``tp`` and ``device_offset``; any
    other axis above 1 is refused at build (ROADMAP A15b's later
    parts)."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    device_offset: int = 0

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.pp * self.ep * self.sp * self.tp

    def axis_sizes(self) -> dict:
        return {"dp": self.dp, "fsdp": self.fsdp, "pp": self.pp,
                "ep": self.ep, "sp": self.sp, "tp": self.tp}

    @classmethod
    def from_dict(cls, d: dict) -> "MeshSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in known})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ProfileModel:
    name: str
    checkpoint: Optional[str] = None     # HF safetensors dir; None = random
    kind: str = "chat"     # chat | embedding | vision | vision-embedding
    quantization: Optional[str] = None   # None | "int8"
    # a LoRA training checkpoint merged into the weights at apply time
    # (refused by the port: ROADMAP A18)
    adapter: Optional[str] = None
    adapter_scale: Optional[float] = None
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    engine: dict = dataclasses.field(default_factory=dict)
    context_length: Optional[int] = None
    # architecture overrides for random-init models
    model_overrides: dict = dataclasses.field(default_factory=dict)
    # multi-host lockstep serving: {} = single host (A15b)
    multihost: dict = dataclasses.field(default_factory=dict)
    # SLO targets and the scheduler's ``sched`` block (obs/slo.py,
    # serving/sched.py)
    slo: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "ProfileModel":
        mh = dict(d.get("multihost", {}))
        if mh and mh.get("role") not in ("leader", "follower"):
            raise ValueError(
                "multihost.role must be 'leader' or 'follower'"
            )
        if mh.get("role") == "follower" and not mh.get("leader_url"):
            raise ValueError("multihost followers need leader_url")
        if "standby" in mh:
            if mh.get("role") != "follower":
                raise ValueError(
                    "multihost.standby is only valid on followers"
                )
            v = mh["standby"]
            if isinstance(v, str):
                v = v.strip().lower() in ("1", "true", "yes", "on")
            mh["standby"] = bool(v)
        return cls(
            name=d["name"],
            checkpoint=d.get("checkpoint"),
            kind=d.get("kind", "chat"),
            quantization=d.get("quantization"),
            adapter=d.get("adapter"),
            adapter_scale=(
                float(d["adapter_scale"])
                if d.get("adapter_scale") is not None
                else None
            ),
            mesh=MeshSpec.from_dict(d.get("mesh", {})),
            engine=dict(d.get("engine", {})),
            context_length=d.get("context_length"),
            model_overrides=dict(d.get("model_overrides", {})),
            multihost=mh,
            slo=dict(d.get("slo", {})),
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "checkpoint": self.checkpoint,
            "kind": self.kind,
            "quantization": self.quantization,
            "adapter": self.adapter,
            "adapter_scale": self.adapter_scale,
            "mesh": self.mesh.to_dict(),
            "engine": dict(self.engine),
            "context_length": self.context_length,
            "model_overrides": dict(self.model_overrides),
            "multihost": dict(self.multihost),
            "slo": dict(self.slo),
        }


@dataclasses.dataclass(frozen=True)
class ProfileRequirement:
    chips: int = 1
    generation: str = ""          # "" = any; "h100", "v5e", ...
    min_hbm_bytes: int = 0
    vendor: str = "tpu"

    @classmethod
    def from_dict(cls, d: dict) -> "ProfileRequirement":
        return cls(
            chips=int(d.get("chips", 1)),
            generation=d.get("generation", ""),
            min_hbm_bytes=int(d.get("min_hbm_bytes", 0)),
            vendor=d.get("vendor", "tpu"),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


POOL_ROLES = ("prefill", "decode", "mixed")


def pool_role(profile_role: str = "mixed") -> str:
    """The node's disaggregated pool role: ``HELIX_POOL_ROLE`` beats the
    profile's ``role``."""
    env = os.environ.get("HELIX_POOL_ROLE", "").strip().lower()
    if env in POOL_ROLES:
        return env
    return profile_role or "mixed"


@dataclasses.dataclass(frozen=True)
class ServingProfile:
    name: str
    models: tuple
    requirement: ProfileRequirement = ProfileRequirement()
    # hot-swap group: {"hbm_budget_bytes": N} serves the models through
    # the memory-accounted ResidencyManager (load on demand, evict idle)
    residency: Optional[dict] = None
    # disaggregated pool role: prefill | decode | mixed; HELIX_POOL_ROLE
    # on the node beats it
    role: str = "mixed"

    @classmethod
    def from_yaml(cls, text: str) -> "ServingProfile":
        import yaml

        return cls.from_dict(yaml.safe_load(text))

    @classmethod
    def from_dict(cls, d: dict) -> "ServingProfile":
        role = str(d.get("role", "mixed") or "mixed").strip().lower()
        if role not in POOL_ROLES:
            raise ValueError(
                f"profile role must be prefill|decode|mixed, got {role!r}"
            )
        return cls(
            name=d["name"],
            models=tuple(ProfileModel.from_dict(m)
                         for m in d.get("models", [])),
            requirement=ProfileRequirement.from_dict(
                d.get("requirement", {})),
            residency=d.get("residency"),
            role=role,
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "requirement": self.requirement.to_dict(),
            "models": [m.to_dict() for m in self.models],
            **({"residency": self.residency} if self.residency else {}),
            **({"role": self.role} if self.role != "mixed" else {}),
        }

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @property
    def model_names(self) -> list:
        return [m.name for m in self.models]

    def validate(self) -> list:
        """Static sanity: each model's device claim within the chip
        count, model names unique and non-empty."""
        errors = []
        seen = set()
        for m in self.models:
            lo = m.mesh.device_offset
            hi = lo + m.mesh.num_devices
            if hi > self.requirement.chips:
                errors.append(
                    f"model {m.name} claims devices [{lo},{hi}) but profile "
                    f"requires only {self.requirement.chips} chips"
                )
            if not m.name or m.name in seen:
                errors.append(f"duplicate or empty model name {m.name!r}")
            seen.add(m.name)
        return errors


@dataclasses.dataclass
class Violation:
    constraint: str
    want: str
    have: str

    def to_dict(self):
        return dataclasses.asdict(self)


def check_compatibility(profile: ServingProfile, inventory: list) -> list:
    """The profile's requirement against a heartbeat's accelerator
    inventory (``AcceleratorStatus`` records or their dicts): [] when it
    fits, else one ``Violation`` per failed constraint (count of the
    vendor's devices, architecture, least device memory)."""

    def field(a, name):
        return getattr(a, name, None) if not isinstance(a, dict) \
            else a.get(name)

    req = profile.requirement
    violations = []
    devices = [a for a in inventory if field(a, "vendor") == req.vendor]
    if len(devices) < req.chips:
        violations.append(
            Violation("chips", f">={req.chips} {req.vendor}",
                      str(len(devices)))
        )
    if req.generation:
        archs = {field(a, "arch") for a in devices}
        if archs and archs != {req.generation}:
            violations.append(
                Violation("generation", req.generation,
                          ",".join(sorted(archs)))
            )
    if req.min_hbm_bytes:
        have = min((field(a, "total_memory_bytes") or 0 for a in devices),
                   default=0)
        if have < req.min_hbm_bytes:
            violations.append(
                Violation("min_hbm_bytes", str(req.min_hbm_bytes), str(have))
            )
    return violations

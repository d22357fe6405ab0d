"""Device meshes for tensor- and expert-parallel serving on one host.

Port of ``helix_tpu/device/mesh.py``.  A ``MeshSpec`` (the profile's
``mesh:`` block, ``control.profile.MeshSpec``, re-exported here) names a
device count per logical axis and an offset into the node's devices;
``build_mesh`` realises it over a contiguous slice of a device list.

The reference builds a ``jax.sharding.Mesh`` and lets XLA place every
array and insert the collectives.  Here a ``Mesh`` is the slice itself:
its ``torch.device`` list in the reference's axis order (``tp``
innermost), which ``parallel.sharding`` shards parameters and the KV pool
over and ``parallel.collectives`` sums across.  ``Mesh.coords`` gives a
shard's coordinate on each axis, ``Mesh.groups`` the shards a sum joins
(each ep replica's tp group, or the whole mesh).  One process drives every
device of the mesh, as the reference's single controller does.

By default the devices are the visible cards (``cuda:0 .. n-1``).  A
caller may pass an explicit list, as the reference's ``build_mesh(spec,
devices)`` allows: tests pass CPU devices, and a list may name one card
several times (each entry is then one shard on that card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from helix_tpu_torch.control.profile import MeshSpec

AXIS_ORDER = ("dp", "fsdp", "pp", "ep", "sp", "tp")

__all__ = ["AXIS_ORDER", "Mesh", "MeshSpec", "build_mesh",
           "default_mesh_spec", "slice_devices", "visible_devices"]


def visible_devices(kind="cuda") -> list:
    """The devices a process sees: every CUDA card, or the one CPU."""
    if torch.device(kind).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def slice_devices(spec: MeshSpec, devices: Optional[Sequence] = None) -> list:
    """Pick the contiguous device slice this spec claims."""
    if devices is None:
        devices = visible_devices()
    lo, hi = spec.device_offset, spec.device_offset + spec.num_devices
    if hi > len(devices):
        raise ValueError(
            f"MeshSpec wants devices [{lo}, {hi}) but only "
            f"{len(devices)} devices are visible"
        )
    return [torch.device(d) for d in list(devices)[lo:hi]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A realised ``MeshSpec``: ``devices`` is the claimed slice in
    ``AXIS_ORDER`` (row-major, ``tp`` innermost), ``device_ids`` the
    positions of those devices in the list the slice was cut from."""

    spec: MeshSpec
    devices: tuple
    device_ids: tuple

    @property
    def shape(self) -> dict:
        """Axis sizes by name (the reference's ``Mesh.shape``)."""
        return {a: self.spec.axis_sizes()[a] for a in AXIS_ORDER}

    @property
    def axis_names(self) -> tuple:
        return AXIS_ORDER

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, index: int) -> dict:
        """Shard ``index``'s coordinate on every axis (row-major over
        ``AXIS_ORDER``, ``tp`` innermost)."""
        out = {}
        for a in reversed(AXIS_ORDER):
            n = self.shape[a]
            out[a] = index % n
            index //= n
        return out

    def groups(self, axes: Sequence[str]) -> list:
        """The shards that a sum over ``axes`` joins: one list of shard
        indices per group (those differing only along ``axes``), each in
        shard order, the groups ordered by their first shard.
        ``("tp",)`` gives each ep replica's tp group, ``AXIS_ORDER`` the
        whole mesh."""
        out: dict = {}
        for i in range(self.size):
            c = self.coords(i)
            key = tuple(c[a] for a in AXIS_ORDER if a not in axes)
            out.setdefault(key, []).append(i)
        return list(out.values())


def build_mesh(spec: MeshSpec, devices: Optional[Sequence] = None) -> Mesh:
    """Realise a MeshSpec over its slice of ``devices`` (the visible
    cards by default)."""
    devs = slice_devices(spec, devices)
    lo = spec.device_offset
    return Mesh(spec=spec, devices=tuple(devs),
                device_ids=tuple(range(lo, lo + len(devs))))


def default_mesh_spec(num_devices: Optional[int] = None,
                      max_tp: int = 8) -> MeshSpec:
    """Heuristic single-model layout: as much TP as divides the device
    count (capped), the remainder into dp."""
    if num_devices is None:
        num_devices = len(visible_devices())
    tp = math.gcd(num_devices, max_tp)
    return MeshSpec(tp=tp, dp=num_devices // tp)

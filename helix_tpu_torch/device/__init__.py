"""Device selection shared by every entry point of the port.

Entry points (``Engine``, ``init_params``, the server, ``serve-node``) take
an explicit ``device`` that defaults to ``"cuda"``.  Asking for the card on
a machine without one is an error: nothing falls back to the CPU unless the
caller asked for the CPU.

``upload`` and ``Fetch`` move small host arrays to the device and device
results to the host without a synchronising call, so the engine can queue
a step's work and read its results later (the async loop's split of a
step into dispatch and completion).

``device.mesh`` realises a profile's ``mesh:`` block over the node's
devices (tensor parallel on one host).
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Optional

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def total_device_bytes(device=DEFAULT_DEVICE) -> int:
    """The card's memory in bytes (``torch.cuda.mem_get_info``): the
    residency budget when a profile names none (the reference's
    ``total_hbm_bytes``)."""
    return int(torch.cuda.mem_get_info(resolve_device(device))[1])


@dataclasses.dataclass(frozen=True)
class AcceleratorStatus:
    """Per-device status record of the heartbeat's ``accelerators`` list:
    the reference's fields and ``to_dict()`` (``helix_tpu/device/
    detect.py``), so the control plane's ``check_compatibility`` reads a
    card's record as it reads a TPU chip's."""

    index: int
    vendor: str                  # "nvidia" | "cpu"
    arch: str                    # "h100" | ... | "cpu"
    device_kind: str             # torch.cuda.get_device_name
    total_memory_bytes: int
    used_memory_bytes: int
    free_memory_bytes: int
    core_on_chip: int = 1
    process_index: int = 0
    coords: Optional[tuple] = None
    driver: str = ""             # CUDA version of the torch build

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["coords"] = list(self.coords) if self.coords is not None else None
        return d


# substrings of the device name -> canonical architecture, as the
# reference's ``tpu_generation`` maps a device kind to "v5e"
_GPU_ARCHS = ("h200", "h100", "h800", "gh200", "a100", "a800", "l40s", "l40",
              "l4", "b200", "b100")


def gpu_arch(device_name: str) -> str:
    name = device_name.lower()
    for needle in _GPU_ARCHS:
        if needle in name:
            return needle
    return "unknown"


def detect_accelerators(device=DEFAULT_DEVICE) -> list:
    """The node's accelerator inventory.  On the card: one record per
    visible CUDA device, ``vendor`` ``nvidia``, ``arch`` from the name,
    total / used / free bytes from ``torch.cuda.mem_get_info`` (used is
    the card's whole use, other processes included) and the CUDA version
    as ``driver``.  With ``device="cpu"`` the reference's record of the
    CPU backend: one device, vendor and arch ``cpu``, no memory figure."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [AcceleratorStatus(
            index=0, vendor="cpu", arch="cpu", device_kind="cpu",
            total_memory_bytes=0, used_memory_bytes=0, free_memory_bytes=0,
            driver=f"torch-{torch.__version__}")]
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        name = torch.cuda.get_device_name(i)
        out.append(AcceleratorStatus(
            index=i, vendor="nvidia", arch=gpu_arch(name), device_kind=name,
            total_memory_bytes=int(total),
            used_memory_bytes=int(total - free),
            free_memory_bytes=int(free),
            driver=f"cuda-{torch.version.cuda}"))
    return out


def release_device_memory() -> None:
    """Collect dead tensors (an engine loop and its emission stage refer
    to each other, so they go only with a collection) and hand the
    allocator's cached blocks back to the driver."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def upload(a, device) -> torch.Tensor:
    """A host array as a tensor on ``device``, without a synchronising
    copy.  On the card the data is first copied into pinned host memory
    (so the host may write ``a`` again at once) and the upload is queued
    on the current stream with ``non_blocking``; PyTorch's pinned-memory
    cache does not hand that block out again until the upload has run.
    On the CPU it is a plain copy."""
    t = torch.from_numpy(np.array(a, copy=True))
    dev = torch.device(device)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


class Fetch:
    """Device tensors on their way to the host: ``Fetch(tensors)`` queues
    ONE device-to-host copy of all of them (as int64, into pinned memory
    on the card) behind the work already on the current stream and
    records an event; ``wait()`` blocks on that event and returns one
    numpy array per tensor, in order and shape.  The queued copy reads
    the tensors as they are when it runs, which is right after the work
    that made them: later in-place updates do not reach it."""

    def __init__(self, tensors):
        tensors = list(tensors)
        self._shapes = [tuple(t.shape) for t in tensors]
        flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])
        self._event = None
        if flat.is_cuda:
            self._host = torch.empty(flat.shape, dtype=torch.int64,
                                     pin_memory=True)
            self._host.copy_(flat, non_blocking=True)
            # recorded on the tensors' card, whichever is current
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(flat.device))
        else:
            self._host = flat

    def wait(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        host = self._host.numpy()
        out, at = [], 0
        for shape in self._shapes:
            n = int(np.prod(shape, dtype=np.int64))
            out.append(host[at:at + n].reshape(shape))
            at += n
        return out

"""Device selection shared by every entry point of the port.

Entry points (``Engine``, ``init_params``, the server, ``serve-node``) take
an explicit ``device`` that defaults to ``"cuda"``.  Asking for the card on
a machine without one is an error: nothing falls back to the CPU unless the
caller asked for the CPU.
"""

from __future__ import annotations

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


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None

"""Checkpoint / resume of LoRA training state (the port's counterpart of
``helix_tpu/training/checkpoint.py``, which uses orbax).

A checkpoint directory holds ``step_{step:08d}/state.pt`` per saved step:
``{"lora_params", "opt_state", "step", "lora_scaling"}`` of CPU tensors,
ints and floats, written by ``torch.save`` and read back by
``torch.load(..., weights_only=True)``, which builds tensors and plain
containers only and runs no code from the file (``POST /v1/adapters``
reads a path an HTTP caller names).  A save writes a temporary directory
and renames it into place, so a step directory is whole or absent and a
save cut short is never listed; the newest ``keep_last`` steps are kept.

The format is the port's own: an orbax checkpoint of the reference is not
read here, nor the reverse (ROADMAP C).
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Optional

import torch

STATE_FILE = "state.pt"


def _step_dirs(directory: str) -> list:
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    )


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def save_checkpoint(directory: str, step: int, lora_params, opt_state,
                    keep_last: int = 3, lora_scaling: float = 0.0) -> str:
    """Atomic save of ``{lora_params, opt_state, step, lora_scaling}``;
    prunes all but the newest ``keep_last`` steps.  ``lora_scaling``
    (alpha / rank) rides along so serving applies the adapter at the
    strength it was trained at."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp-step_{step:08d}-{uuid.uuid4().hex}")
    os.makedirs(tmp)
    try:
        state = {"lora_params": _to_cpu(lora_params),
                 "opt_state": _to_cpu(opt_state), "step": int(step),
                 "lora_scaling": float(lora_scaling)}
        torch.save(state, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in _step_dirs(directory)[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{old:08d}"),
                      ignore_errors=True)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _step_dirs(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       device=None):
    """``{lora_params, opt_state, step, lora_scaling}`` of ``step`` (the
    latest when None), tensors on ``device`` (the CPU when None); None
    when the directory holds no step.  Raises ``ValueError`` for a step
    whose state file is missing or is not such a checkpoint."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        return None
    path = os.path.join(directory, f"step_{step:08d}", STATE_FILE)
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 - a torn or foreign file raises
        # any of the unpickler's errors (struct.error, EOFError, ...)
        raise ValueError(f"{path}: not a LoRA training checkpoint "
                         f"({type(e).__name__}: {e})") from None
    if not isinstance(state, dict) or not isinstance(
            state.get("lora_params"), dict):
        raise ValueError(f"{path}: not a LoRA training checkpoint (no "
                         "lora_params)")
    return _to_device(state, device) if device is not None else state


def restore_adapter(directory: str, scale: Optional[float] = None,
                    device=None) -> tuple:
    """``(lora_params, scale)`` of the latest step under ``directory``,
    for serving it: the scale is ``scale``, else the checkpoint's
    ``lora_scaling`` (1.0 when that is 0).  ``FileNotFoundError`` when
    the directory holds no step; ``ValueError`` as ``restore_checkpoint``."""
    restored = restore_checkpoint(directory, device=device)
    if restored is None:
        raise FileNotFoundError(
            f"adapter checkpoint not found at {directory!r}")
    if scale is None:
        scale = float(restored.get("lora_scaling") or 0) or 1.0
    return restored["lora_params"], scale


def resume_trainer(trainer, directory: str) -> bool:
    """Load the latest checkpoint into a live ``SFTTrainer``, on its
    device.  True if resumed."""
    restored = restore_checkpoint(directory, device=trainer.device)
    if restored is None:
        return False
    trainer.lora_params = restored["lora_params"]
    trainer.opt_state = restored["opt_state"]
    trainer.step_num = int(restored["step"])
    return True

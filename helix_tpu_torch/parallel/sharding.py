"""Logical-axis sharding rules over a ``device.mesh.Mesh``.

Port of ``helix_tpu/parallel/sharding.py``.  Every weight and the KV pool
carry *logical* axis names ("heads", "mlp", "vocab", ...);
``LOGICAL_RULES`` (copied) maps them to mesh axes and ``spec_for`` turns
a tuple of names into a partition spec, one mesh axis (or None) per
dimension.

The reference hands the spec to ``jax.device_put`` and XLA keeps one
global array whose ``addressable_shards`` live on the mesh's devices.
Here the shards ARE the arrays: ``shard_params`` turns one parameter tree
into one tree per shard, each on its shard's device, holding the same
bytes as the reference's shard of the same array on the same mesh.  A
dimension sharded over an axis of size n is cut into n contiguous equal
blocks, shard i taking block i along every sharded dimension (its
coordinate on that axis, ``tp`` innermost as in ``AXIS_ORDER``); the
other dimensions are copied whole.  A Mixtral expert stack ``[L, X, E,
F]`` (``("layers", "expert", "embed", "mlp")``) thus cuts X over ``ep``
and F over ``tp``; its int8 scale ``[L, X, 1, F]`` keeps every expert
(``quantized_logical_axes`` replicates a scale's other axes) and cuts F
with its columns; the router is whole on every shard.  Over an ``{ep,
tp}`` mesh the KV pool (``POOL_AXES``) cuts its heads over ``tp`` and is
replicated over ``ep``.  Mesh axes of size 1 (and axes the
mesh does not define) prune to replicated, as ``_prune_spec_for_mesh``
does.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from helix_tpu_torch.device.mesh import Mesh

# logical axis name -> mesh axis (or tuple of mesh axes, or None =
# replicated), the reference's Megatron layout
LOGICAL_RULES: dict[str, Any] = {
    # activations
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed_act": None,
    # weights
    "vocab": "tp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "expert": "ep",
    "layers": "pp",
    # kv cache
    "cache_batch": ("dp", "fsdp"),
    "cache_heads": "tp",
    "pages": None,
    # lora
    "lora_rank": None,
}

# the KV pool's axes (``helix_tpu/engine/kv_cache.py:148``) and those of
# its int8 scale pools
POOL_AXES = ("layers", "pages", None, "cache_heads", None)
POOL_SCALE_AXES = ("layers", "pages", None, "cache_heads")


def spec_for(logical_axes: Sequence[Optional[str]], rules=None) -> tuple:
    """Translate a tuple of logical axis names into a partition spec: a
    tuple of mesh axis names (or tuples of them, or None), one per
    dimension."""
    rules = rules or LOGICAL_RULES
    return tuple(rules.get(a) if a is not None else None
                 for a in logical_axes)


def _prune(mesh: Mesh, spec: tuple) -> tuple:
    """Each dimension's mesh axes of size > 1, as a tuple (empty:
    replicated)."""
    sizes = mesh.shape
    out = []
    for ax in spec:
        axes = () if ax is None else (
            tuple(ax) if isinstance(ax, (tuple, list)) else (ax,))
        out.append(tuple(a for a in axes if sizes.get(a, 1) > 1))
    return tuple(out)


def shard_block(shape, logical_axes, mesh: Mesh, index: int) -> list:
    """Shard ``index``'s block of a tensor of ``shape`` under
    ``logical_axes``: ``(start, size)`` per dimension.  Raises where a
    sharded dimension does not divide evenly (as ``jax.device_put``
    does)."""
    spec = _prune(mesh, spec_for(logical_axes))
    if len(spec) != len(shape):
        raise ValueError(
            f"logical axes {tuple(logical_axes)} do not match a tensor of "
            f"shape {tuple(shape)}")
    coords = mesh.coords(index)
    out = []
    for dim, axes in enumerate(spec):
        n, at = 1, 0
        for a in axes:      # the first named axis is the major one
            at = at * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        size = shape[dim]
        if size % n:
            raise ValueError(
                f"dimension {dim} of shape {tuple(shape)} (logical "
                f"{logical_axes[dim]!r}) does not divide over {n} shards")
        out.append((at * (size // n), size // n))
    return out


def shard_tensor(t: torch.Tensor, logical_axes, mesh: Mesh,
                 index: int) -> torch.Tensor:
    """Shard ``index`` of ``t`` under ``logical_axes``: a contiguous copy
    on ``mesh.devices[index]``."""
    out = t
    for dim, (start, size) in enumerate(
            shard_block(t.shape, logical_axes, mesh, index)):
        out = out.narrow(dim, start, size)
    return out.to(mesh.devices[index], copy=True).contiguous()


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def shard_params(params: Any, mesh: Mesh, axes_tree: Any) -> list:
    """One parameter tree per shard of ``mesh``, each leaf placed on its
    shard's device by the matching logical-axes tuple of ``axes_tree``
    (the reference's ``shard_params``, whose ``addressable_shards`` these
    trees hold)."""
    return [_shard_tree(params, axes_tree, mesh, i)
            for i in range(mesh.size)]


def _shard_tree(tree, axes, mesh: Mesh, index: int):
    if isinstance(tree, dict):
        missing = set(tree) - set(axes)
        if missing:
            raise ValueError(f"no logical axes for {sorted(missing)}")
        return {k: _shard_tree(v, axes[k], mesh, index)
                for k, v in tree.items()}
    if not _is_axes(axes):
        raise ValueError(f"expected a logical-axes tuple, got {axes!r}")
    return shard_tensor(tree, axes, mesh, index)

"""HF safetensors checkpoint -> the port's stacked-layer parameter dict.

Port of ``helix_tpu/models/loader.py`` on the port's own safetensors
reader (``models/st_format.py``): ``load_config`` reads ``config.json``,
``load_params`` gives the tree ``init_params`` gives, with the same keys,
layouts and dtypes (HF ``[out, in]`` becomes ``[in, out]``, layers
stacked on axis 0, Qwen2's qkv bias and Qwen3's q/k norms carried,
Phi-3's fused ``qkv_proj`` / ``gate_up_proj`` split, explicit and
implicit ties of ``lm_head`` as the reference handles them).

The load streams on the device: every stacked tensor is allocated on the
device and filled a block of HF rows at a time, in file order, from the
mapped file through a pinned staging ring (two buffers, one being filled
by the host while the other uploads); the cast and the transpose run on
the device.  The host never holds the model in anonymous memory.  With
``quantization="int8"`` each block is quantized as it lands, with the
scales of ``ops.quant.quantize_tensor`` / ``quantize_rows`` (per layer
and output column, per embedding row): the bytes equal
``quantize_params`` of the unquantized load, and the device never holds
the model in its compute dtype.

A Qwen2-VL checkpoint (``model_type: qwen2_vl``) gives its text tower
here, an mrope Qwen-2 config with the reference's ``attention_bias`` and
the checkpoint's dtype, under either HF naming (``model.`` or
``model.language_model.``); ``load_params(..., vision=VisionConfig)``
(``models.qwen2_vl.load_qwen2_vl``) streams its vision tower too
(``visual.`` or ``model.visual.``), into ``params["visual"]``, never
quantized.

On an ``{ep, tp}`` mesh (``load_params(..., mesh=)``) the load gives
one tree per shard, each on its shard's device, equal to
``parallel.sharding.shard_params`` of the whole load byte for byte: each
block of HF rows is staged on the mesh's first device, cast (and
quantized, over the whole input axis, so a row-parallel weight keeps
the whole scale), and each shard's part of it is copied into that
shard's tensors; a Mixtral expert's rows reach only the shards of its
ep coordinate.  No device ever holds the whole model.

A Mixtral checkpoint (``num_local_experts``) gives the MoE layout: each
layer's ``block_sparse_moe.gate`` as ``router [L, E, X]`` and its
``block_sparse_moe.experts.{e}.w1`` / ``w3`` / ``w2`` as the gate, up and
down stacks ``[L, X, ...]``, streamed and quantized like the other
projections (an int8 router and expert stacks keep per-(layer, expert)
output-channel scales, as ``quantize_params`` gives them).

What the port cannot compute is refused when the config is read, before
anything is allocated, naming the ROADMAP item:
an activation ``models.llama`` lacks, and a ``rope_scaling`` other than
``llama3`` or mrope, which the reference loads and then serves as
unscaled rope (ROADMAP C).  A ``sliding_window`` is logged
and not applied: the reference's config drops it too (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import torch

from helix_tpu_torch.device import DEFAULT_DEVICE, resolve_device, torch_dtype
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import ACTIVATIONS
from helix_tpu_torch.models.st_format import SafetensorsDir
from helix_tpu_torch.ops.quant import _quantize_columns

log = logging.getLogger(__name__)

# bytes of one staging buffer (two are used in turn)
STAGE_BYTES = 32 << 20
# rope_scaling types the forward computes (``ops.rope.rope_frequencies``)
ROPE_TYPES = ("default", "llama3")


def unsupported(hf: dict) -> list:
    """What of HF config ``hf`` the port cannot compute, each naming its
    ROADMAP item (empty: loadable)."""
    out = []
    rs = hf.get("rope_scaling") or {}
    act = hf.get("hidden_act", "silu")
    if act not in ACTIVATIONS:
        out.append(f"hidden_act {act!r} is not computed by the port "
                   f"(known: {', '.join(ACTIVATIONS)})")
    kind = rs.get("rope_type", rs.get("type")) if rs else None
    if rs and "mrope_section" not in rs and kind not in ROPE_TYPES:
        out.append(f"rope_scaling type {kind!r} is not computed: the "
                   "reference loads it and serves unscaled rope (ROADMAP C), "
                   "the port refuses it")
    return out


def read_hf_config(model_dir: str) -> dict:
    path = os.path.join(model_dir, "config.json")
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"checkpoint directory {model_dir!r} does "
                                "not exist")
    with open(path) as f:
        return json.load(f)


def load_config(model_dir: str, name: str | None = None) -> ModelConfig:
    """The ``ModelConfig`` of a checkpoint directory's ``config.json``;
    raises ``NotImplementedError`` for a config the port cannot compute."""
    hf = read_hf_config(model_dir)
    why = unsupported(hf)
    if why:
        raise NotImplementedError(f"{model_dir}: " + "; ".join(why))
    name = name or os.path.basename(os.path.normpath(model_dir))
    if hf.get("model_type") != "qwen2_vl":
        return ModelConfig.from_hf_config(hf, name=name)
    # the reference's load_qwen2_vl: a Qwen-2 text tower with its qkv
    # bias, in the checkpoint's dtype
    cfg = ModelConfig.from_hf_config({**hf, "model_type": "qwen2"},
                                     name=name)
    dtype = hf.get("torch_dtype") or hf.get("dtype") or "float32"
    return dataclasses.replace(cfg, attention_bias=True, dtype=str(dtype))


# where HF has put a Qwen2-VL checkpoint's tensors across versions (the
# reference's lookup order, ``qwen2_vl.py:390-398``)
VL_PREFIXES = ("model.", "", "model.language_model.", "language_model.")


@dataclasses.dataclass
class _Dest:
    """Where HF rows land: ``linear`` a projection ``[in, out]`` (HF rows
    are its output columns), ``rows`` the embedding table ``[V, E]``
    (HF rows are its rows), ``vector`` a norm or bias (elements)."""
    kind: str
    tensor: torch.Tensor
    scale: torch.Tensor | None = None


def _plan(cfg: ModelConfig, st: SafetensorsDir, vision=None) -> tuple:
    """``(layout, items)``: the destination tree's shapes and kinds, and
    one ``(HF name, row0, row1, dest path, layer, first dest row)`` per
    piece of an HF tensor (``layer`` indexes the stack's leading axes:
    ``(layer, expert)`` for an expert stack); every HF shape is checked
    here, before anything is allocated.  ``vision`` (a ``VisionConfig``)
    adds the Qwen2-VL vision tower under ``("visual", ...)``."""
    L, E, H, KVH, D, F, V = (
        cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
        cfg.head_dim, cfg.intermediate_size, cfg.vocab_size,
    )
    layout = {
        ("embed",): ("rows", (V, E)),
        ("final_norm",): ("vector", (E,)),
        ("layers", "attn_norm"): ("vector", (L, E)),
        ("layers", "mlp_norm"): ("vector", (L, E)),
        ("layers", "wq"): ("linear", (L, E, H * D)),
        ("layers", "wk"): ("linear", (L, E, KVH * D)),
        ("layers", "wv"): ("linear", (L, E, KVH * D)),
        ("layers", "wo"): ("linear", (L, H * D, E)),
    }
    X = cfg.num_experts
    if X > 0:
        layout[("layers", "router")] = ("linear", (L, E, X))
        layout[("layers", "experts", "w_gate")] = ("linear", (L, X, E, F))
        layout[("layers", "experts", "w_up")] = ("linear", (L, X, E, F))
        layout[("layers", "experts", "w_down")] = ("linear", (L, X, F, E))
    else:
        layout[("layers", "w_gate")] = ("linear", (L, E, F))
        layout[("layers", "w_up")] = ("linear", (L, E, F))
        layout[("layers", "w_down")] = ("linear", (L, F, E))
    items = []

    vl = cfg.mrope_sections is not None

    def resolve(name):
        # text names are written with the ``model.`` prefix; a Qwen2-VL
        # checkpoint may hold them under any of the reference's prefixes
        if not vl or name in st:
            return name
        bare = name.removeprefix("model.")
        return next((p + bare for p in VL_PREFIXES if p + bare in st), name)

    def add(name, path, layer=None, rows=None, at=0, hf_shape=None):
        name = resolve(name)
        if name not in st:
            raise KeyError(f"checkpoint has no tensor {name!r}")
        shape = st.shape(name)
        if hf_shape is not None and tuple(shape) != tuple(hf_shape):
            raise ValueError(f"{name}: shape {tuple(shape)}, the config "
                             f"needs {tuple(hf_shape)}")
        r0, r1 = rows if rows is not None else (0, shape[0])
        items.append((name, r0, r1, path, layer, at))

    pfx = "model.layers.{}."
    fused_qkv = resolve(f"{pfx.format(0)}self_attn.qkv_proj.weight") in st
    fused_mlp = resolve(f"{pfx.format(0)}mlp.gate_up_proj.weight") in st
    add("model.embed_tokens.weight", ("embed",), hf_shape=(V, E))
    add("model.norm.weight", ("final_norm",), hf_shape=(E,))
    widths = (("wq", "q_proj", H * D), ("wk", "k_proj", KVH * D),
              ("wv", "v_proj", KVH * D))
    bias = (cfg.attention_bias
            and resolve(f"{pfx.format(0)}self_attn.q_proj.bias") in st)
    for i in range(L):
        p = pfx.format(i)
        add(p + "input_layernorm.weight", ("layers", "attn_norm"), i,
            hf_shape=(E,))
        add(p + "post_attention_layernorm.weight", ("layers", "mlp_norm"),
            i, hf_shape=(E,))
        at = 0
        for ours, theirs, w in widths:
            if fused_qkv:
                add(p + "self_attn.qkv_proj.weight", ("layers", ours), i,
                    rows=(at, at + w), hf_shape=((H + 2 * KVH) * D, E))
            else:
                add(p + f"self_attn.{theirs}.weight", ("layers", ours), i,
                    hf_shape=(w, E))
            if bias:
                add(p + f"self_attn.{theirs}.bias", ("layers", ours, "bias"),
                    i, hf_shape=(w,))
            at += w
        add(p + "self_attn.o_proj.weight", ("layers", "wo"), i,
            hf_shape=(E, H * D))
        if X > 0:
            # HF Mixtral: w1 = gate, w3 = up, w2 = down
            moe = p + "block_sparse_moe."
            add(moe + "gate.weight", ("layers", "router"), i,
                hf_shape=(X, E))
            for e in range(X):
                for ours, theirs, shape in (("w_gate", "w1", (F, E)),
                                            ("w_up", "w3", (F, E)),
                                            ("w_down", "w2", (E, F))):
                    add(moe + f"experts.{e}.{theirs}.weight",
                        ("layers", "experts", ours), (i, e), hf_shape=shape)
        elif fused_mlp:
            add(p + "mlp.gate_up_proj.weight", ("layers", "w_gate"), i,
                rows=(0, F), hf_shape=(2 * F, E))
            add(p + "mlp.gate_up_proj.weight", ("layers", "w_up"), i,
                rows=(F, 2 * F), hf_shape=(2 * F, E))
        else:
            add(p + "mlp.gate_proj.weight", ("layers", "w_gate"), i,
                hf_shape=(F, E))
            add(p + "mlp.up_proj.weight", ("layers", "w_up"), i,
                hf_shape=(F, E))
        if X == 0:
            add(p + "mlp.down_proj.weight", ("layers", "w_down"), i,
                hf_shape=(E, F))
        if cfg.qk_norm:
            add(p + "self_attn.q_norm.weight", ("layers", "q_norm"), i,
                hf_shape=(D,))
            add(p + "self_attn.k_norm.weight", ("layers", "k_norm"), i,
                hf_shape=(D,))
    if bias:
        for ours, _theirs, w in widths:
            layout[("layers", ours, "bias")] = ("vector", (L, w))
    if cfg.qk_norm:
        layout[("layers", "q_norm")] = ("vector", (L, D))
        layout[("layers", "k_norm")] = ("vector", (L, D))
    if not cfg.tie_word_embeddings:
        layout[("lm_head",)] = ("linear", (E, V))
        # some checkpoints tie implicitly: the head is the embedding's
        head = next((n for n in ("model.lm_head.weight", "lm_head.weight")
                     if n in st and (vl or n == "lm_head.weight")),
                    "model.embed_tokens.weight")
        add(head, ("lm_head",), hf_shape=(V, E))
    if vision is not None:
        _plan_vision(vision, layout, add)
    return layout, items


def _plan_vision(vc, layout: dict, add) -> None:
    """The vision tower's destinations and HF tensors (``visual.`` names,
    resolved like the text tower's): ``patch_embed.proj`` is a conv3d
    whose ``[E, C, Tp, P, P]`` weight is the ``[patch_dim, E]`` matmul,
    each block's ``attn.qkv`` / ``attn.proj`` / ``mlp.fc1`` / ``mlp.fc2``
    with bias and its two layer norms, the merger's ``ln_q`` and its
    ``mlp.0`` / ``mlp.2``."""
    Lv, E = vc.depth, vc.embed_dim
    F = E * vc.mlp_ratio
    M = E * vc.spatial_merge_size**2
    v = ("visual",)
    layout[v + ("patch_embed",)] = ("linear", (vc.patch_dim, E))
    add("model.visual.patch_embed.proj.weight", v + ("patch_embed",),
        hf_shape=(E, vc.in_channels, vc.temporal_patch_size,
                  vc.patch_size, vc.patch_size))
    blocks = (("qkv", "attn.qkv", E, 3 * E), ("proj", "attn.proj", E, E),
              ("fc1", "mlp.fc1", E, F), ("fc2", "mlp.fc2", F, E))
    for ours, _theirs, n_in, n_out in blocks:
        layout[v + ("blocks", ours)] = ("linear", (Lv, n_in, n_out))
        layout[v + ("blocks", ours, "bias")] = ("vector", (Lv, n_out))
    for norm in ("norm1", "norm2"):
        layout[v + ("blocks", norm)] = ("vector", (Lv, E))
        layout[v + ("blocks", norm, "bias")] = ("vector", (Lv, E))
    for i in range(Lv):
        p = f"model.visual.blocks.{i}."
        for norm in ("norm1", "norm2"):
            add(p + norm + ".weight", v + ("blocks", norm), i,
                hf_shape=(E,))
            add(p + norm + ".bias", v + ("blocks", norm, "bias"), i,
                hf_shape=(E,))
        for ours, theirs, n_in, n_out in blocks:
            add(p + theirs + ".weight", v + ("blocks", ours), i,
                hf_shape=(n_out, n_in))
            add(p + theirs + ".bias", v + ("blocks", ours, "bias"), i,
                hf_shape=(n_out,))
    m = v + ("merger",)
    layout[m + ("ln_q",)] = ("vector", (E,))
    layout[m + ("ln_q", "bias")] = ("vector", (E,))
    add("model.visual.merger.ln_q.weight", m + ("ln_q",), hf_shape=(E,))
    add("model.visual.merger.ln_q.bias", m + ("ln_q", "bias"),
        hf_shape=(E,))
    for ours, k, n_out in (("mlp0", 0, M), ("mlp2", 2, vc.hidden_size)):
        layout[m + (ours,)] = ("linear", (M, n_out))
        layout[m + (ours, "bias")] = ("vector", (n_out,))
        add(f"model.visual.merger.mlp.{k}.weight", m + (ours,),
            hf_shape=(n_out, M))
        add(f"model.visual.merger.mlp.{k}.bias", m + (ours, "bias"),
            hf_shape=(n_out,))


def _allocate(layout: dict, dtype, device, quantized: bool) -> tuple:
    """The empty parameter tree and its destinations by path."""
    params, dests = {}, {}
    for path, (kind, shape) in layout.items():
        node = params
        for k in path[:-1] if path[-1] == "bias" else path:
            node = node.setdefault(k, {})
        if path[-1] == "bias":
            t = torch.empty(shape, dtype=dtype, device=device)
            node["bias"] = t
            dests[path] = _Dest("vector", t)
            continue
        if kind == "vector" or not quantized or path[0] == "visual":
            t = torch.empty(shape, dtype=dtype, device=device)
            node["weight"] = t
            dests[path] = _Dest(kind, t)
        elif kind == "rows":
            t = torch.empty(shape, dtype=torch.int8, device=device)
            s = torch.empty((shape[0], 1), dtype=torch.float32, device=device)
            node["weight"], node["embed_scale"] = t, s
            dests[path] = _Dest(kind, t, s)
        else:
            t = torch.empty(shape, dtype=torch.int8, device=device)
            s = torch.empty((*shape[:-2], 1, shape[-1]), dtype=torch.float32,
                            device=device)
            node["weight"], node["scale"] = t, s
            dests[path] = _Dest(kind, t, s)
    return params, dests


@dataclasses.dataclass
class _ShardedDest:
    """A destination cut over a mesh: one ``_Dest`` a shard, the whole
    tensor's shape, and the logical axes of its tensor and its scale."""
    kind: str
    shards: list
    shape: tuple
    axes: tuple
    scale_axes: tuple | None
    mesh: object


def _axes_of(axes_tree, path) -> tuple:
    """``(tensor axes, scale axes or None)`` of a layout path."""
    node = axes_tree
    for k in path[:-1] if path[-1] == "bias" else path:
        node = node[k]
    if path[-1] == "bias":
        return node["bias"], None
    return node["weight"], node.get("scale", node.get("embed_scale"))


def _allocate_sharded(layout: dict, dtype, mesh, quantized: bool,
                      axes_tree) -> tuple:
    """One empty parameter tree per shard of ``mesh`` (each tensor its
    shard's block, on its device) and the destinations by path."""
    from helix_tpu_torch.parallel.sharding import shard_block

    trees, per_shard = [], []
    for i, dev in enumerate(mesh.devices):
        cut = {path: (kind, tuple(n for _s, n in shard_block(
            shape, _axes_of(axes_tree, path)[0], mesh, i)))
            for path, (kind, shape) in layout.items()}
        tree, dests = _allocate(cut, dtype, dev, quantized)
        for path, d in dests.items():
            if d.scale is None or d.kind != "linear":
                continue
            # a scale's block by its own axes: an expert stack's scale
            # keeps every expert (``quantized_logical_axes``)
            full = layout[path][1]
            shape = tuple(n for _s, n in shard_block(
                (*full[:-2], 1, full[-1]), _axes_of(axes_tree, path)[1],
                mesh, i))
            if shape != tuple(d.scale.shape):
                d.scale = torch.empty(shape, dtype=d.scale.dtype, device=dev)
                node = tree
                for k in path:
                    node = node[k]
                node["scale"] = d.scale
        trees.append(tree)
        per_shard.append(dests)
    dests = {path: _ShardedDest(kind, [d[path] for d in per_shard], shape,
                                *_axes_of(axes_tree, path), mesh)
             for path, (kind, shape) in layout.items()}
    return trees, dests


def _put_sharded(sd: _ShardedDest, layer, at: int, x) -> None:
    """``_put`` over a mesh: the block's values (cast, or codes and
    scales quantized over the whole input axis) computed once where the
    block was staged, and each shard's part copied into its tensors."""
    from helix_tpu_torch.parallel.sharding import shard_block

    n = x.shape[0]
    quantized = sd.shards[0].scale is not None
    if sd.kind == "vector":
        parts = [("tensor", (at,), x)]
    elif sd.kind == "rows" and quantized:
        q, sc = _quantize_columns(x.float(), -1)
        parts = [("tensor", (at, 0), q), ("scale", (at, 0), sc)]
    elif sd.kind == "rows":
        parts = [("tensor", (at, 0), x)]
    elif quantized:
        q, sc = _quantize_columns(x.t().float(), 0)
        parts = [("tensor", (0, at), q), ("scale", (0, at), sc)]
    else:
        parts = [("tensor", (0, at), x.reshape(n, -1).t())]
    lead = () if layer is None else layer if isinstance(
        layer, tuple) else (layer,)
    for field, starts, v in parts:
        axes, full = sd.axes, sd.shape
        if field == "scale":
            axes = sd.scale_axes
            full = ((full[0], 1) if sd.kind == "rows"
                    else (*full[:-2], 1, full[-1]))
        for i, dest in enumerate(sd.shards):
            block = shard_block(full, axes, sd.mesh, i)
            # the stack's leading indices (layer, expert) in the shard's
            # own block: an expert another ep shard holds is skipped
            local = tuple(j - lo for j, (lo, size) in zip(lead, block)
                          if lo <= j < lo + size)
            if len(local) != len(lead):
                continue
            t = getattr(dest, field)
            src, dst = v, (t[local] if local else t)
            block = block[len(lead):]
            for dim, ((lo, size), a) in enumerate(zip(block, starts)):
                s0 = max(a, lo)
                s1 = min(a + v.shape[dim], lo + size)
                if s0 >= s1:
                    break
                src = src.narrow(dim, s0 - a, s1 - s0)
                dst = dst.narrow(dim, s0 - lo, s1 - s0)
            else:
                dst.copy_(src)


def _put(dest, layer, at: int, x: torch.Tensor) -> None:
    """Write HF rows ``x`` (in the compute dtype, on the device) into
    ``dest`` from its row / column ``at``; quantized destinations get the
    codes and scales ``quantize_tensor`` / ``quantize_rows`` give."""
    if isinstance(dest, _ShardedDest):
        return _put_sharded(dest, layer, at, x)
    t = dest.tensor if layer is None else dest.tensor[layer]
    n = x.shape[0]
    if dest.kind == "vector":
        t[at:at + n] = x
    elif dest.kind == "rows":
        if dest.scale is None:
            t[at:at + n] = x
        else:
            t[at:at + n], dest.scale[at:at + n] = _quantize_columns(
                x.float(), -1)
    elif dest.scale is None:
        # a conv weight's trailing dims flatten into the input axis
        t[:, at:at + n] = x.reshape(n, -1).t()
    else:
        s = dest.scale if layer is None else dest.scale[layer]
        t[:, at:at + n], s[:, at:at + n] = _quantize_columns(
            x.t().float(), 0)


def load_params(model_dir: str, cfg: ModelConfig | None = None, *,
                device=DEFAULT_DEVICE, dtype=None, quantization=None,
                stats: dict | None = None, vision=None,
                mesh=None) -> tuple:
    """``(cfg, params)`` of a checkpoint directory, ``params`` on
    ``device`` in ``dtype`` (default the config's), int8 projections and
    embedding with ``quantization="int8"``.  ``stats``, if given, gets
    the bytes read and the seconds of the host read (mapped file to the
    staging buffer, page faults included), of the uploads (device time,
    on the card) and of the whole load.  ``vision``: a Qwen2-VL
    checkpoint's ``VisionConfig``, whose tower lands in
    ``params["visual"]`` in ``dtype``, never quantized.  ``mesh`` (a
    ``device.mesh.Mesh``; ``device`` is then not read): one tree per
    shard by ``models.llama.param_logical_axes`` (int8:
    ``ops.quant.quantized_logical_axes``), staged on its first device."""
    if quantization not in (None, "int8"):
        raise ValueError(
            f"quantization {quantization!r}: expected None or 'int8'")
    cfg = cfg or load_config(model_dir)
    if mesh is not None and vision is not None:
        raise NotImplementedError(
            f"{cfg.name}: loading a vision checkpoint onto a mesh is not "
            "ported yet (ROADMAP A15b: vision on a mesh)")
    dev = resolve_device(mesh.devices[0] if mesh is not None else device)
    dt = torch_dtype(dtype or cfg.dtype)
    name = str(dt).removeprefix("torch.")
    if cfg.dtype != name:
        cfg = dataclasses.replace(cfg, dtype=name)
    window = read_hf_config(model_dir).get("sliding_window")
    if window:
        log.warning("%s: sliding_window %s is not applied; every layer "
                    "attends to the whole history, as the reference's "
                    "config does (ROADMAP C)", cfg.name, window)
    t_start = time.monotonic()
    with SafetensorsDir(model_dir) as st:
        layout, items = _plan(cfg, st, vision)
        if mesh is None:
            params, dests = _allocate(layout, dt, dev,
                                      quantization == "int8")
        else:
            from helix_tpu_torch.models.llama import param_logical_axes
            from helix_tpu_torch.ops.quant import quantized_logical_axes

            axes = param_logical_axes(cfg)
            if quantization == "int8":
                axes = quantized_logical_axes(axes)
            params, dests = _allocate_sharded(
                layout, dt, mesh, quantization == "int8", axes)
        got = _stream(st, items, dests, dt, dev)
    if stats is not None:
        stats.update(got, seconds=time.monotonic() - t_start)
    return cfg, params


def _stream(st: SafetensorsDir, items: list, dests: dict, dt,
            dev: torch.device) -> dict:
    """Copy every item's rows into its destination, in blocks of at most
    ``STAGE_BYTES``, in file order."""
    blocks = []
    for name, r0, r1, path, layer, at in items:
        fname, _dtype, shape, begin, end = st.entry(name)
        row_bytes = (end - begin) // max(shape[0], 1)
        step = max(1, STAGE_BYTES // max(row_bytes, 1))
        for c0 in range(r0, r1, step):
            c1 = min(r1, c0 + step)
            blocks.append((fname, begin + c0 * row_bytes, name, c0, c1,
                           path, layer, at + c0 - r0))
    blocks.sort(key=lambda b: b[:2])
    cuda = dev.type == "cuda"
    timing = []                    # (start, end) event of each upload
    if cuda:
        stage = [torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
                 for _ in range(2)]
        free = [None, None]        # event: the slot's upload has run
        # the uploads run on ``dev``'s stream, which need not be the
        # current device's: the events are recorded there
        stream = torch.cuda.current_stream(dev)
    read_s, nbytes = 0.0, 0
    for k, (_fname, _off, name, c0, c1, path, layer,
            at) in enumerate(blocks):
        src = st.get(name)[c0:c1]          # a view of the mapped file
        nbytes += src.nbytes
        if cuda:
            slot = k % 2
            if free[slot] is not None:
                free[slot].synchronize()
            flat = stage[slot][:src.nbytes]
            t0 = time.monotonic()
            flat.copy_(src.reshape(-1).view(torch.uint8))
            read_s += time.monotonic() - t0
            g = torch.empty(src.nbytes, dtype=torch.uint8, device=dev)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record(stream)
            g.copy_(flat, non_blocking=True)
            ev1.record(stream)
            free[slot] = ev1
            timing.append((ev0, ev1))
            x = g.view(src.dtype).view(src.shape)
        else:
            x = src
        _put(dests[path], layer, at, x.to(dt))
        del src, x
    upload_s = None
    if timing:
        timing[-1][1].synchronize()     # every block's work has run
        upload_s = sum(a.elapsed_time(b) for a, b in timing) / 1e3
    return {"bytes": nbytes, "read_seconds": read_s,
            "upload_seconds": upload_s, "blocks": len(blocks)}

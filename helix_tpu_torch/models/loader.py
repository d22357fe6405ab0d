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

What the port cannot compute is refused when the config is read, before
anything is allocated, naming the ROADMAP item: mixture-of-experts (A15),
mrope / Qwen2-VL (A17b), an activation ``models.llama`` lacks, and a
``rope_scaling`` other than ``llama3``, which the reference loads and
then serves as unscaled rope (ROADMAP C).  A ``sliding_window`` is logged
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
from helix_tpu_torch.models.llama import ACTIVATIONS, check_supported
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
    if int(hf.get("num_local_experts") or 0) > 0:
        out.append(f"num_local_experts {hf['num_local_experts']}: "
                   "mixture-of-experts models are not ported yet "
                   "(ROADMAP A15)")
    rs = hf.get("rope_scaling") or {}
    if hf.get("model_type") == "qwen2_vl" or "mrope_section" in rs:
        out.append(f"model_type {hf.get('model_type')!r} with mrope "
                   "(vision) is not ported yet (ROADMAP A17b)")
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
    return ModelConfig.from_hf_config(
        hf, name=name or os.path.basename(os.path.normpath(model_dir)))


@dataclasses.dataclass
class _Dest:
    """Where HF rows land: ``linear`` a projection ``[in, out]`` (HF rows
    are its output columns), ``rows`` the embedding table ``[V, E]``
    (HF rows are its rows), ``vector`` a norm or bias (elements)."""
    kind: str
    tensor: torch.Tensor
    scale: torch.Tensor | None = None


def _plan(cfg: ModelConfig, st: SafetensorsDir) -> tuple:
    """``(layout, items)``: the destination tree's shapes and kinds, and
    one ``(HF name, row0, row1, dest path, layer, first dest row)`` per
    piece of an HF tensor; every HF shape is checked here, before
    anything is allocated."""
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
        ("layers", "w_gate"): ("linear", (L, E, F)),
        ("layers", "w_up"): ("linear", (L, E, F)),
        ("layers", "w_down"): ("linear", (L, F, E)),
    }
    items = []

    def add(name, path, layer=None, rows=None, at=0, hf_shape=None):
        if name not in st:
            raise KeyError(f"checkpoint has no tensor {name!r}")
        shape = st.shape(name)
        if hf_shape is not None and tuple(shape) != tuple(hf_shape):
            raise ValueError(f"{name}: shape {tuple(shape)}, the config "
                             f"needs {tuple(hf_shape)}")
        r0, r1 = rows if rows is not None else (0, shape[0])
        items.append((name, r0, r1, path, layer, at))

    pfx = "model.layers.{}."
    fused_qkv = f"{pfx.format(0)}self_attn.qkv_proj.weight" in st
    fused_mlp = f"{pfx.format(0)}mlp.gate_up_proj.weight" in st
    add("model.embed_tokens.weight", ("embed",), hf_shape=(V, E))
    add("model.norm.weight", ("final_norm",), hf_shape=(E,))
    widths = (("wq", "q_proj", H * D), ("wk", "k_proj", KVH * D),
              ("wv", "v_proj", KVH * D))
    bias = (cfg.attention_bias
            and f"{pfx.format(0)}self_attn.q_proj.bias" in st)
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
        if fused_mlp:
            add(p + "mlp.gate_up_proj.weight", ("layers", "w_gate"), i,
                rows=(0, F), hf_shape=(2 * F, E))
            add(p + "mlp.gate_up_proj.weight", ("layers", "w_up"), i,
                rows=(F, 2 * F), hf_shape=(2 * F, E))
        else:
            add(p + "mlp.gate_proj.weight", ("layers", "w_gate"), i,
                hf_shape=(F, E))
            add(p + "mlp.up_proj.weight", ("layers", "w_up"), i,
                hf_shape=(F, E))
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
        head = ("lm_head.weight" if "lm_head.weight" in st
                else "model.embed_tokens.weight")
        add(head, ("lm_head",), hf_shape=(V, E))
    return layout, items


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
        if kind == "vector" or not quantized:
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


def _put(dest: _Dest, layer, at: int, x: torch.Tensor) -> None:
    """Write HF rows ``x`` (in the compute dtype, on the device) into
    ``dest`` from its row / column ``at``; quantized destinations get the
    codes and scales ``quantize_tensor`` / ``quantize_rows`` give."""
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
        t[:, at:at + n] = x.t()
    else:
        s = dest.scale if layer is None else dest.scale[layer]
        t[:, at:at + n], s[:, at:at + n] = _quantize_columns(
            x.t().float(), 0)


def load_params(model_dir: str, cfg: ModelConfig | None = None, *,
                device=DEFAULT_DEVICE, dtype=None, quantization=None,
                stats: dict | None = None) -> tuple:
    """``(cfg, params)`` of a checkpoint directory, ``params`` on
    ``device`` in ``dtype`` (default the config's), int8 projections and
    embedding with ``quantization="int8"``.  ``stats``, if given, gets
    the bytes read and the seconds of the host read (mapped file to the
    staging buffer, page faults included), of the uploads (device time,
    on the card) and of the whole load."""
    if quantization not in (None, "int8"):
        raise ValueError(
            f"quantization {quantization!r}: expected None or 'int8'")
    cfg = cfg or load_config(model_dir)
    check_supported(cfg)
    dev = resolve_device(device)
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
        layout, items = _plan(cfg, st)
        params, dests = _allocate(layout, dt, dev, quantization == "int8")
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
            ev0.record()
            g.copy_(flat, non_blocking=True)
            ev1.record()
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

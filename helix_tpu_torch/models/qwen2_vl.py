"""Qwen2-VL: the vision tower and the M-RoPE text tower in PyTorch.

Port of ``helix_tpu/models/qwen2_vl.py``:

- Vision tower (``vision_forward``): a ViT over pre-extracted patch rows
  (the conv3d patch embed is one matmul), 2D rotary embeddings split
  across the (h, w) halves of each head, full bidirectional attention
  within each image (a segment mask between images), and the spatial
  merger MLP projecting groups of merge^2 patches into the text tower's
  hidden space.  Activations follow the patches' dtype (float32 from
  ``serving.vision.patchify``), weights stay in the checkpoint's dtype
  and every projection goes through ``ops.quant.maybe_dequant_dense``;
  the scores are float32 ``torch.matmul`` and softmax, as the reference's
  einsums (no kernel: the reference has no Pallas form of them).
- Text tower (``text_forward_mrope``): the Llama-family decoder of
  ``models.llama`` with **M-RoPE**: sections of the head dim rotate by
  (temporal, height, width) position streams; text tokens advance the
  three together, image spans fan out over h / w (``mrope_positions``,
  HF's ``get_rope_index``).  Causal masking and KV writes stay by
  sequence index.
- ``load_qwen2_vl``: an HF Qwen2-VL checkpoint through the port's
  streamed loader (``models.loader``), both towers on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from helix_tpu_torch.device import DEFAULT_DEVICE, resolve_device, torch_dtype
from helix_tpu_torch.models.common import ModelConfig
from helix_tpu_torch.models.llama import _to_tensor, forward
from helix_tpu_torch.ops.norms import layer_norm
from helix_tpu_torch.ops.quant import maybe_dequant_dense as _dense


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 3584          # text tower hidden (merger output)
    num_heads: int = 16
    mlp_ratio: int = 4
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @classmethod
    def from_hf(cls, d: dict) -> "VisionConfig":
        return cls(
            depth=d["depth"],
            embed_dim=d["embed_dim"],
            hidden_size=d["hidden_size"],
            num_heads=d["num_heads"],
            mlp_ratio=d["mlp_ratio"],
            in_channels=d.get("in_channels", 3),
            patch_size=d["patch_size"],
            spatial_merge_size=d["spatial_merge_size"],
            temporal_patch_size=d["temporal_patch_size"],
        )

    @classmethod
    def tiny(cls, **o) -> "VisionConfig":
        base = dict(
            depth=2, embed_dim=32, hidden_size=64, num_heads=2, mlp_ratio=2,
            patch_size=4, spatial_merge_size=2, temporal_patch_size=2,
        )
        base.update(o)
        return cls(**base)


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------


def vision_rotary_pos(grid_thw, merge: int) -> np.ndarray:
    """Per-patch (h, w) rotary ids in the processor's merge-block patch
    order.  grid_thw: [n_images, 3] (t, h, w in patch units)."""
    out = []
    for t, h, w in np.asarray(grid_thw):
        hpos = np.arange(h)[:, None].repeat(w, axis=1)
        wpos = np.arange(w)[None, :].repeat(h, axis=0)

        def blockify(x):
            return (
                x.reshape(h // merge, merge, w // merge, merge)
                .transpose(0, 2, 1, 3)
                .reshape(-1)
            )

        hw = np.stack([blockify(hpos), blockify(wpos)], axis=-1)  # [h*w, 2]
        out.append(np.tile(hw, (int(t), 1)))
    return np.concatenate(out, axis=0)  # [N, 2]


def _vision_rope(q, k, pos_hw, head_dim: int):
    """Rotate q / k with 2D rope: the first half of the rotary dims from
    h, the second from w (HF Qwen2-VL: h and w frequencies concatenated)."""
    half = head_dim // 2
    quarter = half // 2
    inv = 1.0 / (10000.0 ** (np.arange(0, quarter) * 2.0 / half))
    inv = torch.as_tensor(inv, dtype=torch.float32, device=q.device)
    h_angles = pos_hw[:, 0:1].float() * inv[None]                # [N, q]
    w_angles = pos_hw[:, 1:2].float() * inv[None]
    angles = torch.cat([h_angles, w_angles], dim=-1)               # [N, half]
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def init_vision_params(cfg: VisionConfig, seed: int = 0, *,
                       device=DEFAULT_DEVICE, dtype="float32",
                       generator: Optional[torch.Generator] = None) -> dict:
    """Random-init vision tower ON ``device``: normal x 0.02 for the
    projections, ones / zeros for the layer norms and biases
    (``qwen2_vl.py:127-160``), drawn from ``generator`` (else one seeded
    with ``seed`` on the device), block by block."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype) if isinstance(dtype, str) else dtype
    gen = generator or torch.Generator(device=dev).manual_seed(int(seed))
    E, F = cfg.embed_dim, cfg.embed_dim * cfg.mlp_ratio
    Lv = cfg.depth
    m2 = cfg.spatial_merge_size**2

    def w(shape, stacked=False):
        out = torch.empty(shape, dtype=dt, device=dev)
        for part in (out if stacked else (out,)):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev,
                                   dtype=torch.float32).mul_(0.02))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    return {
        "patch_embed": {"weight": w((cfg.patch_dim, E))},
        "blocks": {
            "norm1": {"weight": ones((Lv, E)), "bias": zeros((Lv, E))},
            "norm2": {"weight": ones((Lv, E)), "bias": zeros((Lv, E))},
            "qkv": {"weight": w((Lv, E, 3 * E), True),
                    "bias": zeros((Lv, 3 * E))},
            "proj": {"weight": w((Lv, E, E), True), "bias": zeros((Lv, E))},
            "fc1": {"weight": w((Lv, E, F), True), "bias": zeros((Lv, F))},
            "fc2": {"weight": w((Lv, F, E), True), "bias": zeros((Lv, E))},
        },
        "merger": {
            "ln_q": {"weight": ones((E,)), "bias": zeros((E,))},
            "mlp0": {"weight": w((E * m2, E * m2)),
                     "bias": zeros((E * m2,))},
            "mlp2": {"weight": w((E * m2, cfg.hidden_size)),
                     "bias": zeros((cfg.hidden_size,))},
        },
    }


def vision_params_from_jax(tree) -> dict:
    """The reference's vision tree (after ``jax.device_get``: nested dicts
    of numpy arrays, same keys and ``[in, out]`` layouts) as the port's
    CPU tensors, dtypes kept."""
    if isinstance(tree, dict):
        return {k: vision_params_from_jax(v) for k, v in tree.items()}
    return _to_tensor(tree)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def vision_forward(params: dict, cfg: VisionConfig, patches, grid_thw):
    """``patches [N, patch_dim]`` (pre-extracted patch rows, on the
    tower's device) and ``grid_thw [n_images, 3]`` (host ints: they drive
    the masks and positions) -> ``[N / merge^2, hidden_size]`` image
    embeddings.  Each block's ``[heads, N, N]`` float32 scores are freed
    before the next block's are made."""
    grid = np.asarray(grid_thw)
    N = patches.shape[0]
    E, H, D = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    dev = patches.device

    x = _dense(patches, params["patch_embed"])
    pos_hw = torch.from_numpy(
        vision_rotary_pos(grid, cfg.spatial_merge_size)).to(dev)
    # segment id per patch: attention stays within an image (one image
    # needs no mask: its bias would be all zeros)
    sizes = [int(t * h * w) for t, h, w in grid]
    attn_bias = None
    if len(sizes) > 1:
        seg = torch.from_numpy(
            np.repeat(np.arange(len(sizes)), sizes)).to(dev)
        attn_bias = torch.where(seg[:, None] == seg[None, :], 0.0,
                                -1e9)[None].float()             # [1, N, N]
    blocks = params["blocks"]
    sqrt_d = float(np.sqrt(D))
    for i in range(cfg.depth):
        bp = {k: {kk: vv[i] for kk, vv in v.items()}
              for k, v in blocks.items()}
        y = layer_norm(x, bp["norm1"]["weight"], bp["norm1"]["bias"])
        qkv = _dense(y, bp["qkv"]).reshape(N, 3, H, D)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        q, k = _vision_rope(q, k, pos_hw, D)
        s = torch.matmul(q.float().transpose(0, 1),
                         k.float().permute(1, 2, 0)) / sqrt_d     # [H,N,N]
        if attn_bias is not None:
            s = s + attn_bias
        p = torch.softmax(s, dim=-1)
        del s
        ctx = torch.matmul(p, v.float().transpose(0, 1))          # [H,N,D]
        del p
        ctx = ctx.transpose(0, 1).reshape(N, E).to(x.dtype)
        x = x + _dense(ctx, bp["proj"])
        y = layer_norm(x, bp["norm2"]["weight"], bp["norm2"]["bias"])
        x = x + _dense(_quick_gelu(_dense(y, bp["fc1"])), bp["fc2"])

    m = params["merger"]
    x = layer_norm(x, m["ln_q"]["weight"], m["ln_q"]["bias"])
    m2 = cfg.spatial_merge_size**2
    x = x.reshape(N // m2, E * m2)
    return _dense(torch.nn.functional.gelu(_dense(x, m["mlp0"])), m["mlp2"])


# ---------------------------------------------------------------------------
# M-RoPE for the text tower
# ---------------------------------------------------------------------------


def _mrope_index(head_dim: int, sections: Sequence[int], device):
    """Which position stream rotates each of the ``head_dim`` dims: HF's
    ``mrope_section * 2`` is list repetition, so the [t, h, w] split of
    the D/2 frequencies applies to both halves and a rotation pair (j,
    j + D/2) takes cos and sin from one stream."""
    half = np.concatenate([np.full((s,), i) for i, s in enumerate(sections)])
    if 2 * len(half) != head_dim:
        raise ValueError(f"mrope sections {tuple(sections)} do not split "
                         f"head_dim {head_dim} / 2")
    return torch.from_numpy(np.concatenate([half, half])).to(device)


def apply_mrope(x, positions3, inv_freq, sections: Sequence[int]):
    """Rotate q or k with multimodal rope.

    x: [B, S, H, D]; positions3: [3, B, S] (t, h, w streams); inv_freq:
    [D/2] float32 on x's device; sections: the split of the D/2
    frequency dims across the three streams (e.g. [16, 24, 24] for D=128).
    The stream of each dim is selected, not summed (the reference's
    one-hot einsum gives the same value exactly)."""
    ang = positions3[..., None].float() * inv_freq                 # [3,B,S,D/2]
    ang = torch.cat([ang, ang], dim=-1)                            # [3,B,S,D]
    idx = _mrope_index(x.shape[-1], sections, x.device)
    angles = torch.where(idx == 0, ang[0],
                         torch.where(idx == 1, ang[1], ang[2]))   # [B,S,D]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rot_half = torch.cat([-x2, x1], dim=-1)
    return (xf * cos + rot_half * sin).to(x.dtype)


def mrope_positions(
    input_ids: Sequence[int],
    grid_thw,
    image_token_id: int,
    merge: int = 2,
    start: Sequence[int] = (0, 0, 0),
) -> tuple:
    """(positions3 [3, S], next_delta) for one sequence: HF's
    ``get_rope_index`` on the host.

    Text tokens advance (t, h, w) together; each image span (a run of
    ``image_token_id``) gets t constant and h / w enumerating the merged
    grid; after the span every stream jumps to max + 1.  ``next_delta``
    is the shared offset of decode positions (position - token index)."""
    ids = list(input_ids)
    grid = np.asarray(grid_thw) if grid_thw is not None else np.zeros((0, 3))
    S = len(ids)
    pos = np.zeros((3, S), np.int64)
    cur = list(start)
    img = 0
    i = 0
    while i < S:
        if ids[i] == image_token_id and img < len(grid):
            t, h, w = (int(v) for v in grid[img])
            hh, ww = h // merge, w // merge
            n = t * hh * ww
            tpos = np.repeat(np.arange(t), hh * ww)
            hpos = np.tile(np.repeat(np.arange(hh), ww), t)
            wpos = np.tile(np.tile(np.arange(ww), hh), t)
            base = cur[0]
            pos[0, i : i + n] = base + tpos
            pos[1, i : i + n] = base + hpos
            pos[2, i : i + n] = base + wpos
            nxt = base + max(t, hh, ww)
            cur = [nxt, nxt, nxt]
            img += 1
            i += n
        else:
            pos[:, i] = cur
            cur = [c + 1 for c in cur]
            i += 1
    delta = int(cur[0]) - S
    return pos, delta


def text_forward_mrope(
    params, cfg: ModelConfig, tokens, positions3, *, attn_fn,
    layer_caches=None, carry_caches=None, input_embeds=None,
    seq_positions=None, return_hidden: bool = False,
):
    """The Qwen2-VL text tower: ``models.llama.forward`` rotating q / k
    with M-RoPE by ``positions3 [3, B, S]`` and, optionally, starting from
    precomputed ``input_embeds [B, S, E]`` (the image splice); the
    sections are ``cfg.mrope_sections``.  Attention
    gets ``seq_positions [B, S]`` (default ``arange(S)``): causal masking
    is by sequence index, not by the t stream, so image tokens that share
    a t still attend causally.  The cache protocols and the return value
    are ``forward``'s."""
    B, S = tokens.shape
    if seq_positions is None:
        seq_positions = torch.arange(S, device=tokens.device)[None].expand(
            B, S)
    return forward(params, cfg, tokens, seq_positions, attn_fn=attn_fn,
                   layer_caches=layer_caches, carry_caches=carry_caches,
                   return_hidden=return_hidden, positions3=positions3,
                   input_embeds=input_embeds)


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------


def load_qwen2_vl(model_dir: str, *, device=DEFAULT_DEVICE, dtype=None,
                  quantization=None, stats: Optional[dict] = None) -> tuple:
    """``(text_cfg, vision_cfg, params)`` of an HF Qwen2-VL checkpoint,
    ``params["visual"]`` holding the vision tower, both towers streamed
    onto ``device`` by ``models.loader`` (HF names ``model.`` /
    ``model.language_model.`` for the text tower, ``visual.`` /
    ``model.visual.`` for the vision tower).  ``quantization="int8"``
    quantizes the text tower as it lands; the vision tower keeps the
    checkpoint's dtype, as the reference serves it."""
    from helix_tpu_torch.models.loader import load_params, read_hf_config

    hf = read_hf_config(model_dir)
    vcfg = VisionConfig.from_hf(hf["vision_config"])
    tcfg, params = load_params(model_dir, device=device, dtype=dtype,
                               quantization=quantization, stats=stats,
                               vision=vcfg)
    return tcfg, vcfg, params

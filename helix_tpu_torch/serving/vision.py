"""Image preprocessing and the vision runner of the VL serving path.

Port of ``helix_tpu/serving/vision.py``: decode ``image_url`` content
parts (data URLs, base64 or raw bytes), smart-resize to patch-grid
multiples, normalise, and extract patch rows in the merge-block order the
vision tower and its rotary ids expect (HF's Qwen2VLImageProcessor
numerics); ``VisionRunner.prepare`` turns chat messages into the engine's
``Request`` fields, the tower run on its device.

The reference decodes and resizes through PIL.  The port carries its own,
byte for byte what ``np.asarray(Image.open(...).convert("RGB"))`` and
``Image.resize((w, h), Image.BICUBIC)`` give:

- ``decode_png``: PNG on ``zlib`` and numpy; 8-bit gray, RGB, palette,
  gray+alpha and RGBA, 1/2/4-bit gray and palette, every scanline
  filter.  Alpha is dropped (not composited), gray is replicated, a
  palette index past the palette reads black.
- ``resize_bicubic``: PIL's separable two-pass 8-bit resample (a = -0.5,
  the support widened by the scale on a downscale, coefficients in fixed
  point with 22 fraction bits, a rounded and clipped uint8 between the
  passes, the horizontal pass first).

Any other input (JPEG, GIF, WebP, interlaced or 16-bit PNG) raises
``ValueError`` naming the format and ROADMAP A17c; the server answers it
with the reference's ``400 image processing failed: ...``.
"""

from __future__ import annotations

import base64
import dataclasses
import math
import struct
import zlib
from typing import Optional

import numpy as np
import torch

# OpenAI-CLIP normalisation constants (Qwen2-VL's image_mean/image_std)
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
MAX_PIXELS = 14 * 14 * 4 * 1280

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type) -> channels; the bit depths the decoder takes per type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
# magic prefixes of the formats the reference opens through PIL
_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
            (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))
# PIL's fixed-point resample (Resample.c): 32 - 8 - 2 fraction bits
_PRECISION_BITS = 22


def _unsupported(what: str) -> ValueError:
    return ValueError(f"{what} is not decoded yet: PNG (8-bit and below, "
                      "not interlaced) is; JPEG and the other formats PIL "
                      "opens are ROADMAP A17c")


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = 56 * 56,
    max_pixels: int = MAX_PIXELS,
) -> tuple:
    """Target (h, w): multiples of ``factor`` with area in bounds, aspect
    ratio approximately preserved (HF qwen2_vl smart_resize; Python's
    ``round``, half to even)."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absurd aspect ratio")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return int(h_bar), int(w_bar)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth) of ``height`` scanlines of ``stride`` bytes; ``bpp`` bytes per
    complete pixel (at least 1).  Without Average or Paeth rows each row
    is one vector step (Sub a running sum); with them the whole image is
    decoded along anti-diagonals of pixels, every pixel of a diagonal at
    once: its left, upper and upper-left neighbours lie on the two
    diagonals before it, whatever filter each row uses."""
    need = height * (stride + 1)
    if len(raw) < need:
        raise ValueError(f"PNG image data is truncated ({len(raw)} of "
                         f"{need} bytes)")
    rows = np.frombuffer(raw, np.uint8, need).reshape(height, stride + 1)
    ftype = rows[:, 0].astype(np.int64)
    if (ftype > 4).any():
        y = int(np.argmax(ftype > 4))
        raise ValueError(f"PNG scanline {y} has filter type {ftype[y]}")
    data = rows[:, 1:].astype(np.int64)
    if not np.isin(ftype, (3, 4)).any():
        out = np.zeros((height, stride), np.int64)
        prev = np.zeros(stride, np.int64)
        for y in range(height):
            cur = data[y]
            if ftype[y] == 1:
                pad = (-stride) % bpp
                cur = np.cumsum(np.concatenate([cur, np.zeros(pad, np.int64)])
                                .reshape(-1, bpp), axis=0).reshape(-1)[:stride]
            elif ftype[y] == 2:
                cur = cur + prev
            out[y] = prev = cur & 0xFF
        return out.astype(np.uint8)
    # pixels of bpp bytes, the row padded to whole pixels, stored skewed:
    # pixel (y, x) of diagonal d = x + y at S[y + 1, d + 2], so each
    # diagonal's neighbours are contiguous slices; row 0 and the columns
    # left of each row stay zero (the filters' out-of-image bytes)
    width = -(-stride // bpp)
    cells = np.zeros((height, width * bpp), np.int64)
    cells[:, :stride] = data
    cells = cells.reshape(height, width, bpp)
    n_diag = height + width - 1
    skew = np.zeros((height, n_diag, bpp), np.int16)
    ys = np.arange(height)[:, None]
    skew[ys, ys + np.arange(width)[None]] = cells
    S = np.zeros((height + 1, n_diag + 2, bpp), np.int16)
    # per filter type: the rows' mask and a running count (is the type
    # on this diagonal's rows at all?)
    masks = [(ftype == k)[:, None] for k in range(5)]
    counts = [np.concatenate([[0], np.cumsum(m[:, 0])]) for m in masks]
    for t in range(n_diag):
        y0, y1 = max(0, t - width + 1), min(height, t + 1)
        a = S[y0 + 1:y1 + 1, t + 1]
        b = S[y0:y1, t + 1]
        c = S[y0:y1, t]
        pred = np.zeros_like(a)
        for k in range(1, 5):
            if counts[k][y1] == counts[k][y0]:
                continue
            if k == 1:
                pk = a
            elif k == 2:
                pk = b
            elif k == 3:
                pk = (a + b) >> 1
            else:
                pa, pb = np.abs(b - c), np.abs(a - c)
                pc = np.abs(a + b - 2 * c)
                pk = np.where((pa <= pb) & (pa <= pc), a,
                              np.where(pb <= pc, b, c))
            pred = np.where(masks[k][y0:y1], pk, pred)
        S[y0 + 1:y1 + 1, t + 2] = (skew[y0:y1, t] + pred) & 0xFF
    out = S[1 + ys, 2 + ys + np.arange(width)[None]]
    return out.reshape(height, -1)[:, :stride].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> RGB uint8 ``[H, W, 3]``, equal to PIL's
    ``np.asarray(Image.open(...).convert("RGB"))`` on every input it
    takes; raises ``ValueError`` on anything else."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    at, ihdr, palette, idat = 8, None, None, []
    while at + 8 <= len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        ctype = data[at + 4:at + 8]
        body = data[at + 8:at + 8 + n]
        if len(body) < n:
            raise ValueError(f"PNG chunk {ctype!r} is truncated")
        at += 12 + n
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG has no IHDR or no IDAT chunk")
    width, height, depth, color, _comp, _filt, interlace = ihdr
    if color not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"PNG colour type {color} at bit depth {depth} "
                         "is not valid")
    if depth == 16:
        raise _unsupported("16-bit PNG")
    if interlace:
        raise _unsupported("interlaced (Adam7) PNG")
    if depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"PNG colour type {color} at bit depth {depth} "
                         "is not valid")
    if width == 0 or height == 0:
        raise ValueError("PNG has an empty image")
    ch = _PNG_CHANNELS[color]
    stride = (width * ch * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride,
                     max(1, ch * depth // 8))
    if depth < 8:
        # MSB-first packed samples, each row padded to a byte
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1, dtype=np.uint8)
        samples = (bits * weights).sum(axis=-1, dtype=np.uint8)[:, :width]
        if color == 0:
            # PIL: "1" is 0 / 255, "L;2" scales by 0x55, "L;4" by 0x11
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
        pix = samples[..., None]
    else:
        pix = rows.reshape(height, width, ch)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[pix[..., 0]]
    if color in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pix[..., :3])


def decode_image(source) -> np.ndarray:
    """data URL / base64 string / raw bytes -> RGB uint8 [H, W, 3]."""
    if isinstance(source, str):
        if source.startswith("data:"):
            _, b64 = source.split(",", 1)
            raw = base64.b64decode(b64)
        else:
            raw = base64.b64decode(source)
    else:
        raw = bytes(source)
    if raw.startswith(PNG_SIGNATURE):
        return decode_png(raw)
    if raw[8:12] == b"WEBP" and raw.startswith(b"RIFF"):
        raise _unsupported("WebP")
    for magic, name in _FORMATS:
        if raw.startswith(magic):
            raise _unsupported(name)
    raise ValueError("cannot identify image file: not a PNG, and the other "
                     "formats PIL opens are ROADMAP A17c")


# ---------------------------------------------------------------------------
# PIL's bicubic resample
# ---------------------------------------------------------------------------


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int) -> tuple:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bicubic filter (support 2): ``(xmin [out], kk [out, ksize] int64)``,
    kk zero past each output's window."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero; clamped to the image
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)[None, :]
    live = x < xmax[:, None]
    ss = 1.0 / filterscale
    w = np.where(live, _bicubic((x + xmin[:, None] - center[:, None] + 0.5)
                                * ss), 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    one = float(1 << _PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, kk.astype(np.int64)


def _resample_axis(img, out_size: int, axis: int):
    """One pass of the separable resample along ``axis`` (0 rows, 1
    columns) of an ``[H, W, C]`` int32 CPU tensor holding uint8 values,
    rounded and clipped to uint8 values as PIL's ``clip8``: int32 sums
    of value x coefficient products, as PIL's (no overflow: |sum| <= 255
    x 1.3 x 2**22)."""
    xmin, kk = _coeffs(img.shape[axis], out_size)
    last = img.shape[axis] - 1
    shape = [1, 1, 1]
    shape[axis] = out_size
    out_shape = list(img.shape)
    out_shape[axis] = out_size
    acc = torch.full(out_shape, 1 << (_PRECISION_BITS - 1),
                     dtype=torch.int32)
    for j in range(kk.shape[1]):
        idx = torch.from_numpy(np.minimum(xmin + j, last))
        k = torch.from_numpy(kk[:, j].astype(np.int32)).reshape(shape)
        acc.add_(img.index_select(axis, idx).mul_(k))
    return acc.clamp_(0, (1 << (_PRECISION_BITS + 8)) - 1).bitwise_right_shift_(
        _PRECISION_BITS)


def resize_bicubic(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(image).resize((width, height), Image.BICUBIC)``
    of an RGB uint8 ``[H, W, 3]`` array, byte for byte: the horizontal
    pass first, each pass skipped where that size does not change (the
    integer passes run on torch's CPU threads)."""
    img = torch.from_numpy(np.ascontiguousarray(image, np.uint8)).to(
        torch.int32)
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img.to(torch.uint8).numpy()


def patchify(
    image: np.ndarray,           # [H, W, 3] uint8/float
    patch_size: int = 14,
    merge_size: int = 2,
    temporal_patch_size: int = 2,
    min_pixels: int = 56 * 56,
    max_pixels: int = MAX_PIXELS,
) -> tuple:
    """-> (patches [N, C*Tp*P*P], grid (1, h, w)) in the processor's
    merge-block order (the temporal dim filled by frame repetition for
    stills, as HF does)."""
    H, W = image.shape[:2]
    factor = patch_size * merge_size
    h2, w2 = smart_resize(H, W, factor, min_pixels, max_pixels)
    img = resize_bicubic(image.astype(np.uint8), w2, h2)
    x = np.asarray(img, np.float32) / 255.0
    x = (x - IMAGE_MEAN) / IMAGE_STD
    x = x.transpose(2, 0, 1)                        # [C, H, W]
    x = np.tile(x[None], (temporal_patch_size, 1, 1, 1))  # [Tp, C, H, W]

    C = x.shape[1]
    gh, gw = h2 // patch_size, w2 // patch_size
    m = merge_size
    P = patch_size
    # [grid_t=1, Tp, C, gh/m, m, P, gw/m, m, P]
    x = x.reshape(1, temporal_patch_size, C, gh // m, m, P, gw // m, m, P)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    patches = x.reshape(gh * gw, C * temporal_patch_size * P * P)
    return patches.astype(np.float32), (1, gh, gw)


# ---------------------------------------------------------------------------
# prompts and the runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VLPrompt:
    input_ids: list
    image_patches: list      # list of np arrays per image
    grid_thw: np.ndarray     # [n_images, 3]
    image_positions: list    # indices of image-pad tokens


def build_vl_prompt(
    messages: list,
    tokenizer,
    *,
    image_pad_id: int,
    vision_start_id: Optional[int] = None,
    vision_end_id: Optional[int] = None,
    merge_size: int = 2,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    max_pixels: int = MAX_PIXELS,
) -> VLPrompt:
    """Chat messages (OpenAI content-parts format) -> token ids with each
    image span expanded to its number of pad tokens, plus per-image patch
    rows."""
    ids: list = []
    patches_all: list = []
    grids: list = []
    img_pos: list = []

    def add_image(source):
        patches, (t, gh, gw) = patchify(
            decode_image(source),
            patch_size=patch_size,
            merge_size=merge_size,
            temporal_patch_size=temporal_patch_size,
            max_pixels=max_pixels,
        )
        n_tokens = t * (gh // merge_size) * (gw // merge_size)
        if vision_start_id is not None:
            ids.append(vision_start_id)
        img_pos.extend(range(len(ids), len(ids) + n_tokens))
        ids.extend([image_pad_id] * n_tokens)
        if vision_end_id is not None:
            ids.append(vision_end_id)
        patches_all.append(patches)
        grids.append((t, gh, gw))

    for msg in messages:
        content = msg.get("content", "")
        ids.extend(tokenizer.encode(f"{msg['role']}: "))
        if isinstance(content, str):
            ids.extend(tokenizer.encode(content))
        else:
            for part in content:
                ptype = part.get("type")
                if ptype == "text":
                    ids.extend(tokenizer.encode(part.get("text", "")))
                elif ptype in ("image_url", "image"):
                    url = (
                        part.get("image_url", {}).get("url")
                        if ptype == "image_url"
                        else part.get("image")
                    )
                    add_image(url)
        ids.extend(tokenizer.encode("\n"))
    ids.extend(tokenizer.encode("assistant: "))
    return VLPrompt(
        input_ids=ids,
        image_patches=patches_all,
        grid_thw=np.asarray(grids) if grids else np.zeros((0, 3), np.int64),
        image_positions=img_pos,
    )


class VisionRunner:
    """The vision tower and its special-token ids: turns chat messages
    with image parts into the engine's multimodal ``Request`` fields.
    ``prepare`` runs on the calling thread (an HTTP handler, never the
    engine's) and queues the tower on the tower's device, on the stream
    the engine thread also uses; the image embeddings it returns stay
    there."""

    def __init__(
        self,
        vcfg,
        vparams,
        *,
        image_pad_id: int,
        vision_start_id: Optional[int] = None,
        vision_end_id: Optional[int] = None,
        max_pixels: int = MAX_PIXELS,
    ):
        self.vcfg = vcfg
        self.vparams = vparams
        self.image_pad_id = image_pad_id
        self.vision_start_id = vision_start_id
        self.vision_end_id = vision_end_id
        self.max_pixels = max_pixels

    @property
    def device(self):
        return self.vparams["patch_embed"]["weight"].device

    def prepare(self, messages: list, tokenizer) -> dict:
        """-> kwargs for ``engine.Request`` (prompt_tokens + multimodal)."""
        from helix_tpu_torch.models.qwen2_vl import (
            mrope_positions,
            vision_forward,
        )

        p = build_vl_prompt(
            messages,
            tokenizer,
            image_pad_id=self.image_pad_id,
            vision_start_id=self.vision_start_id,
            vision_end_id=self.vision_end_id,
            merge_size=self.vcfg.spatial_merge_size,
            patch_size=self.vcfg.patch_size,
            temporal_patch_size=self.vcfg.temporal_patch_size,
            max_pixels=self.max_pixels,
        )
        image_embeds = None
        if len(p.image_patches):
            patches = torch.from_numpy(
                np.concatenate(p.image_patches, axis=0)).to(self.device)
            with torch.no_grad():
                image_embeds = vision_forward(self.vparams, self.vcfg,
                                              patches, p.grid_thw)
        pos3, delta = mrope_positions(
            p.input_ids,
            p.grid_thw if len(p.grid_thw) else None,
            self.image_pad_id,
            merge=self.vcfg.spatial_merge_size,
        )
        return dict(
            prompt_tokens=p.input_ids,
            image_embeds=image_embeds,
            image_positions=p.image_positions,
            positions3=pos3,
            mrope_delta=delta,
        )

"""A small PNG writer on ``zlib`` (test and smoke scaffolding, not served
code): the images a VL request carries are made from a seed and written
with it, so neither the tests nor the card's machine need an image
library.

``encode_png(pixels, color_type, bit_depth, palette, filters)`` writes
every colour type (0 gray, 2 RGB, 3 palette, 4 gray+alpha, 6 RGBA) at
the bit depths PNG allows for it below 16, MSB-first packing for 1/2/4
bits, and each scanline with the next filter of ``filters`` in turn (0
None, 1 Sub, 2 Up, 3 Average, 4 Paeth), so a decoder meets all five.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter(line: np.ndarray, prev: np.ndarray, ftype: int,
            bpp: int) -> np.ndarray:
    x = line.astype(np.int32)
    b = prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(pixels: np.ndarray, color_type: int = 2, bit_depth: int = 8,
               palette=None, filters=(0, 1, 2, 3, 4)) -> bytes:
    """``pixels``: ``[H, W, channels]`` (or ``[H, W]`` for one channel)
    integer samples below ``2 ** bit_depth``; ``palette``: ``[n, 3]``
    uint8 for colour type 3."""
    px = np.asarray(pixels)
    if px.ndim == 2:
        px = px[..., None]
    h, w, ch = px.shape
    if ch != CHANNELS[color_type]:
        raise ValueError(f"colour type {color_type} has {CHANNELS[color_type]}"
                         f" channels, pixels have {ch}")
    if int(px.max(initial=0)) >= 1 << bit_depth:
        raise ValueError(f"a sample does not fit {bit_depth} bits")
    px = px.astype(np.uint8)
    if bit_depth < 8:
        bits = ((px[..., 0, None] >> np.arange(bit_depth - 1, -1, -1))
                & 1).astype(np.uint8).reshape(h, w * bit_depth)
        rows = np.packbits(bits, axis=1)
    else:
        rows = px.reshape(h, w * ch)
    bpp = max(1, ch * bit_depth // 8)
    out, prev = [], np.zeros(rows.shape[1], np.uint8)
    for y in range(h):
        ftype = filters[y % len(filters)]
        out.append(bytes([ftype]) + _filter(rows[y], prev, ftype,
                                            bpp).tobytes())
        prev = rows[y]
    body = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth,
                                        color_type, 0, 0, 0))]
    if color_type == 3:
        body.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    body.append(_chunk(b"IDAT", zlib.compress(b"".join(out), 6)))
    body.append(_chunk(b"IEND", b""))
    return SIGNATURE + b"".join(body)


def random_png(rng: np.random.Generator, height: int, width: int) -> bytes:
    """A seeded RGB image (smooth gradients under noise, so a resize has
    structure to keep) as an 8-bit RGB PNG."""
    yy, xx = np.mgrid[0:height, 0:width]
    base = np.stack([xx * 255 // max(width - 1, 1),
                     yy * 255 // max(height - 1, 1),
                     (xx + yy) * 255 // max(width + height - 2, 1)], -1)
    noise = rng.integers(-40, 41, size=(height, width, 3))
    return encode_png(np.clip(base + noise, 0, 255).astype(np.uint8), 2, 8)

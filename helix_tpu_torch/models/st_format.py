"""A reader of the safetensors checkpoint format, on the port's own code.

The counterpart of ``_open_shards`` in the reference loader
(``helix_tpu/models/loader.py``), without the ``safetensors`` package.  A
file is an 8-byte little-endian header length ``N``, ``N`` bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``__metadata__``), then the raw buffers, whose offsets count from
the end of the header.

Each file is mapped with ``mmap`` and a tensor is a ``torch.frombuffer``
view at its offset, so nothing is read until the caller touches the
bytes.  The header is checked before any view is made: the buffers must
tile the data section exactly, with no overlap, no gap and nothing past
the end of the file, so a truncated file raises and is never read as
zeros.

A directory with ``model.safetensors.index.json`` reads the files its
``weight_map`` names; otherwise every ``*.safetensors`` file, in sorted
order.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct

import torch

INDEX_NAME = "model.safetensors.index.json"
# safetensors' own bound on the JSON header
MAX_HEADER_BYTES = 100_000_000
# format name -> (dtype the bytes are viewed as, dtype of the tensor):
# bfloat16 is read through an int16 view
DTYPES = {
    "BF16": (torch.int16, torch.bfloat16),
    "F16": (torch.float16, torch.float16),
    "F32": (torch.float32, torch.float32),
    "I8": (torch.int8, torch.int8),
    "I32": (torch.int32, torch.int32),
    "I64": (torch.int64, torch.int64),
    "U8": (torch.uint8, torch.uint8),
    "BOOL": (torch.bool, torch.bool),
}
FORMAT_NAMES = {t: name for name, (_raw, t) in DTYPES.items()}


class FormatError(ValueError):
    """A file that is not a well-formed safetensors file."""


def read_header(path: str) -> tuple:
    """``(entries, data_start)`` of one file: ``entries`` maps each tensor
    name to ``(dtype name, shape, begin, end)`` with offsets from the
    start of the file; raises ``FormatError`` for a header the format
    does not allow."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise FormatError(f"{path}: {size} bytes, shorter than the "
                              "8-byte header length")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER_BYTES or 8 + n > size:
            raise FormatError(f"{path}: header length {n} does not fit in "
                              f"the file's {size} bytes")
        raw = f.read(n)
    try:
        header = json.loads(raw)
    except ValueError as e:
        raise FormatError(f"{path}: header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise FormatError(f"{path}: header is not a JSON object")
    data_start = 8 + n
    entries, spans = {}, []
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype, shape = meta["dtype"], [int(d) for d in meta["shape"]]
            begin, end = (int(x) for x in meta["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise FormatError(f"{path}: {name}: malformed entry "
                              f"{meta!r}") from None
        if dtype not in DTYPES:
            raise FormatError(f"{path}: {name}: dtype {dtype!r} is not "
                              f"read (supported: {', '.join(DTYPES)})")
        if any(d < 0 for d in shape):
            raise FormatError(f"{path}: {name}: negative shape {shape}")
        want = math.prod(shape) * DTYPES[dtype][1].itemsize
        if end - begin != want or begin < 0:
            raise FormatError(f"{path}: {name}: offsets [{begin}, {end}) "
                              f"hold {end - begin} bytes, its dtype and "
                              f"shape {shape} need {want}")
        entries[name] = (dtype, tuple(shape), data_start + begin,
                         data_start + end)
        spans.append((begin, end, name))
    at = 0
    for begin, end, name in sorted(spans):
        if begin != at:
            what = "overlaps the previous" if begin < at else "leaves a gap"
            raise FormatError(f"{path}: {name} at byte {begin} {what} "
                              f"(the previous buffer ends at {at})")
        at = end
    if data_start + at != size:
        raise FormatError(
            f"{path}: the buffers end at byte {data_start + at} but the file "
            f"has {size} (truncated or trailing bytes)")
    return entries, data_start


class SafetensorsDir:
    """The tensors of one checkpoint directory, by name, as zero-copy CPU
    views of the mapped files.  Views are read-only in intent (the maps
    are private: a write never reaches the file) and must be dropped
    before ``close``."""

    def __init__(self, model_dir: str):
        index_path = os.path.join(model_dir, INDEX_NAME)
        if os.path.exists(index_path):
            with open(index_path) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted(set(weight_map.values()))
        else:
            weight_map = None
            files = sorted(f for f in os.listdir(model_dir)
                           if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"{model_dir}: no *.safetensors files")
        self._maps: dict = {}
        self._where: dict = {}
        # every header is checked before any file is mapped
        headers = {}
        for fname in files:
            path = os.path.join(model_dir, fname)
            headers[fname] = read_header(path)[0]
        for fname, entries in headers.items():
            for name, entry in entries.items():
                if weight_map is not None and weight_map.get(name) != fname:
                    continue
                if name in self._where:
                    raise FormatError(f"{model_dir}: {name} is in both "
                                      f"{self._where[name][0]} and {fname}")
                self._where[name] = (fname, entry)
        if weight_map is not None:
            missing = sorted(set(weight_map) - set(self._where))
            if missing:
                raise FormatError(f"{model_dir}: the index names "
                                  f"{missing[:4]} (of {len(missing)}) in "
                                  "files that do not hold them")
        try:
            for fname in files:
                with open(os.path.join(model_dir, fname), "rb") as f:
                    self._maps[fname] = mmap.mmap(f.fileno(), 0,
                                                  access=mmap.ACCESS_COPY)
        except BaseException:
            self.close()
            raise

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def names(self) -> list:
        return list(self._where)

    def entry(self, name: str) -> tuple:
        """``(file name, dtype name, shape, begin, end)`` of one tensor,
        offsets from the start of its file."""
        fname, (dtype, shape, begin, end) = self._where[name]
        return fname, dtype, shape, begin, end

    def shape(self, name: str) -> tuple:
        return self._where[name][1][1]

    def get(self, name: str) -> torch.Tensor:
        """The tensor as a CPU view of the mapped bytes (no copy)."""
        fname, (dtype, shape, begin, end) = self._where[name]
        raw, out = DTYPES[dtype]
        n = math.prod(shape)
        if n == 0:
            return torch.empty(shape, dtype=out)
        t = torch.frombuffer(self._maps[fname], dtype=raw, count=n,
                             offset=begin)
        return t.view(out).view(shape)

    def close(self) -> None:
        for m in self._maps.values():
            try:
                m.close()
            except BufferError:
                # a view is still alive (an exception's frames may hold
                # one): the map goes when its last view is collected
                pass
        self._maps.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes plain C entry points (no PyTorch headers)
and is compiled with ``nvcc`` for ``sm_90a`` into its own shared library
under ``build/helix_tpu_torch/`` at first use, then loaded with
``ctypes``.  A library's file name carries a hash of its source and
flags, so an edited source rebuilds and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per stale source, all at once.

Every wrapper owns one :class:`Kernel`; ``Kernel.launches`` is a plain
counter the wrapper bumps where it launches the kernel, and nowhere else.
A second entry point of the same library (another form of the kernel)
counts its launches apart on a :class:`KernelForm`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "helix_tpu_torch"
# --split-compile=0: optimise a source's kernels on every core (K1's one
# file holds 60 instantiations)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "--split-compile=0",
)

_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels build from source at first use"
    )


class Kernel:
    """One CUDA source file, its built library and its launch counter."""

    def __init__(self, name: str, source: str):
        self.name = name
        self.source = CSRC_DIR / source
        self.launches = 0
        self.build_log = ""         # nvcc's ptxas report
        self._lib = None

    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:12]}.so"

    def symbol(self, name: str, argtypes: list):
        """A C entry point of this kernel's library (built on first use)."""
        if self._lib is None:
            build_all([self])
        fn = getattr(self._lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn


class KernelForm:
    """Another form of a :class:`Kernel`: a second entry point of the same
    library, with its own launch count."""

    def __init__(self, name: str, kernel: Kernel):
        self.name = name
        self.kernel = kernel
        self.launches = 0

    def symbol(self, name: str, argtypes: list):
        return self.kernel.symbol(name, argtypes)


def build_all(kernels) -> float:
    """Build every kernel whose library is missing, one ``nvcc`` process
    per source started together; load them all.  Returns the wall
    seconds spent compiling (0.0 when everything was already built)."""
    with _BUILD_LOCK:
        todo = [k for k in kernels if k._lib is None]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        t0 = time.monotonic()
        for k in todo:
            out = k.lib_path()
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
            procs.append((k, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for k, out, tmp, p in procs:
            log, _ = p.communicate()
            k.build_log = log
            if p.returncode != 0:
                failed.append(f"{k.source.name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for k in todo:
            k._lib = ctypes.CDLL(str(k.lib_path()))
        return time.monotonic() - t0 if procs else 0.0

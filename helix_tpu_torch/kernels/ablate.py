"""What bounds K1 on the card: its split kernel built three ways.

    python -m helix_tpu_torch.kernels.ablate      # one NVIDIA GPU

``full`` is ``csrc/ragged_paged_attention.cu`` as shipped; ``staging`` has
the arithmetic of each chunk removed (only the cp.async page stream, the
barriers and the merge remain); ``compute`` has the copies removed (the
arithmetic runs on whatever the ring holds).  Each is built with the same
``nvcc`` flags into ``build/helix_tpu_torch/ablate/`` and timed with
``torch.profiler`` (device time of the split kernel per call) at the
shapes ``chip_smoke.py`` times K1 with: Llama-3-8B attention widths, a
bf16 pool of 4096 pages of 16 tokens, 8 decode rows of history 1000-4000,
and the mixed step (a 256-token row with history 512 beside 7 decode
rows).  If ``full`` is near ``compute`` and far above ``staging``, the
kernel is bound by its arithmetic, not by the bytes it reads.  The
outputs of the cut builds are meaningless; only their times are read.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from helix_tpu_torch.kernels import build
from helix_tpu_torch.ops import paged_kernel as pk

CUTS = {
    "staging": ("    // scores: lane = key",
                "    if (true) continue;   // cut: no arithmetic\n"
                "    // scores: lane = key"),
    "compute": ("      cp_async16(dst, src, ok ? 16 : 0);",
                "      (void)dst; (void)src;   // cut: no copies"),
}


def _build(out_dir) -> dict:
    src = (build.CSRC_DIR / "ragged_paged_attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("full", *CUTS):
        text = src
        if name in CUTS:
            old, new = CUTS[name]
            if old not in text:
                raise RuntimeError(f"cut {name!r} no longer matches the source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC_DIR}", "-o",
             str(so), str(cu)], stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _case(q_lens, hists, pool, rng):
    H, KVH, D = 32, 8, 128
    N, maxP = pool[0].shape[1], 256
    q_lens = np.asarray(q_lens, np.int32)
    t0 = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    R, T = len(q_lens), int(q_lens.sum())
    tables = rng.permutation(np.arange(1, N))[: R * maxP].reshape(R, maxP)
    meta = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).cuda()
            for x in (t0, q_lens, np.asarray(hists), tables)]
    q = torch.randn((T, H, D), device="cuda").bfloat16()
    kv = torch.randn((T, KVH, D), device="cuda").bfloat16()
    return (q, kv, kv.clone(), *pool, 1, *meta)


def _split_ms(fn, n=10) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "ragged_split_kernel" in e.key) / n / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs an NVIDIA GPU")
    libs = _build(build.BUILD_DIR / "ablate")
    rng = np.random.default_rng(1)
    pool = [torch.randn((2, 4096, 16, 8, 128), device="cuda").bfloat16()
            for _ in range(2)]
    cases = {
        "decode 8 rows, hist 1000-4000":
            ([1] * 8, rng.integers(1000, 4000, size=8)),
        "mixed 256-token row (hist 512) + 7 decode rows":
            ([256] + [1] * 7, [512] + list(rng.integers(1000, 4000, size=7))),
    }
    print(torch.cuda.get_device_name(0))
    for label, (q_lens, hists) in cases.items():
        args = _case(q_lens, hists, pool, rng)
        times = {}
        for name, lib in libs.items():
            pk.K1._lib = lib
            times[name] = _split_ms(lambda: pk.ragged_paged_attention(*args))
        print(f"{label}: split kernel ms " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

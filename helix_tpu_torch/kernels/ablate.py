"""What bounds a kernel on the card: its source built with parts cut out.

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

    python -m helix_tpu_torch.kernels.ablate k2b  # K2-backward's bf16 form

``k2b`` builds ``csrc/flash_attention_bwd.cu`` five ways: ``full``;
``no_math`` without P's exp, the soft cap and the per-element masks (the
fragments pass on as they are); ``no_mma`` without the five ``wgmma`` products
(their commits and waits stay); ``no_copies`` without the cp.async tile
copies; ``loop_off`` without the tile loops (the prologue, the Delta
pre-pass and the epilogue remain).  Each kernel's device time per call is
read with ``torch.profiler`` at the training shape ``chip_smoke.py``
times it at: B 8 x S 1024 rows packed from 100-500-token chats, H 32 /
KVH 8, D 128, bf16.
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


K2B_CUTS = {
    "no_math": [
        ("        prob(sh, s[i], (e & 2) ? lse1 : lse0, pcs);",
         "        pcs = s[i];   // cut: no P math"),
        ("        const float p = prob(sh, s[i], (e & 1) ? l1 : l0, pcs);",
         "        const float p = s[i];   // cut: no P math\n"
         "        pcs = p;"),
        ("      if (!full) {", "      if (false) {   // cut: no masks")],
    "no_mma": [("wgmma_rows_dot<DP>(", "if (false) wgmma_rows_dot<DP>("),
               ("wgmma_acc_rows<DP>(", "if (false) wgmma_acc_rows<DP>(")],
    "no_copies": [
        ("    cp_async16(tile + sw128_offset(row, c, kTile), p, ok ? 16 : 0);",
         "    (void)tile; (void)p; (void)ok;   // cut: no copies")],
    "loop_off": [("  while (j < nkt) {", "  while (false && j < nkt) {"),
                 ("  while (g < G) {", "  while (false && g < G) {")],
}


def _build(out_dir, source="ragged_paged_attention.cu", cuts=None) -> dict:
    """Each variant of ``source`` (``full`` and one per cut, a cut being
    a list of (old, new) replacements), built at once."""
    cuts = cuts if cuts is not None else {
        k: [v] for k, v in CUTS.items()}
    src = (build.CSRC_DIR / source).read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("full", *cuts):
        text = src
        for old, new in cuts.get(name, ()):
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


def _kernel_ms(fn, names, n=10) -> dict:
    """Device ms per call of each kernel whose name holds one of
    ``names``, over n calls after one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {name: sum(e.self_device_time_total for e in prof.key_averages()
                      if name in e.key) / n / 1e3 for name in names}


def _split_ms(fn, n=10) -> float:
    return _kernel_ms(fn, ("ragged_split_kernel",), n)["ragged_split_kernel"]


def k2_backward() -> int:
    """K2-backward's bf16 form, full and cut, at the training shape."""
    from helix_tpu_torch.ops import attention as att
    from helix_tpu_torch.training.data import SFTExample, pack_examples

    libs = _build(build.BUILD_DIR / "ablate_k2b", "flash_attention_bwd.cu",
                  K2B_CUTS)
    B, S, H, KVH, D = 8, 1024, 32, 8, 128
    rng = np.random.default_rng(6)
    exs = [SFTExample(input_ids=[1] * int(n), loss_mask=[1] * int(n))
           for n in rng.integers(100, 500, size=4 * B * S // 100)]
    batch = next(pack_examples(exs, B, S, shuffle_seed=0))
    pos = torch.from_numpy(batch.positions).cuda()
    seg = torch.from_numpy(batch.segment_ids).cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, dout = (torch.randn((B, S, H, D), generator=gen, device="cuda")
               .bfloat16() for _ in range(2))
    k, v = (torch.randn((B, S, KVH, D), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    kw = dict(q_positions=pos, kv_positions=pos, q_segment_ids=seg,
              kv_segment_ids=seg)
    out, lse = att.flash_attention_lse(q, k, v, **kw)
    # the (query tile, key tile) pairs the tile map marks: some pair live
    # (visited), every pair live (unmasked); and those a test on min / max
    # position and segment ranges would visit
    visited = full = ranged = 0
    for b in range(B):
        p, g = batch.positions[b], batch.segment_ids[b]
        m = ((p[:, None] >= p[None]) & (g[:, None] == g[None])).reshape(
            S // 64, 64, S // 64, 64)
        visited += int(m.any(axis=(1, 3)).sum())
        full += int(m.all(axis=(1, 3)).sum())
        p, g = p.reshape(-1, 64), g.reshape(-1, 64)
        ranged += int(((p.max(1)[:, None] >= p.min(1)[None])
                       & (g.max(1)[:, None] >= g.min(1)[None])
                       & (g.min(1)[:, None] <= g.max(1)[None])).sum())
    print(f"tile pairs a head: {visited} visited of {B * (S // 64) ** 2} "
          f"({ranged} by ranges), {full} of them unmasked")
    names = ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
             "flash_bwd_delta_kernel", "flash_bwd_tile_map_kernel")
    print(torch.cuda.get_device_name(0))
    for name, lib in libs.items():
        att.K2B._lib = lib
        t = _kernel_ms(lambda: att.flash_attention_backward(
            q, k, v, out, lse, dout, **kw), names)
        print(f"K2-backward {name}: device ms per call " + ", ".join(
            f"{n.split('_kernel')[0]} {v:.4f}" for n, v in t.items())
            + f", total {sum(t.values()):.4f}")
    return 0


def main(argv=None) -> int:
    import sys

    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs an NVIDIA GPU")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["k2b"]:
        return k2_backward()
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

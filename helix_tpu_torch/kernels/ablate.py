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

    python -m helix_tpu_torch.kernels.ablate k1c  # K1's bf16 cold form

``k1c`` builds ``csrc/ragged_paged_attention_cold.cu`` five ways:
``full``; ``no_mma`` without the ``mma.sync`` products (empty asm keeps
their operands live); ``no_copies`` without the key stream's cp.async
copies; ``no_softmax`` without the softmax math (no max, shuffles or
``exp2``: P is the masked score); ``no_widen`` without the int8 codes'
widening to bf16.  Each kernel's device time per call (the pre-pass,
the main kernel, the merge) is read with ``torch.profiler`` on phase
3d's tiered layout of ``chip_smoke.py`` (4 decode and 4 verify rows of 5
at histories 6000-8000 with ~5000 keys each demoted into 64-key chunks,
8 resident decode rows, H 32 / KVH 8, D 128, 16-token pages), bf16 and
int8 pools.
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


K1C_CUTS = {
    "no_mma": [(
        '"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, '
        '{%0, %1, %2, %3};\\n"',
        '""   // cut: no products')],
    "no_copies": [
        ("          cp_async16(stg + j * D + pc * 16, ksrc, live ? 16 : 0);",
         "          (void)ksrc;   // cut: no copies"),
        ("          cp_async16(stg + L.raw_v + j * D + pc * 16, vsrc, "
         "live ? 16 : 0);", "          (void)vsrc;"),
        ("          cp_async16(stg + TL::off(j, pc), ksrc, live ? 16 : 0);",
         "          (void)ksrc;   // cut: no copies"),
        ("          cp_async16(stg + (kRing ? L.raw_v : L.tile) + "
         "TL::off(j, pc),\n                     vsrc, live ? 16 : 0);",
         "          (void)vsrc;")],
    "no_softmax": [
        ("      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));\n"
         "      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));\n", ""),
        ("      const float alpha = fast_exp2(st.m[mt][h] - mn);",
         "      const float alpha = 1.f;   // cut: no softmax math"),
        ("          p[j] = fast_exp2(x[nt][j] - mn);",
         "          p[j] = x[nt][j];")],
    "no_widen": [("        widen<D>(stg, sm + L.cbuf, L);",
                  "        (void)0;   // cut: no widening")],
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


def _cold_case(rng, int8: bool):
    """Phase 3d's tiered call (``chip_smoke._k1_cold_case``'s layout)."""
    from helix_tpu_torch.ops.quant import quantize_kv

    H, KVH, D, P, N, maxP, pages = 32, 8, 128, 16, 8192, 512, 4
    q_lens = np.array([1] * 4 + [5] * 4 + [1] * 8, np.int32)
    hists = np.concatenate([rng.integers(6000, 8000, 8),
                            rng.integers(1000, 8000, 8)]).astype(np.int32)
    R, T = len(q_lens), int(q_lens.sum())
    t0 = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    walked = -(-(hists + q_lens) // P)
    perm = rng.permutation(np.arange(1, N))
    tables = np.zeros((R, maxP), np.int32)
    for r, (n, a) in enumerate(zip(walked, np.cumsum(walked) - walked)):
        tables[r, :n] = perm[a:a + n]
    lo = np.zeros(R, np.int32)
    hi = np.zeros(R, np.int32)
    lo[:8] = rng.integers(8, 32, 8) * P
    hi[:8] = lo[:8] + (5000 // P) * P
    owners, lens, idx = [], [], []
    for r in range(8):
        for c0 in range(lo[r] // P, hi[r] // P, pages):
            pg = list(tables[r, c0:min(c0 + pages, hi[r] // P)])
            owners.append(r)
            lens.append(len(pg) * P)
            idx.append(pg + [0] * (pages - len(pg)))
        tables[r, lo[r] // P:hi[r] // P] = 0
    owners.append(-1)
    lens.append(pages * P)
    idx.append(list(perm[-pages:]))
    gather = torch.from_numpy(np.asarray(idx, np.int64)).cuda()
    shape = (1, N, P, KVH, D)
    pools = [torch.randn(shape, device="cuda") for _ in range(2)]
    kw = {}
    if int8:
        (kp, ks), (vp, vs) = (quantize_kv(x) for x in pools)
        kw = dict(k_scale=ks, v_scale=vs)
        pools = [kp, vp]
    else:
        pools = [x.bfloat16() for x in pools]

    def slab(pool):
        return pool[:, gather].reshape(
            (1, len(owners), pages * P) + tuple(pool.shape[3:])).contiguous()

    def up(x):
        return torch.from_numpy(np.asarray(x, np.int32)).cuda()

    cold = dict(span_lo=up(lo), span_hi=up(hi), cold_k=slab(pools[0]),
                cold_v=slab(pools[1]), cold_row=up(owners),
                cold_len=up(lens))
    if int8:
        cold.update(cold_k_scale=slab(kw["k_scale"]),
                    cold_v_scale=slab(kw["v_scale"]))
    q = torch.randn((T, H, D), device="cuda").bfloat16()
    kv = torch.randn((T, KVH, D), device="cuda").bfloat16()
    return ((q, kv, kv.clone(), *pools, 0, up(t0), up(q_lens), up(hists),
             up(tables)), {**kw, **cold})


def k1_cold() -> int:
    """K1's bf16 cold form, full and cut, on phase 3d's layout."""
    libs = _build(build.BUILD_DIR / "ablate_k1c",
                  "ragged_paged_attention_cold.cu", K1C_CUTS)
    rng = np.random.default_rng(13)
    names = ("cold_worklist_kernel", "cold_attend_kernel",
             "cold_merge_kernel")
    print(torch.cuda.get_device_name(0))
    for int8 in (False, True):
        args, kw = _cold_case(rng, int8)
        for name, lib in libs.items():
            if name == "no_widen" and not int8:
                continue
            pk.K1_COLD._lib = lib
            t = _kernel_ms(lambda: pk.ragged_paged_attention(*args, **kw),
                           names)
            print(f"K1-{'int8-' if int8 else ''}tiered {name}: device ms "
                  "per call " + ", ".join(
                      f"{n.split('_kernel')[0]} {v:.4f}"
                      for n, v in t.items())
                  + f", total {sum(t.values()):.4f}")
        del args, kw
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    import sys

    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs an NVIDIA GPU")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["k2b"]:
        return k2_backward()
    if argv[:1] == ["k1c"]:
        return k1_cold()
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

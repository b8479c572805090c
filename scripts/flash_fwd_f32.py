#!/usr/bin/env python3
"""The fp32 flash-attention forward (`flash_attention_fwd_f32` in
`difashion_tpu_torch/csrc/flash_attention_f32.cu`: tensor cores, 3xTF32)
checked and timed on one CUDA card.

    python3 scripts/flash_fwd_f32.py                  # from the repository root
    python3 scripts/flash_fwd_f32.py --quick          # build, ptxas and SASS report, checks only
    python3 scripts/flash_fwd_f32.py --against DIR    # also time DIR's fp32 forward

It builds the fp32 source and prints each forward instantiation's ptxas
report and, from its SASS, the highest register index, local-memory traffic,
the instruction count and the commonest opcodes. Then, in fp32 with TF32 off
for PyTorch's own products, at the edge shapes of the kernels' tiles (Sq and
Skv one below and one above 64 and 128, d = 4 to 128, 16-byte and 4-byte
copies) and at shapes that pin each route (the wgmma kernel at d = 64 and
40 on aligned views; the mma.sync one at d = 64 on rows 66 floats apart, at
80 and 16): O and the LSE against the plain fp32 forward (per element within
F32_TOL, and relative L2) and against the plain 3xTF32 forward, a second call
bit-identical, and the kernel that ran (by torch.profiler). Without --quick,
also at every attention site of the fp32 sampler's UNet forward (sd2_base,
batch 16, d = 64) and of sd15's (d = 40 and 80), in the projections' [B, S,
H, D] layout: the kernel's time, its 3xTF32 bound and share, the SIMT bound
(the earlier design's) and share, TFLOP/s, F.scaled_dot_product_attention in
fp32 (a yardstick only) and the wrapper's host microseconds per call; totals
per UNet forward. With --against DIR the fp32 `flash_attention` of the
checkout in DIR (built from its own sources) and this tree's are timed at
the same sites the same way, each run a process of its own, in turns: DIR,
this tree, this tree, DIR (`against_ms` and `out_of_process_ms`, the mean of
each pair). One JSON line per shape or site; exits non-zero if a check
fails.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402  (stdlib only at import)
from flash_bwd_f32 import sass_report  # noqa: E402

FWD_KERNELS = ("fwd_tc_kernel", "fwd_wg_kernel")
# (name, B, H, Sq, Skv, d, row width or None): Sq and Skv one below and one
# above the 64-row tiles and the wgmma kernel's 128-row blocks, head dims up
# to 128, d = 17 (4-byte copies); a row width wider than H * d cuts the head
# dim out of wider rows (strides not multiples of 4 floats: the mma.sync
# kernel at d = 64)
EDGE_SHAPES = [("sq63_skv65", 1, 2, 63, 65, 64, None), ("sq65_skv63", 1, 2, 65, 63, 64, None),
               ("sq127_skv129", 1, 2, 127, 129, 64, None),
               ("sq129_skv127", 2, 1, 129, 127, 64, None),
               ("d4", 1, 3, 100, 77, 4, None), ("d20", 2, 1, 130, 90, 20, None),
               ("d36", 1, 2, 100, 77, 36, None), ("d40", 2, 8, 300, 130, 40, None),
               ("d80", 2, 8, 200, 77, 80, None), ("d100", 1, 2, 130, 200, 100, None),
               ("d128", 1, 2, 200, 300, 128, None), ("d17_4byte", 1, 2, 70, 90, 17, None),
               ("d16", 2, 3, 130, 77, 16, None), ("d64_rows66", 2, 3, 200, 77, 64, 66)]
ROUTES = {"d40": "fwd_wg_kernel", "sq127_skv129": "fwd_wg_kernel", "d36": "fwd_wg_kernel",
          "d80": "fwd_tc_kernel", "d16": "fwd_tc_kernel", "d64_rows66": "fwd_tc_kernel",
          "d128": "fwd_tc_kernel", "d17_4byte": "fwd_tc_kernel"}


def inputs(b, h, sq, skv, d, gen, width=None):
    """q, k, v as [B, H, S, d] views of [B, S, H, width] fp32 rows (width d:
    the projections' layout)."""
    import torch

    width = width or d
    return [torch.randn(b, s, h, width, generator=gen, device="cuda")[..., :d].transpose(1, 2)
            for s in (sq, skv, skv)]


def kernels_run(fn):
    """The fp32 forward kernels one call of `fn` runs, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    keys = [evt.key for evt in prof.key_averages()]
    return sorted(name for name in FWD_KERNELS if any(name in k for k in keys))


def sites():
    """(config, name, B, H, Sq, Skv, d, calls per UNet forward): the fp32
    sampler's attentions at the sd2_base widths and sd15's with d <= 128."""
    from difashion_tpu_torch.config import ModelConfig

    out = [("sd2_base",) + s
           for s in chip_smoke.main_path_attention_sites(ModelConfig.sd2_base(),
                                                         chip_smoke.UNET_BATCH)]
    out += [("sd15",) + s
            for s in chip_smoke.main_path_attention_sites(ModelConfig.sd15(), chip_smoke.UNET_BATCH)
            if s[5] <= 128]
    return out


def out_of_process_ms(directory, site_list):
    """Times of the fp32 `flash_attention` of the checkout in `directory` at
    each site, in a process of its own."""
    code = f"""
import json, sys
sys.path.insert(0, {directory!r})
import torch, chip_smoke
from difashion_tpu_torch.nn.kernels import flash_attention as fa
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
out = {{}}
for config, name, b, h, sq, skv, d, calls in {site_list!r}:
    q, k, v = (torch.randn(b, s, h * d, generator=gen, device="cuda")
               .view(b, s, h, d).transpose(1, 2) for s in (sq, skv, skv))
    out[config + "/" + name] = chip_smoke.device_ms(lambda: fa.flash_attention(q, k, v), reps=10)
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=directory, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"flash_fwd_f32: timing {directory} failed:\n{res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def against(directory, site_list):
    """Per site {against_ms, out_of_process_ms}: the checkout in `directory`
    and this tree timed by `out_of_process_ms` in turns (directory, this
    tree, this tree, directory), the mean of each pair."""
    directory = os.path.abspath(directory)
    runs = [out_of_process_ms(where, site_list) for where in (directory, ROOT, ROOT, directory)]
    return {key: {"against_ms": (runs[0][key] + runs[3][key]) / 2,
                  "out_of_process_ms": (runs[1][key] + runs[2][key]) / 2} for key in runs[0]}


def main():
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.kernels.flash_attention import (
        F32_SOURCE,
        flash_attention,
        flash_attention_3xtf32_ref,
        flash_attention_ref,
    )

    if not torch.cuda.is_available():
        print("flash_fwd_f32: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    args = sys.argv[1:]
    quick = "--quick" in args
    other = args[args.index("--against") + 1] if "--against" in args else None
    chip_smoke.phase_device()
    path, log = kernels.build(F32_SOURCE)
    print(json.dumps({"ptxas": [e for e in chip_smoke.ptxas_entries(log)
                                if any(name in e["kernel"] for name in FWD_KERNELS)]}),
          flush=True)
    print(json.dumps({"sass": sass_report(path, FWD_KERNELS)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = []
    for name, b, h, sq, skv, d, width in EDGE_SHAPES:
        q, k, v = inputs(b, h, sq, skv, d, gen, width)
        got = flash_attention(q, k, v)
        again = flash_attention(q, k, v)
        torch.cuda.synchronize()
        plain = flash_attention_ref(q, k, v)
        tc = flash_attention_3xtf32_ref(q, k, v)
        row = {"shape": name, "shape_bhqkd": [b, h, sq, skv, d], "row_width": width or d,
               "kernels": kernels_run(lambda: flash_attention(q, k, v)),
               "vs_plain": [chip_smoke.rel_l2(g, w) for g, w in zip(got, plain)],
               "vs_3xtf32_plain": [chip_smoke.rel_l2(g, w) for g, w in zip(got, tc)],
               "max_abs_vs_plain": [(g - w).abs().max().item() for g, w in zip(got, plain)],
               "repeat_equal": all(torch.equal(x, y) for x, y in zip(got, again))}
        close = all(torch.allclose(g, w, rtol=chip_smoke.F32_TOL, atol=chip_smoke.F32_TOL)
                    for g, w in zip(got, plain))
        route = ROUTES.get(name, "fwd_wg_kernel" if d == 64 else None)
        row["ok"] = (close and row["repeat_equal"]
                     and max(row["vs_3xtf32_plain"]) <= chip_smoke.F32_TOL
                     and all(bool(torch.isfinite(g).all()) for g in got)
                     and (route is None or row["kernels"] == [route]))
        if not row["ok"]:
            bad.append(name)
        print(json.dumps(row), flush=True)
        del q, k, v, got, again, plain, tc
    if quick:
        if bad:
            raise SystemExit(f"flash_fwd_f32: checks failed at {bad}")
        return
    site_list = sites()
    before = against(other, site_list) if other else None
    totals = {}
    for config, name, b, h, sq, skv, d, calls in site_list:
        q, k, v = inputs(b, h, sq, skv, d, gen)
        o, lse = flash_attention(q, k, v)
        ro, rlse = flash_attention_ref(q, k, v)
        err = max((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
        del ro, rlse
        ms = chip_smoke.device_ms(lambda: flash_attention(q, k, v), reps=10)
        bound, by, ops, _ = chip_smoke.attention_bound(b, h, sq, skv, d, torch.float32)
        simt = chip_smoke.simt_bound_ms("fwd", b, h, sq, skv, d)
        row = {"config": config, "site": name, "shape_bhqkd": [b, h, sq, skv, d], "calls": calls,
               "max_abs_err": err, "ms": ms, "bound_ms": bound, "bound_by": by, "share": bound / ms,
               "simt_bound_ms": simt, "simt_share": simt / ms, "tflops": ops / ms / 1e9,
               "library_ms": chip_smoke.device_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v), reps=10)}
        with torch.inference_mode():
            row["host_us"] = chip_smoke.host_us_per_call(lambda: flash_attention(q, k, v),
                                                         calls=50)
        if before:
            row.update(before[f"{config}/{name}"])
        if err > chip_smoke.F32_TOL:
            bad.append(f"{config}/{name}")
        t = totals.setdefault(config, {})
        for key in ("ms", "bound_ms", "simt_bound_ms", "library_ms", "against_ms",
                    "out_of_process_ms"):
            if key in row:
                t[key] = t.get(key, 0.0) + row[key] * calls
        print(json.dumps(row), flush=True)
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    for t in totals.values():
        t["share"] = t["bound_ms"] / t["ms"]
        t["simt_share"] = t["simt_bound_ms"] / t["ms"]
    print(json.dumps({"per_fp32_unet_forward": totals}), flush=True)
    if bad:
        raise SystemExit(f"flash_fwd_f32: checks failed at {bad}")


if __name__ == "__main__":
    main()

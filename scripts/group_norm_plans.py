#!/usr/bin/env python3
"""The GroupNorm kernel (`difashion_tpu_torch/csrc/group_norm_silu.cu`) under
several plans, on one CUDA card.

    python3 scripts/group_norm_plans.py                 # from the repository root
    python3 scripts/group_norm_plans.py --quick         # build, ptxas report, checks only
    python3 scripts/group_norm_plans.py --against DIR   # also time DIR's group_norm_silu
    python3 scripts/group_norm_plans.py --phases        # where a one-read CTA's time goes

It builds the source and prints the ptxas report. With --quick: the kernel
against its plain version at small shapes that cover both routes (clusters
of 1 to 16 CTAs, a ragged S, an x off a 16-byte boundary, an odd C), in
bf16, fp16 and fp32, with and without SiLU, and its repeats bit-equal; then
it stops. Otherwise, at every GroupNorm shape of the sampler's UNet forward
(sd2_base, batch 16) and of the VAE decode (batch 4), in bf16 with the
activation each shape is called with: the kernel's time under every
candidate of TIER_SETS (settings of `gn_plan`: the one-read route's tiers and
narrowest band row, the two-pass route's chunks; "shipped" as committed), each
checked against the plain version, beside the bound; last, per candidate,
the sums over one sampler forward's 61 calls and one decode's 30. With
--against DIR, the `group_norm_silu` of the checkout in DIR (an earlier
version of the kernel, built from DIR's own sources) is timed at the same
shapes in a process of its own, before and after this tree's, on the layout
its wrapper takes. With --phases: the source built with -DGN_PHASE_TIMES, at
PHASE_SITES under each candidate, the one-read CTAs' phase durations
(thread 0's global-timer stamps: the first box's arrival, the rest of the
loads with the sums, the means, the squared deviations, the cluster's merge,
the normalisation and the stores issued, the stores' and the cluster's end)
as quantiles over the CTAs, and the spread of the CTAs' start times (the
waves). Exits non-zero if a check fails.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (stdlib only at import)

K = 1024
# candidate plans: the settings of nn/kernels/groupnorm.py that each changes
# ("shipped": none)
TIER_SETS = {
    "shipped": {},
    "rows_of_16_bytes": {"ONE_READ_MIN_ROW_BYTES": 16},
    "one_cta_per_sm_too": {"ONE_READ_TIERS": ((16, 62 * K), (16, 100 * K), (16, 208 * K))},
    "chunks_of_64k": {"_CHUNK_BYTES": 64 * K},
    "blocks_1024": {"_TARGET_BLOCKS": 1024},
}
QUICK_SHAPES = [  # (B, C, H, W), groups
    ((2, 64, 8, 8), 32), ((1, 96, 7, 7), 32), ((2, 320, 24, 24), 32),
    ((1, 960, 64, 64), 32), ((1, 128, 128, 128), 32), ((2, 33, 5, 7), 3),
    ((2, 4, 1, 1), 2), ((2, 16, 1, 1), 2), ((1, 512, 256, 256), 32),
    ((1, 512, 128, 128), 32), ((1, 128, 512, 512), 32),
]
PATHS = ("sampler_unet", "vae_decode")
PHASE_SITES = [((16, 320, 64, 64), 32, "silu"), ((16, 960, 64, 64), 32, "silu"),
               ((16, 1280, 8, 8), 32, "silu"), ((4, 512, 128, 128), 32, "silu")]
PHASES = ("first_box", "loads_and_sums", "means", "deviations", "cluster_merge",
          "normalise_and_store", "drain_and_exit")


def against(directory, shapes):
    """ms of `group_norm_silu` from the checkout in `directory` at each
    (shape, groups, eps, act), in a process of its own (its package, its
    sources, its build), on channels-last x or, where its wrapper refuses
    that, on NCHW x."""
    code = f"""
import json, sys
sys.path.insert(0, {directory!r})
import torch, chip_smoke
from difashion_tpu_torch.nn.kernels.groupnorm import group_norm_silu
gen = torch.Generator(device="cuda").manual_seed(0)
out = []
for shape, groups, eps, act in {shapes!r}:
    c = shape[1]
    x = torch.randn([shape[0]] + shape[2:] + [c], generator=gen, device="cuda")
    x = x.to(torch.bfloat16).movedim(-1, 1)
    scale, bias = torch.rand(c, device="cuda") + 0.5, torch.randn(c, device="cuda")
    try:
        group_norm_silu(x, scale, bias, groups, eps, act)
    except ValueError:
        x = x.contiguous()
    out.append(chip_smoke.device_ms(lambda: group_norm_silu(x, scale, bias, groups, eps, act)))
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=directory, timeout=900)
    if res.returncode != 0:
        return {"error": res.stderr[-2000:]}
    return json.loads(res.stdout.strip().splitlines()[-1])


def plan_with(settings, shape, groups, dtype):
    """`gn_plan` with the module settings in `settings` in place of its own."""
    from difashion_tpu_torch.nn.kernels import groupnorm

    saved = {name: getattr(groupnorm, name) for name in settings}
    try:
        for name, value in settings.items():
            setattr(groupnorm, name, value)
        return groupnorm.gn_plan(shape, groups, dtype)
    finally:
        for name, value in saved.items():
            setattr(groupnorm, name, value)


def inputs(shape, dtype, gen, offset=0.5):
    import torch

    c = shape[1]
    x = torch.randn([shape[0]] + list(shape[2:]) + [c], generator=gen, device="cuda")
    x = (x * 2 + offset).to(dtype).movedim(-1, 1)
    scale = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = torch.randn(c, generator=gen, device="cuda") * 0.2
    return x, scale, bias


def quick():
    """The kernel against its plain version at QUICK_SHAPES; True if all agree."""
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn.kernels.groupnorm import (
        gn_plan,
        group_norm_silu,
        group_norm_silu_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    ok_all = True
    for shape, groups in QUICK_SHAPES:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            x, scale, bias = inputs(shape, dtype, gen)
            variants = [("aligned", x)]
            if shape[0] == 1 and x.numel() < 2 ** 24:
                # a copy starting 2 elements into a buffer: off 16 bytes
                buf = torch.empty(x.numel() + 2, device="cuda", dtype=dtype)
                off = buf[2:].view([shape[0]] + list(shape[2:]) + [shape[1]]).movedim(-1, 1)
                off.copy_(x)
                variants.append(("offset", off))
            for name, xx in variants:
                plan = gn_plan(xx.shape, groups, dtype, aligned=xx.data_ptr() % 16 == 0)
                pre = group_norm_silu_ref(xx, scale, bias, groups, 1e-6)
                for act in (None, "silu"):
                    y = group_norm_silu(xx, scale, bias, groups, 1e-6, act)
                    torch.cuda.synchronize()
                    want = pre if act is None else F.silu(pre)
                    ok, err = chip_smoke.gn_check(y, want, pre, dtype)
                    repeat = torch.equal(y, group_norm_silu(xx, scale, bias, groups, 1e-6, act))
                    ok = ok and repeat and bool(torch.isfinite(y).all())
                    ok_all = ok_all and ok
                    print(json.dumps({"quick": list(shape), "groups": groups, "x": name,
                                      "dtype": str(dtype)[6:], "act": act, "plan": plan._asdict(),
                                      "max_abs_err": err, "repeat_bit_equal": repeat,
                                      "ok": ok}), flush=True)
            del x, variants
            torch.cuda.empty_cache()
    return ok_all


def phases(tier_sets):
    """Phase durations of the one-read CTAs at PHASE_SITES (bf16)."""
    import ctypes
    import statistics

    import torch

    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.kernels.groupnorm import NAME, launch

    path, _ = kernels.build(NAME, ("GN_PHASE_TIMES",))
    lib = ctypes.CDLL(str(path))
    lib.group_norm_silu_phase_times.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape, groups, act in PHASE_SITES:
        x, scale, bias = inputs(shape, torch.bfloat16, gen)
        for name, settings in tier_sets.items():
            plan = plan_with(settings, x.shape, groups, x.dtype)
            if plan.route != "one_read":
                continue
            launch(x, scale, bias, groups, 1e-6, act, plan, lib)
            torch.cuda.synchronize()
            lib.group_norm_silu_phase_reset()
            launch(x, scale, bias, groups, 1e-6, act, plan, lib)
            torch.cuda.synchronize()
            ctas = plan.n * (groups // plan.k) * shape[0]
            buf = (ctypes.c_ulonglong * (ctas * 8))()
            lib.group_norm_silu_phase_times(buf, ctas)
            stamps = [list(buf[i * 8:(i + 1) * 8]) for i in range(ctas)]
            stamps = [st for st in stamps if st[0] and st[7]]
            t0 = min(st[0] for st in stamps)
            q = lambda v: [round(v[int(f * (len(v) - 1))] / 1e3, 2) for f in (0.1, 0.5, 0.9)]
            out = {"phases_site": list(shape), "plan": name, "n": plan.n,
                   "ctas_timed": len(stamps),
                   "span_us": (max(st[7] for st in stamps) - t0) / 1e3,
                   "start_us_q10_50_90": q(sorted(st[0] - t0 for st in stamps)),
                   "cta_us_q10_50_90": q(sorted(st[7] - st[0] for st in stamps))}
            for i, ph in enumerate(PHASES):
                out[ph] = q(sorted(st[i + 1] - st[i] for st in stamps))
            out["median_sum_us"] = sum(statistics.median(st[i + 1] - st[i] for st in stamps)
                                       for i in range(7)) / 1e3
            print(json.dumps(out), flush=True)
        del x
        torch.cuda.empty_cache()


def main():
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.kernels.groupnorm import NAME, group_norm_silu_ref, launch

    if not torch.cuda.is_available():
        print("group_norm_plans: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    args = sys.argv[1:]
    other = args[args.index("--against") + 1] if "--against" in args else None
    chip_smoke.phase_device()
    _, log = kernels.build(NAME)
    print(json.dumps({"ptxas": [ln.strip()[:160] for ln in log.splitlines()
                                if "Compiling entry" in ln or "registers" in ln
                                or "spill" in ln]}), flush=True)
    if "--quick" in args:
        sys.exit(0 if quick() else 1)
    if "--phases" in args:
        phases(TIER_SETS)
        return

    sites = []
    for site in chip_smoke.groupnorm_sites(ModelConfig.sd2_base()):
        for path in PATHS:
            for act, calls in site["calls"].get(path, {}).items():
                sites.append((site["shape"], site["groups"], site["eps"], act, path, calls))
    site_args = [list(s[:4]) for s in sites]
    before = against(other, site_args) if other else None
    gen = torch.Generator(device="cuda").manual_seed(2)
    totals = {name: {p: 0.0 for p in PATHS} for name in TIER_SETS}
    bound_total = {p: 0.0 for p in PATHS}
    ok_all = True
    for shape, groups, eps, act, path, calls in sites:
        x, scale, bias = inputs(shape, torch.bfloat16, gen)
        pre = group_norm_silu_ref(x, scale, bias, groups, eps)
        want = pre if act is None else F.silu(pre)
        nbytes = 2 * x.numel() * x.element_size() + 2 * shape[1] * 4
        bound = nbytes / chip_smoke.PEAK_HBM_BYTES * 1e3
        bound_total[path] += bound * calls
        row = {"site": shape, "groups": groups, "act": act, "path": path, "calls": calls,
               "bound_ms": bound}
        for name, settings in TIER_SETS.items():
            plan = plan_with(settings, x.shape, groups, x.dtype)
            y = launch(x, scale, bias, groups, eps, act, plan)
            torch.cuda.synchronize()
            ok, err = chip_smoke.gn_check(y, want, pre, x.dtype)
            ms = chip_smoke.device_ms(lambda: launch(x, scale, bias, groups, eps, act, plan))
            row[name] = {"route": plan.route, "k": plan.k, "n": plan.n, "ms": ms,
                         "share": bound / ms, "max_abs_err": err, "ok": ok}
            totals[name][path] += ms * calls
            ok_all = ok_all and ok
            del y
        print(json.dumps(row), flush=True)
        del x, pre, want
        torch.cuda.empty_cache()
    after = against(other, site_args) if other else None
    summary = {"totals_ms": totals, "bound_ms": bound_total,
               "best": {p: min(totals, key=lambda n: totals[n][p]) for p in PATHS}}
    if other:
        mean = lambda i: (before[i] + after[i]) / 2 if isinstance(before, list) and isinstance(
            after, list) else None
        summary["against"] = {"dir": other, "ms_before": before, "ms_after": after}
        if isinstance(before, list) and isinstance(after, list):
            summary["against"]["totals_ms"] = {
                p: sum(mean(i) * s[5] for i, s in enumerate(sites) if s[4] == p) for p in PATHS}
    print(json.dumps(summary), flush=True)
    sys.exit(0 if ok_all else 1)


if __name__ == "__main__":
    main()

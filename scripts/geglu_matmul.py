#!/usr/bin/env python3
"""The fused GEGLU kernel (`difashion_tpu_torch/csrc/geglu_matmul.cu`) on one
CUDA card: its checks, its tile widths and schedules, its time.

    python3 scripts/geglu_matmul.py            # from the repository root
    python3 scripts/geglu_matmul.py --quick    # build, ptxas report, checks at reduced M
    python3 scripts/geglu_matmul.py --unet     # also a 64-row sd2_base UNet forward
    python3 scripts/geglu_matmul.py --time     # times only, no checks

It builds the kernel and prints its ptxas report. Then, at the GEGLU
products of a 64-row sd2_base / sd15 UNet forward (the two share their
feed-forward widths: C = 320, 640, 1280 at 4096, 1024, 256 and 64 tokens;
`--quick`: M cut to 8192 rows at most) and at ragged shapes, at each tile
width the kernel is built for (`TILE_WIDTHS`), in bf16 and fp16,
with and without a bias: the kernel against its plain version
(`geglu_matmul_ref`, run on the card), bit for bit on inputs whose fp32
sums are exact in any order (`exact_inputs`), and on random inputs within
the gap that one unit in the last place of each rounded sum carries to the
output (`geglu_matmul.rounding_gap_bound`), with the units apart beside
(`ulps`).
First the epilogue's gelu at all 65,536 bf16 and fp16 inputs against
PyTorch's GELU on the card. Without `--quick`, in bf16 with a bias: the
time at each width,
the bound (2 M K 2F operations at 989 TFLOP/s, or x, w and the bias read and
the F-wide output written once at 3.35 TB/s), and the unfused path it
replaces (`F.linear`, `chunk`, `F.gelu`, the product: `library_ms`, with
`F.linear` alone as `linear_ms`), one JSON line per shape; last the fastest
width per shape beside `tile_width`'s. `--unet` times one no-grad bf16 UNet forward at
64 rows through the kernel and through the unfused path, counts the launches
of each and compares their outputs. Every line also goes to
`chiprun_out/geglu_matmul.jsonl`. Exits non-zero if a check fails (an
exact input apart, a gap over its bound, or more than 2 % of elements apart).
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (stdlib only at import)

# (M, C): the GEGLU projections of a 64-row UNet forward (K = C, F = 4C)
SITES = [(262144, 320), (65536, 640), (16384, 1280), (4096, 1280)]
RAGGED = [(1000, 96, 128), (130, 40, 256), (4100, 1280, 5120)]
QUICK_M = 8192
MAX_DIFF_SHARE = 0.02


def products(quick):
    """[(M, K, F)] to check: the UNet's sites (M cut with `quick`), ragged ones."""
    sites = [(min(m, QUICK_M) if quick else m, c, 4 * c) for m, c in SITES]
    return sites + RAGGED


def inputs(m, k, f, dtype, gen):
    import torch

    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(2 * f, k, generator=gen, device="cuda") / k ** 0.5).to(dtype)
    b = (0.5 * torch.randn(2 * f, generator=gen, device="cuda")).to(dtype)
    return x, w, b


def ulps(a, b):
    """{equal_share, one_ulp, max_ulps} of two 16-bit tensors, apart in units
    in the last place (their bit patterns as ordered integers; across zero
    the count runs through every value between)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    d = (ordered(a) - ordered(b)).abs()
    return {"equal_share": (d == 0).float().mean().item(), "one_ulp": int((d == 1).sum()),
            "max_ulps": int(d.max())}


def exact_inputs(m, k, f, dtype, gen):
    """x, w and the bias on grids fine enough for 16 bits and coarse enough
    that every fp32 sum over K is exact in any order (multiples of 2^-9
    below 2^11): the kernel and the plain version then round the same
    values, and the gelu and the product must agree bit for bit."""
    import torch

    x = torch.randint(-8, 9, (m, k), generator=gen, device="cuda") / 8.0
    w = torch.randint(-8, 9, (2 * f, k), generator=gen, device="cuda") / 64.0
    b = torch.randint(-64, 65, (2 * f,), generator=gen, device="cuda") / 32.0
    return x.to(dtype), w.to(dtype), b.to(dtype)


def propagated(o, x, w, bias):
    """(share of elements apart from the plain version, the largest gap over
    `rounding_gap_bound`)."""
    from difashion_tpu_torch.nn.kernels import geglu_matmul as gg

    gap = (o.float() - gg.geglu_matmul_ref(x, w, bias).float()).abs()
    bound = gg.rounding_gap_bound(x, w, bias)
    return (gap > 0).float().mean().item(), (gap / (bound + 1e-30)).max().item()


def check(m, k, f, dtype, gen, bn):
    """The kernel at one width: bit for bit on exact inputs,
    within the propagated bound on random ones, with and without a bias."""
    import torch

    from difashion_tpu_torch.nn.kernels import geglu_matmul as gg

    x, w, b = inputs(m, k, f, dtype, gen)
    xe, we, be = exact_inputs(m, k, f, dtype, gen)
    out = {}
    for key, bias, bias_e in (("no_bias", None, None), ("bias", b, be)):
        o = gg.launch(x, w, bias, bn)
        oe = gg.launch(xe, we, bias_e, bn)
        torch.cuda.synchronize()
        r = ulps(o, gg.geglu_matmul_ref(x, w, bias))
        r["apart_share"], r["gap_over_bound"] = propagated(o, x, w, bias)
        r["exact_equal"] = torch.equal(oe, gg.geglu_matmul_ref(xe, we, bias_e))
        r["ok"] = (bool(torch.isfinite(o).all()) and r["exact_equal"]
                   and r["gap_over_bound"] <= 1.0 and r["apart_share"] <= MAX_DIFF_SHARE)
        out[key] = r
    return out


def gelu_check():
    """The epilogue's gelu (`gelu_all`) at all 65,536 inputs of bf16 and fp16
    against PyTorch's GELU on the card (fp32, then the dtype; NaNs compared
    as NaNs: their bits are the converters')."""
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn.kernels import geglu_matmul as gg

    dev = torch.device("cuda")
    # every 16-bit pattern, in order of the pattern
    patterns = torch.arange(65536, dtype=torch.int32, device=dev)
    patterns = torch.where(patterns >= 32768, patterns - 65536, patterns).to(torch.int16)
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        got = gg.gelu_all(dtype, dev)
        want = F.gelu(patterns.view(dtype).float()).to(dtype).view(torch.int16)
        nan = torch.isnan(got.view(dtype)) & torch.isnan(want.view(dtype))
        out[str(dtype)[6:]] = {"equal": bool(((got == want) | nan).all()),
                               "nan_outputs": int(nan.sum())}
    out["ok"] = all(v["equal"] for v in out.values())
    return out


def library(x, w, b):
    """The unfused path GEGLU took before the kernel: cuBLAS, then the
    strided gelu and product."""
    import torch.nn.functional as F

    h, gate = F.linear(x, w, b).chunk(2, dim=-1)
    return h * F.gelu(gate)


def bound_ms(m, k, f):
    """The fused kernel's own bound: 2 M K 2F operations, or x, w, the bias
    read and the F-wide output written once."""
    ops = 2.0 * m * k * 2 * f
    nbytes = 2.0 * (m * k + 2 * f * k + m * f + 2 * f)
    return max(ops / chip_smoke.PEAK_BF16_FLOPS, nbytes / chip_smoke.PEAK_HBM_BYTES) * 1e3, ops


def unet_forward():
    """A 64-row no-grad bf16 sd2_base UNet forward through the kernel and
    through the unfused path (`geglu_route` patched off): device ms, the
    launches of each and the outputs' gap."""
    import torch

    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn import kernels, layers

    cfg = ModelConfig.sd2_base()
    model = create_difashion(cfg, seed=0, device="cuda", dtype=torch.bfloat16).eval()
    u = cfg.unet
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, s = 64, u.sample_size
    x = torch.randn(rows, u.in_channels, s, s, generator=gen, device="cuda").bfloat16()
    t = torch.randint(0, 1000, (rows,), generator=gen, device="cuda")
    ctx = torch.randn(rows, 77, u.cross_attention_dim, generator=gen, device="cuda").bfloat16()
    route = layers.geglu_route
    res = {}
    with torch.inference_mode():
        for name, patched in (("kernel", route), ("unfused", lambda *a: False)):
            layers.geglu_route = patched
            try:
                fwd = lambda: model.unet(x, t, ctx)
                kernels.reset_launches()
                y = fwd()
                torch.cuda.synchronize()
                launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
                res[name] = {"ms": chip_smoke.device_ms(fwd, reps=10), "launches": launches,
                             "y": y.float()}
            finally:
                layers.geglu_route = route
    gap = (res["kernel"]["y"] - res["unfused"]["y"]).abs()
    scale = res["unfused"]["y"].abs().mean().item()
    out = {name: {k: v for k, v in r.items() if k != "y"} for name, r in res.items()}
    out.update(mean_abs_gap=gap.mean().item(), max_abs_gap=gap.max().item(),
               mean_abs_output=scale)
    ok = (out["kernel"]["launches"].get("geglu_matmul") == 16
          and "geglu_matmul" not in out["unfused"]["launches"]
          and out["kernel"]["launches"].get("skinny_matmul")
          == out["unfused"]["launches"].get("skinny_matmul")
          and out["mean_abs_gap"] <= 0.01 * scale)
    return out, ok


OUT = os.path.join(ROOT, "chiprun_out", "geglu_matmul.jsonl")


def emit(row):
    line = json.dumps(row)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def main():
    import torch

    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.kernels import geglu_matmul as gg

    if not torch.cuda.is_available():
        print("geglu_matmul: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    quick = "--quick" in sys.argv[1:]
    time_only = "--time" in sys.argv[1:]
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    chip_smoke.phase_device()
    _, log = kernels.build(gg.NAME)
    emit({"ptxas": chip_smoke.ptxas_entries(log),
          "warnings": [ln.strip() for ln in log.splitlines()
                       if "arning" in ln or "stack frame" in ln]})
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad, best = [], {}
    gelu = gelu_check()
    emit({"gelu_all": gelu})
    if not gelu["ok"]:
        bad.append("gelu_all")
    for m, k, f in products(quick):
        row = {"mkf": [m, k, f], "checks": {}}
        for dtype in () if time_only else (torch.bfloat16, torch.float16):
            for bn in gg.TILE_WIDTHS:
                res = check(m, k, f, dtype, gen, bn)
                row["checks"][f"{str(dtype)[6:]}_bn{bn}"] = res
                bad += [(m, k, f, str(dtype), bn, key) for key, r in res.items() if not r["ok"]]
        if not quick and (m, k) in [(mm, c) for mm, c in SITES]:
            x, w, b = inputs(m, k, f, torch.bfloat16, gen)
            row["ms"] = {f"bn{bn}": chip_smoke.device_ms(lambda: gg.launch(x, w, b, bn))
                         for bn in gg.TILE_WIDTHS}
            row["library_ms"] = chip_smoke.device_ms(lambda: library(x, w, b))
            row["linear_ms"] = chip_smoke.device_ms(lambda: torch.nn.functional.linear(x, w, b))
            row["bound_ms"], ops = bound_ms(m, k, f)
            row["tflops"] = {key: ops / t / 1e9 for key, t in row["ms"].items()}
            row["roofline_pct"] = {key: 100 * row["bound_ms"] / t for key, t in row["ms"].items()}
            best[f"{m}x{k}x{f}"] = min(row["ms"], key=row["ms"].get)
            del x, w, b
            torch.cuda.empty_cache()
        emit(row)
    if best:
        emit({"fastest": best, "chosen": {key: f"bn{gg.tile_width(int(key.split('x')[1]))}"
                                          for key in best}})
    if "--unet" in sys.argv[1:]:
        out, ok = unet_forward()
        emit({"unet": out, "ok": ok})
        if not ok:
            bad.append("unet")
    if bad:
        emit({"failed": bad})
        sys.exit(1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The skinny-N matmul kernel (`difashion_tpu_torch/csrc/skinny_matmul.cu`) at
every tile width it is built for, on one CUDA card.

    python3 scripts/skinny_matmul_tiles.py            # from the repository root
    python3 scripts/skinny_matmul_tiles.py --quick    # build, ptxas report, one shape

It builds the kernel, prints its ptxas report, then, at every distinct product
that the Dense gate routes to it on the paths of `chip_smoke.py` (the forward
products in nn.Linear's [N, K] layout, the train step's dx products in the
[K, N] layout the backward reads), and at the ragged shapes of the CUDA
tests, for each tile width (BN) of `TILE_WIDTHS`, in bf16 and fp16, with and
without a bias: the kernel against its plain version and both against an
fp64 product (the kernel may be no farther from it than 1.25x the plain
version). Then, in bf16, the time of each width without a bias and with one,
beside `torch.matmul` and `F.linear` (with the bias), one JSON line per
shape, and last the width that was fastest without a bias per N and layout.
Exits non-zero if any check fails.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (stdlib only at import)

VS_PLAIN = 1.25
RAGGED = [(1000, 96, 200), (130, 40, 24), (2048, 640, 2560)]


def distinct_products():
    """[(M, K, N, w_kn)]: the routed products of chip_smoke's timed paths
    (dx products with w_kn) and the ragged shapes."""
    from difashion_tpu_torch.config import ModelConfig

    paths = chip_smoke.dense_sites(ModelConfig.sd2_base())
    seen = []
    for path in chip_smoke.MM_TIMED:
        for m, k, n, _ in paths[path]:
            key = (m, k, n, path.endswith("_dx"))
            if key not in seen:
                seen.append(key)
    return seen + [(*mkn, kn) for mkn in RAGGED for kn in (False, True)]


def inputs(m, k, n, w_kn, dtype, gen):
    import torch

    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    # w_kn: the backward's case, the stored [N_out, K_out] weight read as [K, N]
    shape = (k, n) if w_kn else (n, k)
    w = (torch.randn(*shape, generator=gen, device="cuda") / k ** 0.5).to(dtype)
    b = torch.randn(n, generator=gen, device="cuda").to(dtype)
    return x, w, b


def check(m, k, n, w_kn, dtype, bn, gen):
    """{max_abs_err, kernel_vs_fp64, plain_vs_fp64, ok} with and without a bias."""
    import torch

    from difashion_tpu_torch.nn.kernels import skinny_matmul as sm

    x, w, b = inputs(m, k, n, w_kn, dtype, gen)
    out = {}
    for bias in (None, b):
        o = sm.launch(x, w, bias, w_kn, bn)
        torch.cuda.synchronize()
        plain = sm.skinny_matmul_ref(x, w, bias, w_kn=w_kn)
        ref = x.double() @ (w.double() if w_kn else w.double().t())
        if bias is not None:
            ref = ref + bias.double()
        kernel_err = (o.double() - ref).abs().max().item()
        plain_err = (plain.double() - ref).abs().max().item()
        key = "bias" if bias is not None else "no_bias"
        out[key] = {"max_abs_err": (o.float() - plain.float()).abs().max().item(),
                    "kernel_vs_fp64": kernel_err, "plain_vs_fp64": plain_err,
                    "ok": bool(torch.isfinite(o).all()) and kernel_err <= VS_PLAIN * plain_err}
    return out


def main():
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.kernels import skinny_matmul as sm

    if not torch.cuda.is_available():
        print("skinny_matmul_tiles: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    quick = "--quick" in sys.argv[1:]
    chip_smoke.phase_device()
    _, log = kernels.build(sm.NAME)
    print(json.dumps({"ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln or "arning" in ln]}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    products = [(8192, 320, 320, False), (8192, 320, 320, True)] if quick else distinct_products()
    bad, best = [], {}
    for m, k, n, w_kn in products:
        row = {"mkn": [m, k, n], "w_kn": w_kn, "checks": {}}
        for dtype in (torch.bfloat16, torch.float16):
            for bn in sm.TILE_WIDTHS:
                res = check(m, k, n, w_kn, dtype, bn, gen)
                row["checks"][f"{str(dtype)[6:]}_bn{bn}"] = res
                bad += [(m, k, n, w_kn, str(dtype), bn, key)
                        for key, r in res.items() if not r["ok"]]
        if not quick:
            x, w, b = inputs(m, k, n, w_kn, torch.bfloat16, gen)
            wt = w if w_kn else w.t()
            row["ms"] = {bn: chip_smoke.device_ms(lambda: sm.launch(x, w, None, w_kn, bn))
                         for bn in sm.TILE_WIDTHS}
            row["ms_bias"] = {bn: chip_smoke.device_ms(lambda: sm.launch(x, w, b, w_kn, bn))
                              for bn in sm.TILE_WIDTHS}
            row["matmul_ms"] = chip_smoke.device_ms(lambda: torch.matmul(x, wt))
            row["linear_ms"] = (None if w_kn else
                                chip_smoke.device_ms(lambda: F.linear(x, w, b)))
            bound_ms, bound_by, ops, _ = chip_smoke.matmul_bound(m, k, n)
            row.update(bound_ms=bound_ms, bound_by=bound_by,
                       tflops={bn: ops / t / 1e9 for bn, t in row["ms"].items()},
                       chosen=sm.tile_n(n, w_kn))
            fastest = min(row["ms"], key=row["ms"].get)
            best.setdefault(f"N={n}, {'[K, N]' if w_kn else '[N, K]'}", []).append(
                [m, k, fastest])
            del x, w, b
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    print(json.dumps({"fastest_width_per_n": best}), flush=True)
    if bad:
        print(json.dumps({"failed": bad}), flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The fp32 skinny-N matmul kernel (`difashion_tpu_torch/csrc/skinny_matmul_f32.cu`,
3xTF32 on the tensor cores) on one CUDA card.

    python3 scripts/skinny_matmul_f32.py            # from the repository root
    python3 scripts/skinny_matmul_f32.py --quick    # build, ptxas report, the checks
    python3 scripts/skinny_matmul_f32.py --unet     # and an fp32 UNet forward

It builds the kernel and prints its ptxas report, then, at every distinct
product that the Dense gate routes to it on an fp32 model's paths in
`chip_smoke.py` (the sampler's UNet forward, the train step's forward and dx
with the weight read as [K, N], the VAE decode) and at ragged shapes, with
and without a bias: the kernel against `skinny_matmul_3xtf32_ref` (within F32_MM_TOL relative L2:
the same split products, summed in another order) and both against an fp64
product (the kernel no farther from it than 1.25x the plain version, or at
the ragged shapes 2^-21). Then, without --quick, its time with and without a
bias beside F.linear / torch.matmul in fp32 (TF32 off) and the plain 3xTF32
version, the 3xTF32 and SIMT bounds, one JSON line per shape. With --unet, last, one sd2_base UNet forward at 16 rows in fp32
through the kernels and through the plain versions (ms each, the skinny-N
launches). Exits non-zero if any check fails.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (stdlib only at import)

VS_PLAIN = 1.25
# Where K is a few chunks deep (the ragged shapes) both sit at fp32's own
# rounding: the plain version's fp32 sums near 2^-23 of the result, the
# kernel's near 2^-22 (the tensor cores' sums within a chunk truncate). There
# the kernel may be as far as 2^-21 from fp64 whatever the plain version's
# distance; at the routed shapes (K >= 320) the VS_PLAIN rule holds alone.
FLOOR_VS_FP64 = 2.0 ** -21
RAGGED = [(1000, 96, 200), (130, 40, 24), (2048, 640, 2560), (512, 64, 30)]


def rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def distinct_products(quick):
    """[(M, K, N, w_kn)]: the routed fp32 products of chip_smoke's timed
    fp32 paths (dx products with w_kn; --quick: those of the train step) and
    the ragged shapes in both layouts (N % 4 != 0 only as [N, K])."""
    import torch

    from difashion_tpu_torch.config import ModelConfig

    paths = chip_smoke.dense_sites(ModelConfig.sd2_base(), dtype=torch.float32)
    seen = []
    for path in (("train_unet", "train_unet_dx") if quick else chip_smoke.MM_F32_TIMED):
        for m, k, n, _ in paths[path]:
            key = (m, k, n, path.endswith("_dx"))
            if key not in seen:
                seen.append(key)
    return seen + [(*mkn, kn) for mkn in RAGGED for kn in (False, True)
                   if not (kn and mkn[2] % 4)]


def inputs(m, k, n, w_kn, gen):
    import torch

    x = torch.randn(m, k, generator=gen, device="cuda")
    # w_kn: the backward's case, the stored [N_out, K_out] weight read as [K, N]
    w = torch.randn(*((k, n) if w_kn else (n, k)), generator=gen, device="cuda") / k ** 0.5
    return x, w, torch.randn(n, generator=gen, device="cuda")


def check(x, w, b, w_kn, ragged):
    """{rel_l2 vs the plain 3xTF32 version, kernel and plain vs fp64, ok}
    with and without a bias."""
    import torch

    from difashion_tpu_torch.nn.kernels import skinny_matmul as sm

    out = {}
    for bias in (None, b):
        o = sm.skinny_matmul(x, w, bias, w_kn=w_kn)
        torch.cuda.synchronize()
        plain = sm.skinny_matmul_3xtf32_ref(x, w, bias, w_kn=w_kn)
        ref = x.double() @ (w.double() if w_kn else w.double().t())
        if bias is not None:
            ref = ref + bias.double()
        vs_plain, kernel_err, plain_err = rel(o, plain), rel(o, ref), rel(plain, ref)
        out["bias" if bias is not None else "no_bias"] = {
            "rel_l2": vs_plain, "kernel_vs_fp64": kernel_err, "plain_vs_fp64": plain_err,
            "ok": bool(torch.isfinite(o).all()) and vs_plain <= chip_smoke.F32_MM_TOL
            and kernel_err <= max(VS_PLAIN * plain_err, FLOOR_VS_FP64 if ragged else 0.0)}
    return out


def unet_forward():
    """One fp32 sd2_base UNet forward at 16 rows through the kernels and
    through the plain versions: ms of each (CUDA events, after a warm-up),
    and the kernel run's launches."""
    import torch

    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.models.unet import UNet2DCondition
    from difashion_tpu_torch.nn import kernels

    cfg = ModelConfig.sd2_base().unet
    torch.manual_seed(0)
    unet = UNet2DCondition(cfg).to("cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    s, b = cfg.sample_size, chip_smoke.UNET_BATCH
    x = torch.randn(b, cfg.in_channels, s, s, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    ctx = torch.randn(b, 77, cfg.cross_attention_dim, generator=gen, device="cuda")
    out = {}
    with torch.inference_mode():
        kernels.reset_launches()
        unet(x, t, ctx)
        out["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        out["kernels_ms"] = chip_smoke.device_ms(lambda: unet(x, t, ctx), reps=5, warmup=1)
        with kernels.plain_versions():
            out["plain_ms"] = chip_smoke.device_ms(lambda: unet(x, t, ctx), reps=5, warmup=1)
    return out


def main():
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.kernels import skinny_matmul as sm

    if not torch.cuda.is_available():
        print("skinny_matmul_f32: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    quick = "--quick" in sys.argv[1:]
    chip_smoke.phase_device()
    _, log = kernels.build(sm.NAME_F32)
    print(json.dumps({"ptxas": chip_smoke.ptxas_entries(log),
                      "warnings": [ln.strip() for ln in log.splitlines() if "arning" in ln]}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = []
    for m, k, n, w_kn in distinct_products(quick):
        row = {"mkn": [m, k, n], "w_kn": w_kn}
        x, w, b = inputs(m, k, n, w_kn, gen)
        row["checks"] = check(x, w, b, w_kn, (m, k, n) in RAGGED)
        bad += [(m, k, n, w_kn, key) for key, r in row["checks"].items() if not r["ok"]]
        if not quick and (m, k, n) not in RAGGED:
            wt = w if w_kn else w.t()
            row["ms"] = chip_smoke.device_ms(lambda: sm.skinny_matmul(x, w, w_kn=w_kn))
            row["ms_bias"] = chip_smoke.device_ms(lambda: sm.skinny_matmul(x, w, b, w_kn=w_kn))
            row["matmul_ms"] = chip_smoke.device_ms(lambda: torch.matmul(x, wt))
            row["linear_ms"] = (None if w_kn else
                                chip_smoke.device_ms(lambda: F.linear(x, w, b)))
            row["plain_3xtf32_ms"] = chip_smoke.device_ms(
                lambda: sm.skinny_matmul_3xtf32_ref(x, w, w_kn=w_kn), reps=5, warmup=1)
            bound_ms, bound_by, ops, _, simt_ms = chip_smoke.matmul_bounds_f32(m, k, n)
            row.update(bound_ms=bound_ms, bound_by=bound_by, simt_bound_ms=simt_ms,
                       tflops=ops / row["ms"] / 1e9, share_of_bound=bound_ms / row["ms"])
        del x, w, b
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    # the Dense layer's fp32 route: one kernel launch forward, one for dx
    from difashion_tpu_torch.nn.layers import Dense

    dense = Dense(320, 640).to("cuda")
    xd = torch.randn(2, 2048, 320, device="cuda", requires_grad=True)
    kernels.reset_launches()
    dense(xd).backward(torch.randn(2, 2048, 640, device="cuda"))
    torch.cuda.synchronize()
    route = {k: v for k, v in kernels.LAUNCHES.items() if v}
    print(json.dumps({"dense_fp32_route_launches": route}), flush=True)
    if route != {"skinny_matmul_f32": 2}:
        bad.append(("dense route", route))
    if "--unet" in sys.argv[1:]:
        print(json.dumps({"unet_fp32_forward_16_rows": unet_forward()}), flush=True)
    if bad:
        print(json.dumps({"failed": bad}), flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()

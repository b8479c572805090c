#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`difashion_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

It drives the port's main path, DiFashion's GOR generation at the sd2_base
widths, through the entry points a user calls, and checks every hand-written
kernel of that path against its plain PyTorch version. Phases, one JSON line
each:

  1. device: the card (and its name and power limit as nvidia-smi prints
     them, on a line of their own); TF32 off wherever fp32 is compared;
  2. build: every kernel compiled from `difashion_tpu_torch/csrc/` with nvcc;
  3. kernel: the flash-attention kernel against its plain version at the
     shapes of the UNet's attentions (batch 16 = 4 CFG branches x 4 items)
     and a few short and ragged ones, with its time, the plain version's, one
     library call's (F.scaled_dot_product_attention, timed as a yardstick
     only) and the card's lower bound for the same work;
  4. reference: the whole generation path at the tiny config on the card
     (fp16) against the port's CPU fp32 run of the same weights and inputs;
  5. unet: one full-width sd2_base UNet forward (bf16, seeded weights, batch
     16) with attention through the kernel against one through the plain
     version;
  6. main_path: GOR, 1 outfit of 4 items, 4-branch CFG (12 / 4 / 5),
     eta 0.1, 50-step PNDM (51 UNet forwards), text encoding and the decode
     to uint8 at 512 px; the launch counts of that run;
  7. profile: the CUDA kernels of one UNet forward by device time.

Then the kernels line, and last {"ok": true, "device": {...}}. Any failed check
raises and the script exits non-zero; without a CUDA device it exits 2.
"""
import json
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# kernel vs plain, bf16 inputs: P is rounded to bf16 before the PV product
# (as in the TPU kernel); the plain version keeps it in fp32. The bound of
# tests/test_flash_attention.py::test_flash_bf16_precision.
MAX_ABS_TOL, MEAN_ABS_TOL = 3e-2, 3e-3
# the LSE is fp32 from the same bf16 products: ex2.approx and another
# summation order only
LSE_TOL = 1e-3
UNET_REL_L2_TOL = 1e-2
REF_REL_L2_TOL, REF_PIXEL_TOL = 2e-2, 1.0

UNET_BATCH = 16     # 4 CFG branches x 4 items
CFG_SCALES = (12.0, 4.0, 5.0)
STEPS = 50
ETA = 0.1


def emit(obj):
    print(json.dumps(obj), flush=True)


def main_path_attention_sites(cfg):
    """(name, B, H, Sq, Skv, D, calls per UNet forward) of every attention of
    one UNet forward: self- and cross-attention at each latent level."""
    u = cfg.unet
    side = u.sample_size
    sites = []
    n_down = sum(t == "CrossAttnDownBlock2D" for t in u.down_block_types)
    for level in range(len(u.block_out_channels)):
        ch = u.block_out_channels[level]
        heads = u.fixed_num_heads or ch // u.attention_head_dim
        s = (side >> level) ** 2
        down = u.layers_per_block if level < n_down else 0
        up_index = len(u.up_block_types) - 1 - level
        up = (u.layers_per_block + 1) if u.up_block_types[up_index] == "CrossAttnUpBlock2D" else 0
        if down + up:
            sites.append((f"self_{s}", UNET_BATCH, heads, s, s, ch // heads, down + up))
            sites.append((f"cross_{s}x77", UNET_BATCH, heads, s, 77, ch // heads, down + up))
    ch = u.block_out_channels[-1]
    heads = u.fixed_num_heads or ch // u.attention_head_dim
    s = (side >> (len(u.block_out_channels) - 1)) ** 2
    sites.append((f"mid_self_{s}", UNET_BATCH, heads, s, s, ch // heads, 1))
    sites.append((f"mid_cross_{s}x77", UNET_BATCH, heads, s, 77, ch // heads, 1))
    return sites


EXTRA_SHAPES = [  # (name, B, H, Sq, Skv, D)
    ("ragged_cross", 1, 2, 256, 77, 64),
    ("ragged_both_d32", 1, 1, 100, 50, 32),
    ("short_self_64", 1, 2, 64, 64, 64),
    ("short_self_77", 1, 2, 77, 77, 64),
    ("tiny_d16", 2, 3, 130, 77, 16),
]


def device_ms(fn, reps=25, warmup=3):
    """Median device time of one call, from CUDA events around each call. A
    sleep kernel first keeps the card busy while the host queues the calls,
    so the events time the device work and not the host's launch cost."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def attention_bound(b, h, sq, skv, d):
    """(bound ms, 'operations' or 'bytes', ops, bytes): two products of
    2*Sq*Skv*d each per (batch, head); q, k, v read once, o written once in
    bf16, the LSE written once in fp32."""
    ops = 4.0 * b * h * sq * skv * d
    nbytes = 2.0 * b * h * d * (2 * sq + 2 * skv) + 4.0 * b * h * sq
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi.splitlines()[0],
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build():
    from difashion_tpu_torch.nn import kernels

    t0 = time.perf_counter()
    logs = kernels.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "kernels": list(logs), "seconds": seconds, "ptxas": ptxas})


def phase_kernel(sites):
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    shapes = [(n, b, h, sq, skv, d, c) for n, b, h, sq, skv, d, c in sites]
    shapes += [(n, b, h, sq, skv, d, 0) for n, b, h, sq, skv, d in EXTRA_SHAPES]
    for name, b, h, sq, skv, d, calls in shapes:
        # the main path's layout: [B, S, H*D] projections seen as [B, H, S, D]
        q, k, v = (torch.randn(b, s, h * d, generator=gen, device="cuda")
                   .to(torch.bfloat16).view(b, s, h, d).transpose(1, 2)
                   for s in (sq, skv, skv))
        o, lse = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ro, rlse = flash_attention_ref(q.float(), k.float(), v.float())
        err = (o.float() - ro).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        lse_err = (lse - rlse).abs().max().item()
        del ro, rlse, err
        ok = (max_err <= MAX_ABS_TOL and mean_err <= MEAN_ABS_TOL and lse_err <= LSE_TOL
              and bool(torch.isfinite(o).all()))
        kernel_ms = device_ms(lambda: flash_attention(q, k, v))
        plain_ms = device_ms(lambda: flash_attention_ref(q, k, v), reps=20, warmup=2)
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by, ops, nbytes = attention_bound(b, h, sq, skv, d)
        row = {"phase": "kernel", "kernel": "flash_attention_fwd", "site": name,
               "shape_bhqkd": [b, h, sq, skv, d], "calls_per_unet_forward": calls,
               "max_abs_err": max_err, "mean_abs_err": mean_err, "lse_max_abs_err": lse_err,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": ops / kernel_ms / 1e9, "gbytes_per_s": nbytes / kernel_ms / 1e6,
               "ok": ok}
        emit(row)
        results.append(row)
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    bad = [r["site"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_attention_fwd disagrees with its plain version at {bad}")
    return results


def phase_unet(model):
    """One sd2_base UNet forward with attention through the kernel and one
    through the plain version, both in bf16, held against each other; and both
    against an fp32 forward of the same weights (plain attention), which shows
    the bf16 noise floor the two paths share."""
    import torch

    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.weights import TOWERS, param_count

    unet = model.unet
    cfg = unet.config
    gen = torch.Generator(device="cuda").manual_seed(1)
    s = cfg.sample_size
    x = torch.randn(UNET_BATCH, cfg.in_channels, s, s, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (UNET_BATCH,), generator=gen, device="cuda")
    ctx = torch.randn(UNET_BATCH, 77, cfg.cross_attention_dim, generator=gen, device="cuda")
    with torch.inference_mode():
        kernels.reset_launches()
        fast = unet(x, t, ctx).float()
        launches = kernels.LAUNCHES["flash_attention_fwd"]
        plain = unet(x, t, ctx, plain_attention=True).float()
    unet.float()
    with torch.inference_mode():
        ref = unet(x, t, ctx, plain_attention=True)
    unet.bfloat16()           # bf16 -> fp32 -> bf16 is exact
    torch.cuda.synchronize()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    fast_ref, plain_ref = rel(fast, ref), rel(plain, ref)
    finite = bool(torch.isfinite(fast).all() and torch.isfinite(plain).all())
    emit({"phase": "unet", "config": "sd2_base", "dtype": "bfloat16",
          "params": {tower: param_count(getattr(model, tower)) for tower in TOWERS},
          "batch": UNET_BATCH, "out_shape": list(fast.shape), "rel_l2": rel(fast, plain),
          "kernel_vs_fp32_rel_l2": fast_ref, "plain_vs_fp32_rel_l2": plain_ref,
          "finite": finite, "kernel_launches": launches})
    # the kernel path may be no farther from fp32 than the plain path, give
    # or take the spread of bf16 rounding between two runs
    if not (finite and rel(fast, plain) <= UNET_REL_L2_TOL and launches == 32
            and fast_ref <= 1.25 * plain_ref):
        raise AssertionError(f"UNet kernel vs plain: rel L2 {rel(fast, plain)}, vs fp32 "
                             f"{fast_ref} / {plain_ref}, finite {finite}, {launches} launches")


def gor_inputs(model, generator, device, F=4):
    """One GOR outfit (all F = 4 slots generated) with random latents from
    `generator` (CPU) and the model's own text encoding of random ids."""
    import torch

    from difashion_tpu_torch.engine.generate import GenerationInputs

    cfg = model.config
    s, C = cfg.unet.sample_size, cfg.vae.latent_channels
    rand = lambda *shape: torch.randn(*shape, generator=generator).to(device)
    ids = torch.randint(0, cfg.text.vocab_size, (F, 77), generator=generator).to(device)
    with torch.inference_mode():
        cate_text = model.encode_text(ids)
        null_text = model.encode_text(torch.zeros_like(ids[:1]))[0]
    return GenerationInputs(
        init_latents=rand(F, s, s, C),
        outfit_idx=torch.zeros(F, dtype=torch.long, device=device),
        known_latents=rand(1, F, s, s, C) * 0.2,
        gen_mask=torch.ones(1, F, dtype=torch.bool, device=device),
        gen_index=torch.arange(F, device=device).view(1, F),
        hist_latents=rand(F, s, s, C) * 0.2,
        cate_text=cate_text,
        null_text=null_text,
        null_latent=rand(s, s, C) * 0.05,
    )


def phase_reference():
    """The whole generation path at the tiny config (20 steps, 4-branch CFG):
    on the card in fp16 through the kernel, against the port's CPU run in
    fp32 of the same weights and inputs, which the CPU tests hold against the
    JAX package and the committed torch-oracle trajectories."""
    import copy

    import torch

    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.engine.generate import (
        build_sampler,
        decode_to_uint8,
        make_guidance_spec,
    )
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.attention import CrossAttention, VAEAttention

    cpu = create_difashion(ModelConfig.tiny(), seed=0, device="cpu")
    # 21 UNet forwards, then the decoder's mid-attention (d = 32 at this size)
    expect = (21 * sum(isinstance(m, CrossAttention) for m in cpu.unet.modules())
              + sum(isinstance(m, VAEAttention) for m in cpu.vae.decoder.modules()))
    runs = (("cpu", cpu, "cpu"),
            ("cpu_fp16", copy.deepcopy(cpu).to(torch.float16), "cpu"),
            ("cuda", copy.deepcopy(cpu).to("cuda", torch.float16), "cuda"))
    out = {}
    for name, model, dev in runs:
        inputs = gor_inputs(model, torch.Generator().manual_seed(0), dev)
        sampler = build_sampler(model, num_inference_steps=20,
                                spec=make_guidance_spec(*CFG_SCALES), eta=ETA)
        kernels.reset_launches()
        latents = sampler(inputs)
        out[name] = (latents.cpu(), decode_to_uint8(model, latents).cpu(),
                     kernels.LAUNCHES["flash_attention_fwd"])
    ref, ref_img, _ = out["cpu"]

    def diff(name):
        lat, img, _ = out[name]
        pix = (img.int() - ref_img.int()).abs().float()
        return ((lat - ref).norm() / ref.norm()).item(), pix.mean().item(), pix.max().item()

    rel, pix_mean, pix_max = diff("cuda")
    floor = diff("cpu_fp16")
    launches = out["cuda"][2]
    emit({"phase": "reference", "config": "tiny", "steps": 20, "dtype": "float16",
          "latents_rel_l2_vs_cpu_fp32": rel, "image_mean_abs_diff": pix_mean,
          "image_max_abs_diff": pix_max, "cpu_fp16_rel_l2_vs_cpu_fp32": floor[0],
          "cpu_fp16_image_mean_abs_diff": floor[1], "kernel_launches": launches,
          "expected_launches": expect})
    # fp16 rounding through 21 guided steps at CFG scale 12 moves the result;
    # the CPU's own fp16 run, printed beside, shows by how much
    if not (rel <= REF_REL_L2_TOL and pix_mean <= REF_PIXEL_TOL and launches == expect):
        raise AssertionError(f"tiny main path on the card vs CPU fp32: rel L2 {rel}, "
                             f"mean pixel diff {pix_mean}, {launches} launches")


def run_main_path(model, seed=42):
    """Text encoding, 50-step PNDM GOR sampling and the decode to uint8 of one
    outfit (F = 4), inputs as bench.py builds them. Returns (images, final
    latents, {phase: ms})."""
    import torch

    from difashion_tpu_torch.engine.generate import (
        GenerationInputs,
        build_sampler,
        decode_to_uint8,
        make_guidance_spec,
    )

    cfg = model.config
    B, olen = 1, 4
    F = B * olen
    s, C = cfg.unet.sample_size, cfg.vae.latent_channels
    dev = torch.device("cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    init = torch.randn(F, s, s, C, generator=gen, device=dev)
    ev[0].record()
    with torch.inference_mode():
        cate_text = model.encode_text(torch.zeros(F, 77, dtype=torch.long, device=dev))
        null_text = model.encode_text(torch.zeros(1, 77, dtype=torch.long, device=dev))[0]
    inputs = GenerationInputs(
        init_latents=init,
        outfit_idx=torch.arange(B, device=dev).repeat_interleave(olen),
        known_latents=torch.zeros(B, olen, s, s, C, device=dev),
        gen_mask=torch.ones(B, olen, dtype=torch.bool, device=dev),
        gen_index=torch.arange(F, device=dev).view(B, olen),
        hist_latents=torch.zeros(F, s, s, C, device=dev),
        cate_text=cate_text,
        null_text=null_text,
        null_latent=torch.zeros(s, s, C, device=dev),
    )
    sampler = build_sampler(model, num_inference_steps=STEPS,
                            spec=make_guidance_spec(*CFG_SCALES), eta=ETA)
    ev[1].record()
    latents = sampler(inputs)
    ev[2].record()
    images = decode_to_uint8(model, latents)
    ev[3].record()
    torch.cuda.synchronize()
    names = ("text_ms", "sampler_ms", "decode_ms")
    return images, latents, {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def phase_main_path(model):
    import torch

    from difashion_tpu_torch.nn import kernels

    run_main_path(model, seed=7)                  # warm-up: allocator, cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    images, latents, ms = run_main_path(model)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    seconds = sum(ms.values()) / 1e3
    finite = bool(torch.isfinite(latents).all())
    expect = (STEPS + 1) * 32
    emit({"phase": "main_path", "config": "sd2_base", "dtype": "bfloat16",
          "mode": "GOR", "outfits": 1, "items": 4, "steps": STEPS,
          "unet_forwards": STEPS + 1, "cfg_branches": 4, "eta": ETA,
          "images_shape": list(images.shape), "images_dtype": str(images.dtype),
          "latents_finite": finite, "launches": launches,
          "expected_flash_launches": expect, "seconds_per_outfit": seconds,
          "wall_seconds": wall, **ms, "ms_per_unet_step": ms["sampler_ms"] / (STEPS + 1),
          "peak_memory_bytes": peak})
    if tuple(images.shape) != (4, 512, 512, 3) or images.dtype != torch.uint8:
        raise AssertionError(f"main path images {tuple(images.shape)} {images.dtype}")
    if not finite:
        raise AssertionError("main path latents are not finite")
    if launches["flash_attention_fwd"] != expect:
        raise AssertionError(f"flash_attention_fwd launched {launches} times, "
                             f"expected {expect}")
    missed = [k for k, n in launches.items() if n == 0]
    if missed:
        raise AssertionError(f"kernels of the main path never launched: {missed}")
    return launches


# CUDA kernel names -> what they do, first match wins
PROFILE_CATEGORIES = [
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("layout NCHW<->NHWC", ("nchwToNhwc", "nhwcToNchw")),
    ("norm statistics", ("layer_norm", "RowwiseMoments", "group_norm", "GroupNorm")),
    ("convolution", ("fprop", "implicit_gemm", "conv", "cudnn")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas")),
    ("elementwise and copies", ("elementwise", "copy", "reduce", "cat")),
]


def phase_profile(model):
    """Device time of one UNet forward by CUDA kernel (torch.profiler), and the
    device's busy share against the host time of an unprofiled forward."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = model.config.unet
    gen = torch.Generator(device="cuda").manual_seed(2)
    s = cfg.sample_size
    x = torch.randn(UNET_BATCH, cfg.in_channels, s, s, generator=gen, device="cuda")
    t = torch.full((UNET_BATCH,), 501, device="cuda")
    ctx = torch.randn(UNET_BATCH, 77, cfg.cross_attention_dim, generator=gen, device="cuda")
    with torch.inference_mode():
        model.apply_unet(x, t, ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.apply_unet(x, t, ctx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.apply_unet(x, t, ctx)
            torch.cuda.synchronize()
    rows = sorted(((evt.self_device_time_total, evt.key, evt.count)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0),
                  reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    by_category = {}
    for us, key, _ in rows:
        cat = next((c for c, marks in PROFILE_CATEGORIES if any(m in key for m in marks)),
                   "other")
        by_category[cat] = by_category.get(cat, 0.0) + us / 1e3
    emit({"phase": "profile", "what": "one sd2_base UNet forward, batch 16, bf16",
          "host_wall_ms": wall_ms, "device_kernel_ms": device_ms,
          "device_busy_share": device_ms / wall_ms,
          "by_category_ms": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
          "top": [{"name": k[:100], "ms": us / 1e3, "calls": c} for us, k, c in rows[:15]]})


def kernels_line(results, launches):
    """One entry per kernel: its numbers summed over the calls of one UNet
    forward (every main-path site, times its calls); per-shape rows beside."""
    main = [r for r in results if r["calls_per_unet_forward"]]

    def total(key, rows=main):
        return sum(r[key] * r["calls_per_unet_forward"] for r in rows)

    bound = total("bound_ms")
    by_ops = total("bound_ms", [r for r in main if r["bound_by"] == "operations"])
    return {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "difashion_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "difashion_tpu/nn/pallas/flash_attention.py:50",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": total("kernel_ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": bound,
        "bound_by": "operations" if by_ops >= bound / 2 else "bytes",
        "library_ms": total("library_ms"),
        "per": f"one UNet forward ({sum(r['calls_per_unet_forward'] for r in main)} calls)",
        "shapes": [{k: r[k] for k in ("site", "shape_bhqkd", "calls_per_unet_forward",
                                      "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by", "max_abs_err")} for r in results],
    }]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA "
              "device", file=sys.stderr)
        sys.exit(2)
    # the port itself: without it (the script alone) this fails before any output
    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.models.difashion import create_difashion

    phase_device()
    phase_build()
    cfg = ModelConfig.sd2_base()
    sites = main_path_attention_sites(cfg)
    if sum(c for *_, c in sites) != 32:
        raise AssertionError(f"expected 32 attentions per UNet forward, got {sites}")
    results = phase_kernel(sites)
    phase_reference()
    model = create_difashion(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    phase_unet(model)
    launches = phase_main_path(model)
    phase_profile(model)
    emit(kernels_line(results, launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

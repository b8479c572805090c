#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`difashion_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

It drives the port's two paths at the sd2_base widths through the entry
points a user calls, DiFashion's GOR generation and its training step, and
checks every hand-written kernel of those paths against its plain PyTorch
version. Phases, one JSON line each:

  1. device: the card (and its name and power limit as nvidia-smi prints
     them, on a line of their own); TF32 off wherever fp32 is compared;
  2. build: every kernel compiled from `difashion_tpu_torch/csrc/` with nvcc,
     one process per source, all at once;
  3. kernel: the flash-attention forward kernel against its plain version at
     the shapes of the sampler's UNet attentions (batch 16 = 4 CFG branches x
     4 items) and a few short and ragged ones, with its time, the plain
     version's, one library call's (F.scaled_dot_product_attention, timed as
     a yardstick only) and the card's lower bound for the same work;
  4. reference: the whole generation path at the tiny config on the card
     (fp16) against the port's CPU fp32 run of the same weights and inputs;
  5. unet: one full-width sd2_base UNet forward (bf16, seeded weights, batch
     16) with attention through the kernel against one through the plain
     version;
  6. main_path: GOR, 1 outfit of 4 items, 4-branch CFG (12 / 4 / 5),
     eta 0.1, 50-step PNDM (51 UNet forwards), text encoding and the decode
     to uint8 at 512 px; the launch counts of that run (no backward launch);
  7. profile: the CUDA kernels of one UNet forward by device time;
  8. kernel_bwd: the dQ and dK/dV kernels against the plain backward at the
     training UNet's attention shapes (batch 8 = 2 outfits x 4 items) and the
     ragged ones, both held against the plain backward in fp32, with their
     times, the plain versions', the library backward's and the bounds;
  9. train_reference: the training loss and its gradients at the tiny config
     with injected draws, on the card in bf16 autocast through all three
     kernels, against the CPU in fp32 (the CPU's own bf16 run beside);
 10. unet_grad: one full-width UNet forward and backward at batch 4 in bf16
     autocast, attention through the kernels against the plain versions, on
     the gradient of every parameter, both against an fp32 run;
 11. train: the sd2_base recipe through `engine/train.py::build_train_step`
     (fp32 master weights, bf16 autocast, AdamW, EMA, min-SNR, batch 2 x 4),
     2 warm-up and 10 timed steps, with the launches of every step; then one
     step with gradient checkpointing and one with 8-bit AdamW;
 12. profile_train: one training step by CUDA kernel and its split into
     forward, backward and optimizer/EMA.

Then the kernels line, and last {"ok": true, "device": {...}}. Any failed check
raises and the script exits non-zero; without a CUDA device it exits 2.
"""
import json
import math
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
TRAIN_ROWS = 8      # the recipe's 2 outfits x 4 items
UNET_GRAD_BATCH = 4

# Backward kernels vs the plain backward, bf16 inputs, both held against the
# plain backward in fp32. The plain version rounds P and dS to bf16 where the
# kernels do, so the two bf16 runs differ by the order of their fp32 sums and
# ex2.approx only: the kernel may be no farther from fp32 than 1.25x the
# plain run. And at most 2e-2 relative L2 per gradient: bf16 keeps 8
# significant bits (unit roundoff 2^-9 = 2e-3); products of P and dS rounded
# to bf16 and summed in fp32 land at a few 1e-3, and the margin covers the
# cancellation in sums of dS, whose rows sum to zero.
BWD_REL_L2_TOL, VS_PLAIN = 2e-2, 1.25
# train_reference: the card's bf16 run vs CPU fp32 may be at most twice as far
# as the CPU's own bf16 run (torch's CPU and CUDA autocast cast different op
# lists to bf16); the loss within 1e-2 (a mean of 2048 squared bf16 errors)
TRAIN_REF_FACTOR, TRAIN_REF_LOSS_TOL = 2.0, 1e-2
# train: EMA moves by (1 - d) of the way to the new parameters; fp32 rounding
# of parameters ~0.05 against steps of ~1e-5 leaves ~1e-3 of that fraction
EMA_FRACTION_TOL = 1e-2
CFG_SCALES = (12.0, 4.0, 5.0)
STEPS = 50
ETA = 0.1


def emit(obj):
    print(json.dumps(obj), flush=True)


def main_path_attention_sites(cfg, batch):
    """(name, B, H, Sq, Skv, D, calls per UNet forward) of every attention of
    one UNet forward over `batch` rows: self- and cross-attention at each
    latent level."""
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
            sites.append((f"self_{s}", batch, heads, s, s, ch // heads, down + up))
            sites.append((f"cross_{s}x77", batch, heads, s, 77, ch // heads, down + up))
    ch = u.block_out_channels[-1]
    heads = u.fixed_num_heads or ch // u.attention_head_dim
    s = (side >> (len(u.block_out_channels) - 1)) ** 2
    sites.append((f"mid_self_{s}", batch, heads, s, s, ch // heads, 1))
    sites.append((f"mid_cross_{s}x77", batch, heads, s, 77, ch // heads, 1))
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


def backward_bound(kind, b, h, sq, skv, d):
    """(bound ms, 'operations' or 'bytes', ops, bytes) of one backward kernel:
    dQ is 3 products (6*B*H*Sq*Skv*d operations), dK/dV 4 (8*B*H*Sq*Skv*d);
    q, k, v and dO read once in bf16, the LSE and D once in fp32, the
    kernel's gradients written once in bf16."""
    products = 3 if kind == "dq" else 4
    ops = 2.0 * products * b * h * sq * skv * d
    written = sq if kind == "dq" else 2 * skv
    nbytes = 2.0 * b * h * d * (2 * sq + 2 * skv + written) + 8.0 * b * h * sq
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


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


def phase_kernel_bwd(sites):
    """The dQ and dK/dV kernels at the training UNet's attention shapes and the
    ragged ones: q, k, v in the projections' [B, S, H, D] layout, a random
    cotangent (never all ones), O and the LSE from the forward kernel. Both
    the kernels and the plain backward run on the same bf16 inputs and are
    held against the plain backward in fp32 of the same values."""
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn.kernels.flash_attention import (
        attention_delta,
        flash_attention,
        flash_attention_bwd_ref,
        flash_attention_dkv,
        flash_attention_dkv_ref,
        flash_attention_dq,
        flash_attention_dq_ref,
        flash_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    results = []
    shapes = list(sites) + [(n, b, h, sq, skv, d, 0) for n, b, h, sq, skv, d in EXTRA_SHAPES]
    for name, b, h, sq, skv, d, calls in shapes:
        proj = lambda s: (torch.randn(b, s, h * d, generator=gen, device="cuda")
                          .to(torch.bfloat16).view(b, s, h, d).transpose(1, 2))
        q, k, v, do = proj(sq), proj(skv), proj(skv), proj(sq)
        scale = d ** -0.5
        o, lse = flash_attention(q, k, v)
        delta = attention_delta(o, do)
        args = (q, k, v, do, lse, delta, scale)
        kern = (flash_attention_dq(*args),) + flash_attention_dkv(*args)
        torch.cuda.synchronize()
        plain = (flash_attention_dq_ref(*args),) + flash_attention_dkv_ref(*args)
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        o32, lse32 = flash_attention_ref(q32, k32, v32)
        ref = flash_attention_bwd_ref(q32, k32, v32, o32, lse32, do32, scale)
        errs = {g: {"kernel_vs_fp32": rel_l2(kg, r), "plain_vs_fp32": rel_l2(pg, r),
                    "max_abs_err": (kg.float() - pg.float()).abs().max().item()}
                for g, kg, pg, r in zip(("dq", "dk", "dv"), kern, plain, ref)}
        finite = all(bool(torch.isfinite(t).all()) for t in kern)
        del plain, ref, q32, k32, v32, do32, o32, lse32
        torch.cuda.empty_cache()
        ok = finite and all(e["kernel_vs_fp32"] <= BWD_REL_L2_TOL
                            and e["kernel_vs_fp32"] <= VS_PLAIN * e["plain_vs_fp32"]
                            for e in errs.values())
        row = {"phase": "kernel_bwd", "site": name, "shape_bhqkd": [b, h, sq, skv, d],
               "calls_per_train_step": calls, "errors": errs, "finite": finite,
               "dq_max_abs_err": errs["dq"]["max_abs_err"],
               "dkv_max_abs_err": max(errs["dk"]["max_abs_err"], errs["dv"]["max_abs_err"]),
               "dq_ms": device_ms(lambda: flash_attention_dq(*args)),
               "dkv_ms": device_ms(lambda: flash_attention_dkv(*args)),
               "delta_ms": device_ms(lambda: attention_delta(o, do)),
               "dq_plain_ms": device_ms(lambda: flash_attention_dq_ref(*args), reps=10, warmup=1),
               "dkv_plain_ms": device_ms(lambda: flash_attention_dkv_ref(*args), reps=10,
                                         warmup=1)}
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
        row["library_ms"] = device_ms(
            lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True))
        del ol, ql, kl, vl
        for kind in ("dq", "dkv"):
            bound_ms, bound_by, ops, nbytes = backward_bound(kind, b, h, sq, skv, d)
            row.update({f"{kind}_bound_ms": bound_ms, f"{kind}_bound_by": bound_by,
                        f"{kind}_tflops": ops / row[f"{kind}_ms"] / 1e9,
                        f"{kind}_gbytes_per_s": nbytes / row[f"{kind}_ms"] / 1e6})
        row["ok"] = ok
        emit(row)
        results.append(row)
        del q, k, v, do, o, lse, delta, kern, args
        torch.cuda.empty_cache()
    bad = [r["site"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash backward kernels disagree with the plain backward at {bad}")
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


def phase_train_reference():
    """The training loss and the gradient of every trainable parameter at the
    tiny config with injected draws (the inputs the CPU tests hold against
    the JAX package): on the card in bf16 autocast through the three kernels,
    against the port's CPU run in fp32 of the same weights and inputs; the
    CPU's own bf16-autocast run beside, as the floor."""
    import copy

    import numpy as np
    import torch

    from difashion_tpu_torch.config import ModelConfig, TrainConfig
    from difashion_tpu_torch.engine.train import TrainBatch, difashion_loss
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.attention import CrossAttention

    cfg, tc = ModelConfig.tiny(), TrainConfig()
    cpu = create_difashion(cfg, seed=0, device="cpu").prepare_for_training()
    n_attn = sum(isinstance(m, CrossAttention) for m in cpu.unet.modules())
    rng = np.random.RandomState(0)
    B, olen, h, C = 2, 4, cfg.unet.sample_size, cfg.vae.latent_channels
    n = B * olen
    f32 = lambda x: np.asarray(x, np.float32)
    x = {"mean": f32(rng.randn(B, olen, h, h, C) * 2), "logvar": f32(rng.uniform(-8, -2, (B, olen, h, h, C))),
         "hist": f32(rng.randn(B, olen, h, h, C) * 0.3), "null_latent": f32(rng.randn(h, h, C) * 0.05),
         "ids": rng.randint(0, cfg.text.vocab_size, (B, olen, 77)),
         "enc_eps": f32(rng.randn(n, h, h, C)), "noise": f32(rng.randn(n, h, h, C)),
         "t_outfit": rng.randint(0, 1000, (B,)), "p_mask": f32(rng.uniform(0, 1, n)),
         "p_cate": f32(rng.uniform(0, 1, n))}

    def run(model, dev, bf16):
        t = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
        batch = TrainBatch(None, t["mean"], t["logvar"], t["ids"].long(), t["hist"])
        with torch.no_grad():
            null_text = model.encode_text(torch.zeros(1, 77, dtype=torch.long, device=dev))[0]
        for p in model.parameters():
            p.grad = None
        kernels.reset_launches()
        with torch.autocast(dev, dtype=torch.bfloat16, enabled=bf16):
            loss, _ = difashion_loss(model, batch, t["null_latent"], null_text, None, tc,
                                     injected={k: t[k] for k in ("enc_eps", "noise", "t_outfit",
                                                                 "p_mask", "p_cate")})
        loss.backward()
        launches = dict(kernels.LAUNCHES)
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float()
                           .reshape(-1) for _, p in model.trainable_parameters()]).cpu()
        return loss.item(), grads, launches

    ref_loss, ref_grads, _ = run(cpu, "cpu", False)
    cpu_loss, cpu_grads, _ = run(copy.deepcopy(cpu), "cpu", True)
    loss, grads, launches = run(copy.deepcopy(cpu).to("cuda"), "cuda", True)
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    grad_rel, floor = rel_l2(grads, ref_grads), rel_l2(cpu_grads, ref_grads)
    expect = {name: n_attn for name in kernels.LAUNCHES}
    finite = bool(np.isfinite(loss) and torch.isfinite(grads).all())
    emit({"phase": "train_reference", "config": "tiny", "dtype": "bfloat16 autocast",
          "loss_cpu_fp32": ref_loss, "loss_cuda_bf16": loss, "loss_rel_diff": loss_rel,
          "grad_rel_l2_vs_cpu_fp32": grad_rel,
          "cpu_bf16_loss_rel_diff": abs(cpu_loss - ref_loss) / abs(ref_loss),
          "cpu_bf16_grad_rel_l2_vs_cpu_fp32": floor, "finite": finite,
          "kernel_launches": launches, "expected_launches": expect})
    if not (finite and launches == expect and loss_rel <= TRAIN_REF_LOSS_TOL
            and grad_rel <= TRAIN_REF_FACTOR * floor):
        raise AssertionError(f"tiny training loss on the card vs CPU fp32: loss {loss_rel}, "
                             f"gradients {grad_rel} (CPU bf16 {floor}), launches {launches}")


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
    # generation runs under inference_mode: the forward kernel alone, no backward
    want = {"flash_attention_fwd": expect, "flash_attention_dq": 0, "flash_attention_dkv": 0}
    if launches != want:
        raise AssertionError(f"main path launches {launches}, expected {want}")
    return launches


# CUDA kernel names -> what they do, first match wins
PROFILE_CATEGORIES = [
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("flash_attention_dq", ("flash_dq_kernel",)),
    ("flash_attention_dkv", ("flash_dkv_kernel",)),
    ("layout NCHW<->NHWC", ("nchwToNhwc", "nhwcToNchw")),
    ("norm statistics", ("layer_norm", "RowwiseMoments", "group_norm", "GroupNorm")),
    ("convolution", ("fprop", "dgrad", "wgrad", "implicit_gemm", "conv", "cudnn")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas")),
    ("optimizer and EMA (foreach)", ("multi_tensor_apply", "foreach")),
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


def phase_unet_grad(model):
    """One full-width UNet forward and backward at batch 4 under bf16 autocast
    over fp32 weights, with a random cotangent on the output: attention
    through the three kernels against attention through the plain versions,
    on the gradient of every UNet parameter; and both against an fp32 run
    with plain attention, which shows the bf16 noise floor they share."""
    import torch

    from difashion_tpu_torch.nn import kernels

    unet = model.unet
    cfg = unet.config
    gen = torch.Generator(device="cuda").manual_seed(4)
    s, b = cfg.sample_size, UNET_GRAD_BATCH
    x = torch.randn(b, cfg.in_channels, s, s, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    ctx = torch.randn(b, 77, cfg.cross_attention_dim, generator=gen, device="cuda")
    ct = torch.randn(b, cfg.out_channels, s, s, generator=gen, device="cuda")

    def grads(bf16, plain):
        for p in unet.parameters():
            p.grad = None
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
            out = unet(x, t, ctx, plain_attention=plain)
        out.float().backward(ct)
        g = torch.cat([p.grad.reshape(-1) for p in unet.parameters()])
        for p in unet.parameters():
            p.grad = None
        return g

    kernels.reset_launches()
    fast = grads(True, False)
    launches = dict(kernels.LAUNCHES)
    plain = grads(True, True)
    ref = grads(False, True)
    torch.cuda.synchronize()
    fast_ref, plain_ref = rel_l2(fast, ref), rel_l2(plain, ref)
    finite = bool(torch.isfinite(fast).all() and torch.isfinite(plain).all())
    emit({"phase": "unet_grad", "config": "sd2_base", "dtype": "bfloat16 autocast",
          "batch": b, "grad_elements": fast.numel(), "rel_l2": rel_l2(fast, plain),
          "kernel_vs_fp32_rel_l2": fast_ref, "plain_vs_fp32_rel_l2": plain_ref,
          "finite": finite, "kernel_launches": launches})
    del fast, plain, ref
    torch.cuda.empty_cache()
    want = {name: 32 for name in launches}
    if not (finite and launches == want and fast_ref <= VS_PLAIN * plain_ref):
        raise AssertionError(f"UNet gradient kernel vs plain: vs fp32 {fast_ref} / {plain_ref}, "
                             f"finite {finite}, launches {launches}")


def train_inputs(model, tc, seed):
    """`n` synthetic moment batches of the recipe's shape (train_batch_size
    outfits x 4 items, latents as the VAE's moments) and the null
    conditions, made on the card from `seed`."""
    import torch

    from difashion_tpu_torch.engine.train import TrainBatch

    cfg = model.config
    s, C = cfg.unet.sample_size, cfg.vae.latent_channels
    B, olen = tc.train_batch_size, 4
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")

    def batch():
        return TrainBatch(
            images=None, latent_mean=r(B, olen, s, s, C) * 4.0,
            latent_logvar=torch.rand(B, olen, s, s, C, generator=gen, device="cuda") * 6 - 8,
            input_ids=torch.randint(0, cfg.text.vocab_size, (B, olen, 77), generator=gen,
                                    device="cuda"),
            hist_latents=r(B, olen, s, s, C) * 0.3)
    with torch.no_grad():
        null_text = model.encode_text(torch.zeros(1, 77, dtype=torch.long, device="cuda"))[0]
    return batch, r(s, s, C) * 0.05, null_text


TRAIN_WARMUP, TRAIN_STEPS = 2, 10


def phase_train(model):
    """The sd2_base recipe (TrainConfig defaults: fp32 master weights, bf16
    autocast, AdamW lr 1e-5, clip 1.0, EMA, min-SNR 5, the dropout windows,
    eta 0.1, 2 outfits x 4 items) through build_train_step: warm-up steps,
    then timed steps with CUDA events and the launches of each step; then one
    step with gradient checkpointing and one with 8-bit AdamW."""
    import torch

    from difashion_tpu_torch.config import TrainConfig
    from difashion_tpu_torch.engine.train import build_train_step, ema_decay_schedule
    from difashion_tpu_torch.nn import kernels

    tc = TrainConfig()
    batch, null_latent, null_text = train_inputs(model, tc, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(tc.seed)
    step, init = build_train_step(model, tc)
    state = init()
    n_params = sum(p.numel() for p in state.params)
    state_bytes = sum(t.numel() * t.element_size() for t in
                      state.params + state.opt_state.mu + state.opt_state.nu + state.ema.params)
    batches = [batch() for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    for i in range(TRAIN_WARMUP):
        state, _ = step(state, batches[i], null_latent, null_text, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    watch = state.names.index("unet.conv_in.weight")
    before = state.params[watch].detach().clone()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    rows = []
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:
            ema_before = state.ema.params[watch].clone()
            decay = ema_decay_schedule(state.ema.step, tc.ema_decay)
        kernels.reset_launches()
        state, m = step(state, batches[TRAIN_WARMUP + i], null_latent, null_text, gen)
        ev[i + 1].record()
        rows.append((m, dict(kernels.LAUNCHES)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TRAIN_STEPS)]
    per_step = [{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 "update_skipped": m["update_skipped"], "ms": ms, "launches": launches}
                for (m, launches), ms in zip(rows, step_ms)]
    p_after = state.params[watch].detach()
    moved = (state.ema.params[watch] - ema_before).norm() / (p_after - ema_before).norm()
    ema_fraction = moved.item()
    params_changed = not torch.equal(before, p_after)
    want = {"flash_attention_fwd": 32, "flash_attention_dq": 32, "flash_attention_dkv": 32}
    seconds = sum(step_ms) / TRAIN_STEPS / 1e3
    emit({"phase": "train", "config": "sd2_base", "recipe": "TrainConfig()",
          "dtype": "fp32 weights, bf16 autocast", "rows_per_step": TRAIN_ROWS,
          "trainable_params": n_params, "state_bytes": state_bytes,
          "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
          "seconds_per_step": seconds, "images_per_second": TRAIN_ROWS / seconds,
          "wall_seconds": wall, "peak_memory_bytes": peak, "per_step": per_step,
          "params_changed": params_changed, "ema_fraction": ema_fraction,
          "expected_ema_fraction": 1.0 - decay})
    bad = [r for r in per_step if not (r["launches"] == want and r["update_skipped"] == 0.0
                                       and math.isfinite(r["loss"])
                                       and math.isfinite(r["grad_norm"]))]
    if bad or not params_changed or abs(ema_fraction - (1 - decay)) > EMA_FRACTION_TOL * (1 - decay):
        raise AssertionError(f"train: bad steps {bad}, params changed {params_changed}, "
                             f"EMA fraction {ema_fraction} vs {1 - decay}")
    train_launches = rows[-1][1]
    del state, rows
    variants = [("gradient_checkpointing", TrainConfig(gradient_checkpointing=True),
                 dict(want, flash_attention_fwd=64)),
                ("use_8bit_adam", TrainConfig(use_8bit_adam=True), want)]
    for name, vc, vwant in variants:
        for p in model.parameters():
            p.grad = None
        torch.cuda.empty_cache()
        vstep, vinit = build_train_step(model, vc)
        vstate = vinit()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        vstate, m = vstep(vstate, batches[0], null_latent, null_text, gen)
        torch.cuda.synchronize()
        row = {"phase": "train", "variant": name, "remat_policy": vc.remat_policy
               if vc.gradient_checkpointing else None, "first_step_seconds":
               time.perf_counter() - t0, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "update_skipped": m["update_skipped"], "launches": dict(kernels.LAUNCHES)}
        emit(row)
        del vstate
        if not (row["launches"] == vwant and row["update_skipped"] == 0.0
                and math.isfinite(row["loss"])):
            raise AssertionError(f"train variant {name}: {row}")
    model.unet.set_gradient_checkpointing(False)
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    return train_launches


def phase_profile_train(model):
    """One recipe step by CUDA kernel (torch.profiler) with the device's busy
    share against the host time of an unprofiled step; and the step split
    into forward (the loss), backward and optimizer/EMA by CUDA events around
    the train step's own pieces (`difashion_loss`, `backward`,
    `apply_gradients`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from difashion_tpu_torch.config import TrainConfig
    from difashion_tpu_torch.engine.train import (
        apply_gradients,
        autocast,
        build_train_step,
        difashion_loss,
        make_optimizer,
    )

    tc = TrainConfig()
    batch, null_latent, null_text = train_inputs(model, tc, seed=8)
    b = batch()
    gen = torch.Generator(device="cuda").manual_seed(1)
    step, init = build_train_step(model, tc)
    state = init()
    optimizer = make_optimizer(tc)
    state, _ = step(state, b, null_latent, null_text, gen)
    splits = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in state.params:
            p.grad = None
        ev[0].record()
        with autocast(model, tc):
            loss, _ = difashion_loss(model, b, null_latent, null_text, gen, tc)
        ev[1].record()
        loss.backward()
        ev[2].record()
        apply_gradients(state, [p.grad if p.grad is not None else torch.zeros_like(p)
                                for p in state.params], optimizer, tc)
        ev[3].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    split = {k: statistics.median(s[i] for s in splits)
             for i, k in enumerate(("forward_ms", "backward_ms", "optimizer_ema_ms"))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, b, null_latent, null_text, gen)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, b, null_latent, null_text, gen)
        torch.cuda.synchronize()
    rows = sorted(((evt.self_device_time_total, evt.key, evt.count)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0),
                  reverse=True)
    device_ms_total = sum(r[0] for r in rows) / 1e3
    by_category = {}
    for us, key, _ in rows:
        cat = next((c for c, marks in PROFILE_CATEGORIES if any(m in key for m in marks)),
                   "other")
        by_category[cat] = by_category.get(cat, 0.0) + us / 1e3
    emit({"phase": "profile_train", "what": "one sd2_base recipe step, 2 x 4 rows",
          "split_ms": split, "host_wall_ms": wall_ms, "device_kernel_ms": device_ms_total,
          "device_busy_share": device_ms_total / wall_ms,
          "by_category_ms": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
          "top": [{"name": k[:100], "ms": us / 1e3, "calls": c} for us, k, c in rows[:20]]})
    del state
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()


def kernel_entry(name, rows, calls, prefix, per, launches, **extra):
    """A kernel's entry of the kernels line: its numbers (`<prefix>ms`,
    `<prefix>plain_ms`, `<prefix>bound_ms`, `library_ms`) summed over the
    calls of its path's sites (`rows[calls]` each), its largest error over
    every shape, and the per-shape rows."""
    main = [r for r in rows if r[calls]]
    total = lambda key, rs=main: sum(r[key] * r[calls] for r in rs)
    bound = total(f"{prefix}bound_ms")
    by_ops = total(f"{prefix}bound_ms",
                   [r for r in main if r[f"{prefix}bound_by"] == "operations"])
    keys = ("site", "shape_bhqkd", calls, f"{prefix}ms", f"{prefix}plain_ms", "library_ms",
            f"{prefix}bound_ms", f"{prefix}bound_by", f"{prefix}max_abs_err")
    return {"name": name, "route": "cuda", "source": f"difashion_tpu_torch/csrc/{name}.cu",
            "replaces": extra.pop("replaces"), "launches": launches,
            "max_abs_err": max(r[f"{prefix}max_abs_err"] for r in rows),
            "ms": total(f"{prefix}ms"), "plain_ms": total(f"{prefix}plain_ms"),
            "bound_ms": bound, "bound_by": "operations" if by_ops >= bound / 2 else "bytes",
            "library_ms": total("library_ms"),
            "per": f"{per} ({sum(r[calls] for r in main)} calls)", **extra,
            "shapes": [{k: r[k] for k in keys} for r in rows]}


def kernels_line(results, launches, bwd_results, train_launches):
    """The forward's numbers are per sampler UNet forward (batch 16) and its
    launches the main path's; the backward kernels' numbers are per train
    step (batch 8, one backward per attention) and their launches one train
    step's."""
    fwd_rows = [dict(r, ms=r["kernel_ms"]) for r in results]
    library = ("F.scaled_dot_product_attention's backward, computing dQ, dK and dV "
               "together: the same number on both backward entries")
    pallas = "difashion_tpu/nn/pallas/flash_attention.py:"
    return {"kernels": [
        kernel_entry("flash_attention_fwd", fwd_rows, "calls_per_unet_forward", "",
                     "one sampler UNet forward", launches["flash_attention_fwd"],
                     replaces=pallas + "50",
                     train_step_launches=train_launches["flash_attention_fwd"]),
        kernel_entry("flash_attention_dq", bwd_results, "calls_per_train_step", "dq_",
                     "one train step", train_launches["flash_attention_dq"],
                     replaces=pallas + "145", library=library,
                     main_path_launches=launches["flash_attention_dq"]),
        kernel_entry("flash_attention_dkv", bwd_results, "calls_per_train_step", "dkv_",
                     "one train step", train_launches["flash_attention_dkv"],
                     replaces=pallas + "191", library=library,
                     main_path_launches=launches["flash_attention_dkv"]),
    ]}


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
    sites = main_path_attention_sites(cfg, UNET_BATCH)
    if sum(c for *_, c in sites) != 32:
        raise AssertionError(f"expected 32 attentions per UNet forward, got {sites}")
    results = phase_kernel(sites)
    phase_reference()
    model = create_difashion(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    phase_unet(model)
    launches = phase_main_path(model)
    phase_profile(model)
    del model
    torch.cuda.empty_cache()
    # the training path, after the generation path: a backward leaves buffers
    # of its own (the autograd thread's cuBLAS workspace) that would count in
    # the main path's peak memory
    bwd_results = phase_kernel_bwd(main_path_attention_sites(cfg, TRAIN_ROWS))
    phase_train_reference()
    # fp32 master weights under bf16 autocast
    model = create_difashion(cfg, seed=0, device="cuda").prepare_for_training()
    phase_unet_grad(model)
    train_launches = phase_train(model)
    phase_profile_train(model)
    emit(kernels_line(results, launches, bwd_results, train_launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

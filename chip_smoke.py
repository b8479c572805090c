#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`difashion_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

It drives the port's four paths at the sd2_base widths through the entry
points a user calls, DiFashion's GOR generation, the generation service
(DPM-Solver++ at 20 steps, the fast-serving recipe), its training step and the
catalog precompute (VAE encode at 512 px), and checks every hand-written
kernel of those paths against its plain PyTorch version. Phases, one JSON
line each:

  1. device: the card (and its name and power limit as nvidia-smi prints
     them, on a line of their own); TF32 off wherever fp32 is compared;
  2. build: every kernel compiled from `difashion_tpu_torch/csrc/` with nvcc,
     one process per source, all at once;
  3. kernel: the flash-attention forward kernel against its plain version at
     the shapes of the sampler's UNet attentions (batch 16 = 4 CFG branches x
     4 items) and a few short and ragged ones, at the sd15 UNet's (batch 16,
     8 heads: 4096 tokens at d = 40, 1024 at d = 80, and their 77-token
     cross-attentions), all in bf16, and the fp32 kernel at the sampler's
     shapes in fp32; per site its time, the plain version's, one library
     call's (F.scaled_dot_product_attention, timed as a yardstick only), the
     card's lower bound for the same work and its share of it, TFLOP/s and
     the wrapper's host microseconds per call;
  3a. sd15_unet: one full-width sd15 UNet forward (bf16, seeded weights,
     batch 16) through the kernels against one through the plain versions
     (d = 40 and 80 on the forward kernel, d = 160 plain), both against fp32;
  3b. kernel_gn: the GroupNorm(+SiLU) kernel against its plain version at
     every distinct GroupNorm shape of the sampler's UNet forward (batch 16),
     the train step's (batch 8), the VAE decode (batch 4) and the VAE encode
     at the precompute batch (64, 2^31 elements at its first level), in bf16
     and fp32, with and without SiLU, with its time, the plain version's,
     the library's (F.group_norm then F.silu, a yardstick only) and the
     bound;
  3c. kernel_mm: the skinny-N matmul kernel against its plain version and
     an fp64 product at every distinct product that the Dense gate routes to
     it on the sampler's UNet (batch 16 and the service's 64), the train
     step's (batch 8, forward and dx), the VAE decode (4 and 16 images) and
     encode (64 and 8), in bf16 and fp16, with a bias and without one, with
     the weight as [N, K] and as [K, N]; then, in the layout the path uses
     (dx reads the stored weight as [K, N]), its tile width, its time with
     and without a bias, TFLOP/s, the bound's share, the plain version's
     time, the library's (torch.matmul, and F.linear with the bias;
     yardsticks only) and the bound; and the wrapper's host microseconds per
     call beside F.linear's and torch.matmul's;
  4. reference: the whole generation path at the tiny config on the card
     (fp16) against the port's CPU fp32 run of the same weights and inputs,
     with each scheduler: PNDM, DDIM (eta 0, and eta 0.5 with the same step
     noise fed to both) and DPM-Solver++;
  5. unet: one full-width sd2_base UNet forward (bf16, seeded weights, batch
     16) through the kernels against one through the plain versions;
  6. main_path: GOR, 1 outfit of 4 items, 4-branch CFG (12 / 4 / 5),
     eta 0.1, 50-step PNDM (51 UNet forwards), text encoding and the decode
     to uint8 at 512 px; the launch counts of that run (no backward launch,
     61 GroupNorms and 130 gated Dense products per UNet forward, 30
     GroupNorms and 4 products in the decode);
  7. profile: the CUDA kernels of one UNet forward by device time;
  7a. serve: `GenerationPipeline` + `GenerationService(max_batch=4)` at the
     sd2_base widths, DPM-Solver++ at 20 steps, 4-branch CFG: a GOR request
     (1 outfit padded to 16 fills, 64 UNet rows), a FITB request (3 outfits
     with 1 / 2 / 1 blanks, 4 fills), the same again (bit-identical), and
     its fills regrouped over two requests (the same images: bit-identical,
     or within REGROUP_MEAN_TOL where cuDNN's convolution rounds a row by its
     place in the batch); seconds per
     request, per UNet step, peak memory and the exact launches of each; one
     50-step DDIM GOR batch (eta 0); then a tiny checkpoint saved, restored
     and served on the card through the serve command's own functions
     (`--tiny --device cuda`) and its /healthz;
  7b. precompute: `data/precompute.py::encode_catalog` over 200 synthetic
     catalog items at 512 px (3 batches of 64 and one of 8) through the
     sd2_base VAE in bf16, then `build_processed_cache` on a synthetic
     outfit table and history; seconds per 1000 items, peak memory, 22
     GroupNorm launches per batch, and one batch's moments through the
     kernels and through the plain versions, both against fp32;
  8. kernel_bwd: the dQ and dK/dV kernels against the plain backward at the
     training UNet's attention shapes (batch 8 = 2 outfits x 4 items) and the
     ragged ones, both held against the plain backward in fp32, with their
     times, the plain versions', the library backward's, the bounds and each
     kernel's share of its bound, the dK/dV split count and the wrapper's
     host microseconds per call, also at sd15's training shapes (d = 40 and
     80, read in place); and the fp32 dQ and dK/dV kernels against the fp32
     plain backward at the training shapes;
  9. train_reference: the training loss and its gradients at the tiny config
     with injected draws, on the card in bf16 autocast through all three
     kernels, against the CPU in fp32 (the CPU's own bf16 run beside);
  9a. fp32_reference: the tiny path in fp32 (mixed_precision other than
     "bf16"): PNDM generation with the decode, and the training loss and
     gradients, every attention on the fp32 kernels, against the CPU in fp32;
 10. unet_grad: one full-width UNet forward and backward at batch 4 in bf16
     autocast, attention through the kernels against the plain versions, on
     the gradient of every parameter, both against an fp32 run;
 11. train: the sd2_base recipe through `engine/train.py::build_train_step`
     (fp32 master weights, bf16 autocast, AdamW, EMA, min-SNR, batch 2 x 4),
     2 warm-up and 10 timed steps, with the launches of every step (the
     skinny-N kernel forward and for dx); the Dense route's cost: steps with
     the route as shipped and with every Dense.forward bound to
     nn.Linear.forward (here only, as a yardstick), in turns; then one step
     with gradient checkpointing, one with 8-bit AdamW and one on an image
     batch (the VAE encoder inside the step);
 12. profile_train: one training step by CUDA kernel and its split into
     forward, backward and optimizer/EMA.

Then the kernels line, and last {"ok": true, "device": {...}}. Any failed check
raises and the script exits non-zero; without a CUDA device it exits 2.
"""
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12      # outside the tensor cores: the fp32 kernels use no tf32
PEAK_HBM_BYTES = 3.35e12

# kernel vs plain, bf16 inputs: P is rounded to bf16 before the PV product
# (as in the TPU kernel); the plain version keeps it in fp32. The bound of
# tests/test_flash_attention.py::test_flash_bf16_precision.
MAX_ABS_TOL, MEAN_ABS_TOL = 3e-2, 3e-3
# the LSE is fp32 from the same bf16 products: ex2.approx and another
# summation order only
LSE_TOL = 1e-3
# the fp32 kernels vs their plain versions in fp32 (no tf32 on either side):
# fp32 sums in another order and exp2f for exp. The forward's O and LSE
# within 2e-5; a backward gradient within 2e-5 relative L2 (sums of up to
# 4096 terms: about sqrt(4096) * 2^-24 = 4e-6, with margin)
F32_TOL = 2e-5
# the tiny path in fp32 on the card vs the CPU's fp32 run: the same
# arithmetic in fp32 (TF32 off for matmuls and convolutions) with sums in
# another order, through 20 guided steps at CFG scale 12 (latents), and the
# loss and gradients of one training step: measured at 1.4e-6 and 1e-6 on an
# H100, two orders of magnitude of margin
F32_REF_TOL = 1e-4
UNET_REL_L2_TOL = 1e-2
REF_REL_L2_TOL, REF_PIXEL_TOL = 2e-2, 1.0

UNET_BATCH = 16     # 4 CFG branches x 4 items
TRAIN_ROWS = 8      # the recipe's 2 outfits x 4 items
UNET_GRAD_BATCH = 4
SERVE_ROWS = 64     # the GOR request: 16 fills (max_batch 4 x 4 items) x 4 branches

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
# GroupNorm kernel vs plain: fp32 within 1e-5 (+ 1e-5 relative), the same
# fp32 statistics summed in another order. bf16 within one unit in the last
# place of the plain version's rounding, of y or, after SiLU, of the y it was
# computed from (2^-7 of the value), plus 1e-5 for the fp32 rounding of
# x * a + b near zero. The precompute's moments through the kernels may be no
# farther from fp32 than 1.25x the plain versions' (VS_PLAIN).
GN_TOL = 1e-5
GN_BF16_ULP = 2.0 ** -7
DECODE_BATCH = 4           # the main path's 4 items
PRECOMPUTE_BATCH = 64      # encode_catalog's default, the reference's batch
PRECOMPUTE_ITEMS = 200     # 3 batches of 64 and a ragged one of 8
CFG_SCALES = (12.0, 4.0, 5.0)
STEPS = 50
ETA = 0.1


def emit(obj):
    print(json.dumps(obj), flush=True)


def all_counts(counts):
    """Every launch counter of `nn.kernels.LAUNCHES`: `counts`, the others 0."""
    from difashion_tpu_torch.nn import kernels

    return {name: counts.get(name, 0) for name in kernels.COUNTERS}


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


def attention_bound(b, h, sq, skv, d, dtype=None):
    """(bound ms, 'operations' or 'bytes', ops, bytes): two products of
    2*Sq*Skv*d each per (batch, head) at the tensor cores' bf16 rate (fp32's
    rate outside them for an fp32 call: no tf32); q, k, v read once, o
    written once in the input dtype, the LSE written once in fp32."""
    f32 = dtype is not None and str(dtype) == "torch.float32"
    ops = 4.0 * b * h * sq * skv * d
    nbytes = (4.0 if f32 else 2.0) * b * h * d * (2 * sq + 2 * skv) + 4.0 * b * h * sq
    t_ops = ops / (PEAK_FP32_FLOPS if f32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def backward_bound(kind, b, h, sq, skv, d, dtype=None):
    """(bound ms, 'operations' or 'bytes', ops, bytes) of one backward kernel:
    dQ is 3 products (6*B*H*Sq*Skv*d operations), dK/dV 4 (8*B*H*Sq*Skv*d),
    at the bf16 tensor-core rate (fp32's outside them for fp32); q, k, v and
    dO read once in the input dtype, the LSE and D once in fp32, the
    kernel's gradients written once in the input dtype."""
    f32 = dtype is not None and str(dtype) == "torch.float32"
    products = 3 if kind == "dq" else 4
    ops = 2.0 * products * b * h * sq * skv * d
    written = sq if kind == "dq" else 2 * skv
    nbytes = (4.0 if f32 else 2.0) * b * h * d * (2 * sq + 2 * skv + written) + 8.0 * b * h * sq
    t_ops = ops / (PEAK_FP32_FLOPS if f32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
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
    # registers, spills and warnings (a setmaxnreg the compiler ignored)
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "warning" in ln]
             for name, log in logs.items()}
    # bytes of spill stores summed over each source's instantiations
    spills = {name: sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log))
              for name, log in logs.items()}
    emit({"phase": "build", "kernels": list(logs), "seconds": seconds,
          "spill_store_bytes": spills, "ptxas": ptxas})


def phase_kernel(sites, sd15_sites):
    """The forward kernel against its plain version, timed beside its plain
    version, SDPA (a yardstick only) and the bound, with its share of the
    bound, TFLOP/s and the wrapper's host microseconds per call: at the
    sampler's sites and EXTRA_SHAPES in bf16, the sd15 UNet's sites (d = 40
    and 80) in bf16, and the sampler's sites in fp32 (the fp32 kernel, an
    fp32 model's path). Returns the three lists of rows."""
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    groups = {"sd2_base": [(n, b, h, sq, skv, d, c, torch.bfloat16)
                           for n, b, h, sq, skv, d, c in sites]
              + [(n, b, h, sq, skv, d, 0, torch.bfloat16) for n, b, h, sq, skv, d in EXTRA_SHAPES],
              "sd15": [(n, b, h, sq, skv, d, c, torch.bfloat16)
                       for n, b, h, sq, skv, d, c in sd15_sites],
              "fp32": [(n, b, h, sq, skv, d, c, torch.float32)
                       for n, b, h, sq, skv, d, c in sites]}
    out = {}
    for config, shapes in groups.items():
        results = out[config] = []
        for name, b, h, sq, skv, d, calls, dtype in shapes:
            f32 = dtype == torch.float32
            # the main path's layout: [B, S, H*D] projections seen as [B, H, S, D]
            q, k, v = (torch.randn(b, s, h * d, generator=gen, device="cuda")
                       .to(dtype).view(b, s, h, d).transpose(1, 2)
                       for s in (sq, skv, skv))
            o, lse = flash_attention(q, k, v)
            torch.cuda.synchronize()
            ro, rlse = flash_attention_ref(q.float(), k.float(), v.float())
            err = (o.float() - ro).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            lse_err = (lse - rlse).abs().max().item()
            del ro, rlse, err
            if f32:
                ok = max_err <= F32_TOL and lse_err <= F32_TOL
            else:
                ok = max_err <= MAX_ABS_TOL and mean_err <= MEAN_ABS_TOL and lse_err <= LSE_TOL
            ok = ok and bool(torch.isfinite(o).all())
            reps = 5 if f32 else 25
            kernel_ms = device_ms(lambda: flash_attention(q, k, v), reps=reps)
            plain_ms = device_ms(lambda: flash_attention_ref(q, k, v), reps=5 if f32 else 20,
                                 warmup=2)
            library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps=reps)
            with torch.inference_mode():
                host_us = host_us_per_call(lambda: flash_attention(q, k, v),
                                           calls=20 if f32 else 200)
            bound_ms, bound_by, ops, nbytes = attention_bound(b, h, sq, skv, d, dtype)
            row = {"phase": "kernel", "kernel": "flash_attention_fwd" + ("_f32" if f32 else ""),
                   "config": config, "dtype": str(dtype)[6:], "site": name,
                   "shape_bhqkd": [b, h, sq, skv, d], "calls_per_unet_forward": calls,
                   "max_abs_err": max_err, "mean_abs_err": mean_err, "lse_max_abs_err": lse_err,
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "share_of_bound": bound_ms / kernel_ms,
                   "tflops": ops / kernel_ms / 1e9, "gbytes_per_s": nbytes / kernel_ms / 1e6,
                   "host_us_per_call": host_us, "ok": ok}
            emit(row)
            results.append(row)
            del q, k, v, o, lse
            torch.cuda.empty_cache()
    rows = [r for rs in out.values() for r in rs]
    totals = {config: {key: sum(r[key] * r["calls_per_unet_forward"] for r in rs)
                       for key in ("kernel_ms", "library_ms", "bound_ms", "plain_ms")}
              for config, rs in out.items()}
    emit({"phase": "kernel", "per_unet_forward": totals,
          "host_per_call": flash_host_per_call(sites[0])})
    bad = [(r["config"], r["site"]) for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_attention_fwd disagrees with its plain version at {bad}")
    return out["sd2_base"], out["sd15"], out["fp32"]


def flash_host_per_call(site):
    """The forward wrapper's host microseconds per call at a sampler site, in
    layers: the C entry alone (four tensor maps encoded and the launch,
    through ctypes), then `flash_attention` (+ the checks, the outputs'
    allocation, the strides); SDPA's beside."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn.kernels import flash_attention as fa

    _, b, h, sq, skv, d, _ = site
    q, k, v = (torch.randn(b, s, h * d, device="cuda", dtype=torch.bfloat16)
               .view(b, s, h, d).transpose(1, 2) for s in (sq, skv, skv))
    o = fa._empty_bshd(b, h, sq, d, q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device="cuda")
    st = (ctypes.c_int64 * 12)(*fa._strides((q, k, v, o)))
    fn = fa._fn(fa.NAME, fa.NAME, 5, 5)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, sq,
            skv, d, ctypes.addressof(st), d ** -0.5, 0, torch.cuda.current_stream().cuda_stream)
    with torch.inference_mode():
        return {"site": site[0], "c_entry_us": host_us_per_call(lambda: fn(*args)),
                "flash_attention_us": host_us_per_call(lambda: fa.flash_attention(q, k, v)),
                "sdpa_us": host_us_per_call(lambda: F.scaled_dot_product_attention(q, k, v))}


def phase_precompute(model, mm_paths):
    """The catalog precompute at the sd2_base widths: `encode_catalog` over
    PRECOMPUTE_ITEMS synthetic 512 px items (item 0 the white null image)
    from an in-memory loader, in batches of PRECOMPUTE_BATCH through the bf16
    VAE (after one warm-up batch), then `build_processed_cache` on a
    synthetic outfit table and history, read back. Then the last (ragged)
    batch once more through the kernels, through the plain versions, and in
    fp32 through the plain versions: the kernels' moments may be no farther
    from fp32 than VS_PLAIN times the plain versions'."""
    import copy
    import tempfile
    import types

    import numpy as np
    import torch

    from difashion_tpu_torch.data.datasets import FashionData, OutfitTable
    from difashion_tpu_torch.data.precompute import (
        build_processed_cache,
        encode_catalog,
        load_processed,
    )
    from difashion_tpu_torch.data.tokenizer import HashTokenizer
    from difashion_tpu_torch.nn import kernels

    vcfg = model.config.vae
    px, lat = vcfg.sample_size, vcfg.sample_size // vcfg.scale_factor
    rng = np.random.RandomState(11)
    catalog = rng.randint(0, 256, (PRECOMPUTE_ITEMS, px, px, 3), dtype=np.uint8)
    catalog[0] = 255
    loader = lambda i: catalog[i].astype(np.float32) / 127.5 - 1.0
    encode_catalog(model, loader, PRECOMPUTE_BATCH, batch_size=PRECOMPUTE_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    moments = encode_catalog(model, loader, PRECOMPUTE_ITEMS, batch_size=PRECOMPUTE_BATCH)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    batches = -(-PRECOMPUTE_ITEMS // PRECOMPUTE_BATCH)
    per_batch = count_groupnorms(model.vae.encoder)
    want = all_counts({"group_norm_silu": batches * per_batch,
                       "skinny_matmul": (batches - 1) * len(mm_paths["vae_encode"])
                       + len(mm_paths["encode_ragged"])})
    shape = (PRECOMPUTE_ITEMS, lat, lat, vcfg.latent_channels)
    finite = all(bool(np.isfinite(v).all()) for v in moments.values())
    shapes_ok = all(v.shape == shape and v.dtype == np.float32 for v in moments.values())

    n_rows = 256
    cates = {c: f"category {c}" for c in range(1, 51)}
    table = OutfitTable.from_dict({
        "uids": list(rng.randint(1, 33, n_rows)), "oids": list(range(n_rows)),
        "outfits": list(rng.randint(1, PRECOMPUTE_ITEMS, (n_rows, 4))),
        "category": list(rng.randint(1, 51, (n_rows, 4)))})
    history = {uid: {int(c): list(rng.randint(1, PRECOMPUTE_ITEMS, rng.randint(1, 6)))
                     for c in rng.randint(1, 51, 4)} for uid in range(1, 33)}
    data = FashionData(train=table, fitb_valid=None, fitb_test=None, valid_grd=None,
                       test_grd=None, history={"train": history}, id_cate_dict=cates,
                       cate_iid_dict=None, retrieval_candidates={})
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        files = build_processed_cache(tmp, data, cates, HashTokenizer(), moments,
                                      vcfg.scaling_factor)
        cache_seconds = time.perf_counter() - t1
        back = load_processed(tmp, "all_item_moments")
        hist = np.load(files["train_hist_latents"], allow_pickle=True).item()
        with np.load(files["new_train"]) as z:
            ids_shape = list(z["input_ids"].shape)
        uid = next(iter(history))
        cid = next(iter(history[uid]))
        mean_latent = (moments["mean"][np.asarray(history[uid][cid])].mean(0)
                       * vcfg.scaling_factor)
        cache_ok = (np.array_equal(back["mean"], moments["mean"])
                    and np.array_equal(back["logvar"], moments["logvar"])
                    and np.allclose(hist[uid][cid], mean_latent, rtol=1e-5, atol=1e-6)
                    and np.array_equal(hist["null"], moments["mean"][0] * vcfg.scaling_factor)
                    and ids_shape == [n_rows, 4, 77])

    # one batch of the loop by its parts: the host loader, then the encode
    t1 = time.perf_counter()
    imgs = np.stack([loader(i) for i in range(PRECOMPUTE_BATCH)])
    loader_ms = (time.perf_counter() - t1) * 1e3
    x = torch.from_numpy(imgs).cuda().permute(0, 3, 1, 2)
    with torch.inference_mode():
        prof = device_profile(lambda: model.vae.encode(x))
    del x, imgs
    torch.cuda.empty_cache()

    n = PRECOMPUTE_ITEMS % PRECOMPUTE_BATCH or PRECOMPUTE_BATCH
    last = lambda i: loader(PRECOMPUTE_ITEMS - n + i)
    both = lambda m: np.concatenate([m["mean"].ravel(), m["logvar"].ravel()])
    fast = both(encode_catalog(model, last, n, batch_size=n))
    with kernels.plain_versions():
        plain = both(encode_catalog(model, last, n, batch_size=n))
        vae32 = copy.deepcopy(model.vae).float()
        ref = both(encode_catalog(types.SimpleNamespace(vae=vae32), last, n, batch_size=n))
    del vae32
    torch.cuda.empty_cache()
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    fast_ref, plain_ref = rel(fast, ref), rel(plain, ref)
    row = {"phase": "precompute", "config": "sd2_base VAE", "dtype": "bfloat16",
           "items": PRECOMPUTE_ITEMS, "batch": PRECOMPUTE_BATCH, "batches": batches,
           "image_px": px, "moments_shape": list(shape), "seconds": seconds,
           "seconds_per_1000_items": seconds / PRECOMPUTE_ITEMS * 1e3,
           "items_per_second": PRECOMPUTE_ITEMS / seconds, "peak_memory_bytes": peak,
           "launches": launches, "group_norm_launches_per_batch": per_batch,
           "finite": finite, "cache_seconds": cache_seconds, "cache_files": sorted(files),
           "cache_ok": cache_ok, "gate_batch": n, "kernel_vs_fp32_rel_l2": fast_ref,
           "plain_vs_fp32_rel_l2": plain_ref, "rel_l2": rel(fast, plain),
           "host_loader_ms_per_batch": loader_ms,
           "encode_profile": dict(prof, what=f"one VAE encode, batch {PRECOMPUTE_BATCH}")}
    emit(row)
    if not (launches == want and finite and shapes_ok and cache_ok
            and fast_ref <= VS_PLAIN * plain_ref):
        raise AssertionError(f"precompute: {row}")
    return launches


def phase_kernel_bwd(sites, sd15_sites):
    """The dQ and dK/dV kernels at the training UNet's attention shapes and the
    ragged ones: q, k, v in the projections' [B, S, H, D] layout, a random
    cotangent (never all ones), O and the LSE from the forward kernel. In
    bf16, the kernels and the plain backward run on the same inputs and are
    held against the plain backward in fp32 of the same values, also at the
    sd15 UNet's shapes (d = 40 and 80, which the kernels read in place); in
    fp32 (the fp32 kernels, at the training shapes) the kernels are held
    against the plain backward in fp32 itself. Per site also each kernel's
    share of its bound (`dq_share`, `dkv_share`), the dK/dV kernel's split
    count and the wrappers' host microseconds per call. Returns the bf16,
    fp32 and sd15 rows."""
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
        dkv_splits,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    results, f32_results, sd15_results = [], [], []
    shapes = [(*site, torch.bfloat16) for site in sites]
    shapes += [(n, b, h, sq, skv, d, 0, torch.bfloat16) for n, b, h, sq, skv, d in EXTRA_SHAPES]
    shapes += [(*site, torch.float32) for site in sites]
    shapes += [(f"sd15_{n}", b, h, sq, skv, d, c, torch.bfloat16)
               for n, b, h, sq, skv, d, c in sd15_sites]
    for name, b, h, sq, skv, d, calls, dtype in shapes:
        f32 = dtype == torch.float32
        proj = lambda s: (torch.randn(b, s, h * d, generator=gen, device="cuda")
                          .to(dtype).view(b, s, h, d).transpose(1, 2))
        q, k, v, do = proj(sq), proj(skv), proj(skv), proj(sq)
        scale = d ** -0.5
        o, lse = flash_attention(q, k, v)
        delta = attention_delta(o, do)
        args = (q, k, v, do, lse, delta, scale)
        kern = (flash_attention_dq(*args),) + flash_attention_dkv(*args)
        torch.cuda.synchronize()
        plain = (flash_attention_dq_ref(*args),) + flash_attention_dkv_ref(*args)
        if f32:
            errs = {g: {"kernel_vs_plain": rel_l2(kg, pg),
                        "max_abs_err": (kg - pg).abs().max().item()}
                    for g, kg, pg in zip(("dq", "dk", "dv"), kern, plain)}
            good = all(e["kernel_vs_plain"] <= F32_TOL for e in errs.values())
        else:
            q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
            o32, lse32 = flash_attention_ref(q32, k32, v32)
            ref = flash_attention_bwd_ref(q32, k32, v32, o32, lse32, do32, scale)
            errs = {g: {"kernel_vs_fp32": rel_l2(kg, r), "plain_vs_fp32": rel_l2(pg, r),
                        "max_abs_err": (kg.float() - pg.float()).abs().max().item()}
                    for g, kg, pg, r in zip(("dq", "dk", "dv"), kern, plain, ref)}
            good = all(e["kernel_vs_fp32"] <= BWD_REL_L2_TOL
                       and e["kernel_vs_fp32"] <= VS_PLAIN * e["plain_vs_fp32"]
                       for e in errs.values())
            del ref, q32, k32, v32, do32, o32, lse32
        finite = all(bool(torch.isfinite(t).all()) for t in kern)
        del plain
        torch.cuda.empty_cache()
        reps, plain_reps = (5, 3) if f32 else (25, 10)
        row = {"phase": "kernel_bwd", "dtype": str(dtype)[6:], "site": name,
               "shape_bhqkd": [b, h, sq, skv, d],
               "calls_per_train_step": calls, "errors": errs, "finite": finite,
               "dq_max_abs_err": errs["dq"]["max_abs_err"],
               "dkv_max_abs_err": max(errs["dk"]["max_abs_err"], errs["dv"]["max_abs_err"]),
               "dq_ms": device_ms(lambda: flash_attention_dq(*args), reps=reps),
               "dkv_ms": device_ms(lambda: flash_attention_dkv(*args), reps=reps),
               "delta_ms": device_ms(lambda: attention_delta(o, do)),
               "dq_plain_ms": device_ms(lambda: flash_attention_dq_ref(*args), reps=plain_reps,
                                        warmup=1),
               "dkv_plain_ms": device_ms(lambda: flash_attention_dkv_ref(*args),
                                         reps=plain_reps, warmup=1)}
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
        row["library_ms"] = device_ms(
            lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True), reps=reps)
        del ol, ql, kl, vl
        for kind in ("dq", "dkv"):
            bound_ms, bound_by, ops, nbytes = backward_bound(kind, b, h, sq, skv, d, dtype)
            row.update({f"{kind}_bound_ms": bound_ms, f"{kind}_bound_by": bound_by,
                        f"{kind}_share": bound_ms / row[f"{kind}_ms"],
                        f"{kind}_tflops": ops / row[f"{kind}_ms"] / 1e9,
                        f"{kind}_gbytes_per_s": nbytes / row[f"{kind}_ms"] / 1e6})
        row["dkv_splits"] = 1 if f32 else dkv_splits(b, h, sq, skv, d)
        calls = 20 if f32 else 100
        row["dq_host_us"] = host_us_per_call(lambda: flash_attention_dq(*args), calls=calls)
        row["dkv_host_us"] = host_us_per_call(lambda: flash_attention_dkv(*args), calls=calls)
        row["ok"] = finite and good
        emit(row)
        (sd15_results if name.startswith("sd15_") else f32_results if f32 else results).append(row)
        del q, k, v, do, o, lse, delta, kern, args
        torch.cuda.empty_cache()
    bad = [(r["dtype"], r["site"]) for r in results + f32_results + sd15_results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash backward kernels disagree with the plain backward at {bad}")
    return results, f32_results, sd15_results


GN_PATHS = (  # (path, batch): every GroupNorm of these runs is a kernel_gn shape
    ("sampler_unet", UNET_BATCH), ("train_unet", TRAIN_ROWS),
    ("vae_decode", DECODE_BATCH), ("vae_encode", PRECOMPUTE_BATCH))


def groupnorm_sites(cfg):
    """The GroupNorm calls of each path in GN_PATHS, from a forward of the
    sd2_base towers on the meta device (shapes only, nothing computed):
    [{"shape", "groups", "eps", "calls": {path: {act: n}}}] over the
    distinct (shape, groups, eps)."""
    import torch

    from difashion_tpu_torch.models.difashion import DiFashion
    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.layers import GroupNorm

    with torch.device("meta"):
        model = DiFashion(cfg)
    sites, path = {}, None

    def record(mod, args):
        key = (tuple(args[0].shape), mod.num_groups, mod.eps)
        site = sites.setdefault(key, {"shape": list(key[0]), "groups": key[1], "eps": key[2],
                                      "calls": {}})
        per_act = site["calls"].setdefault(path, {})
        per_act[mod.act] = per_act.get(mod.act, 0) + 1

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, GroupNorm)]
    u, v = cfg.unet, cfg.vae
    meta = lambda *shape: torch.empty(*shape, device="meta")
    with torch.no_grad(), kernels.plain_versions():
        for path, b in GN_PATHS:
            if path.endswith("unet"):
                model.unet(meta(b, u.in_channels, u.sample_size, u.sample_size),
                           torch.zeros(b, dtype=torch.long, device="meta"),
                           meta(b, 77, u.cross_attention_dim))
            elif path == "vae_decode":
                model.vae.decode(meta(b, v.latent_channels, u.sample_size, u.sample_size))
            else:
                model.vae.encode(meta(b, v.in_channels, v.sample_size, v.sample_size))
    for h in hooks:
        h.remove()
    return list(sites.values())


def gn_check(got, want, pre, dtype):
    """(within tolerance, largest |got - want|) of the GroupNorm kernel's
    output against its plain version's, by batch row to bound memory."""
    import torch

    ok, worst = True, 0.0
    for i in range(got.shape[0]):
        diff = (got[i].float() - want[i].float()).abs()
        worst = max(worst, diff.max().item())
        if dtype == torch.float32:
            tol = GN_TOL + GN_TOL * want[i].abs()
        else:
            tol = GN_BF16_ULP * (want[i].float().abs() + pre[i].float().abs()) + GN_TOL
        ok = ok and bool((diff <= tol).all())
        del diff, tol
    return ok, worst


def phase_kernel_gn(sites):
    """The GroupNorm kernel at every site shape, in bf16 and fp32, without
    and with SiLU: against its plain version on the same inputs, with times
    and the bound (x read once, y written once, scale and bias read once)."""
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn.kernels.groupnorm import group_norm_silu, group_norm_silu_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    results = []
    for site in sites:
        shape, groups, eps = site["shape"], site["groups"], site["eps"]
        c = shape[1]
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        bias = torch.randn(c, generator=gen, device="cuda") * 0.2
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype).mul_(2).add_(0.5)
            pre = group_norm_silu_ref(x, scale, bias, groups, eps)
            lib_w, lib_b = scale.to(dtype), bias.to(dtype)
            nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
            reps = 25 if nbytes < 2e9 else 8
            for act in (None, "silu"):
                y = group_norm_silu(x, scale, bias, groups, eps, act)
                torch.cuda.synchronize()
                want = pre if act is None else F.silu(pre)
                ok, err = gn_check(y, want, pre, dtype)
                ok = ok and bool(torch.isfinite(y).all())
                del y, want

                def library():
                    out = F.group_norm(x, groups, lib_w, lib_b, eps)
                    return F.silu(out) if act else out

                row = {"phase": "kernel_gn", "shape": shape, "groups": groups, "eps": eps,
                       "dtype": str(dtype).replace("torch.", ""), "act": act,
                       "elements": x.numel(),
                       "calls": {p: n.get(act, 0) for p, n in site["calls"].items()},
                       "max_abs_err": err,
                       "ms": device_ms(lambda: group_norm_silu(x, scale, bias, groups, eps, act),
                                       reps=reps),
                       "plain_ms": device_ms(lambda: group_norm_silu_ref(x, scale, bias, groups,
                                                                         eps, act),
                                             reps=reps, warmup=1),
                       "library_ms": device_ms(library, reps=reps),
                       "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes"}
                row["gbytes_per_s"] = nbytes / row["ms"] / 1e6
                row["ok"] = ok
                emit(row)
                results.append(row)
            del x, pre
            torch.cuda.empty_cache()
    bad = [(r["shape"], r["dtype"], r["act"]) for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"group_norm_silu disagrees with its plain version at {bad}")
    return results


def path_totals(results, paths):
    """Per path: a kernel's bf16 numbers summed over the path's calls (each
    row's `calls` maps path -> calls of its shape)."""
    out = {}
    for path in paths:
        rows = [r for r in results if r["dtype"] == "bfloat16" and r["calls"].get(path)]
        out[path] = {k: sum(r[k] * r["calls"][path] for r in rows)
                     for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        out[path]["calls"] = sum(r["calls"][path] for r in rows)
    return out


def count_groupnorms(module, inside=None):
    """GroupNorm modules in `module` (each runs once per forward), or only
    those inside a module of the types `inside`."""
    from difashion_tpu_torch.nn.layers import GroupNorm

    if inside is None:
        return sum(isinstance(m, GroupNorm) for m in module.modules())
    return sum(count_groupnorms(m) for m in module.modules() if isinstance(m, inside))


DENSE_PATHS = (  # (path, what runs, batch): every gated Dense product of these runs
    ("sampler_unet", "unet", UNET_BATCH), ("serve_unet", "unet", SERVE_ROWS),
    ("train_unet", "unet", TRAIN_ROWS), ("grad_unet", "unet", UNET_GRAD_BATCH),
    ("vae_decode", "decode", DECODE_BATCH), ("serve_decode", "decode", SERVE_ROWS // 4),
    ("vae_encode", "encode", PRECOMPUTE_BATCH),
    ("encode_ragged", "encode", PRECOMPUTE_ITEMS % PRECOMPUTE_BATCH),
    ("train_encode", "encode", TRAIN_ROWS))
MM_TIMED = ("sampler_unet", "serve_unet", "train_unet", "train_unet_dx", "vae_decode",
            "serve_decode", "vae_encode", "encode_ragged")


def dense_sites(cfg):
    """{path: [(M, K, N, bias) of each gated Dense call]} for DENSE_PATHS,
    from forwards of the sd2_base towers on the meta device (shapes only) and
    the bf16 gate of `nn/kernels/skinny_matmul.py`; "<path>_dx" for the
    train UNet's backward, whose dx = g . w is the product (M, N, K) with the
    weight read as [K, N] and no bias."""
    import torch

    from difashion_tpu_torch.models.difashion import DiFashion
    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.kernels.skinny_matmul import gate
    from difashion_tpu_torch.nn.layers import Dense

    with torch.device("meta"):
        model = DiFashion(cfg)
    calls, path = {}, None

    def record(mod, args):
        m = math.prod(args[0].shape[:-1])
        if gate(m, mod.out_features, mod.in_features, torch.bfloat16, torch.bfloat16):
            calls[path].append((m, mod.in_features, mod.out_features, mod.bias is not None))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, Dense)]
    u, v = cfg.unet, cfg.vae
    meta = lambda *shape: torch.empty(*shape, device="meta")
    with torch.no_grad(), kernels.plain_versions():
        for path, what, b in DENSE_PATHS:
            calls[path] = []
            if what == "unet":
                model.unet(meta(b, u.in_channels, u.sample_size, u.sample_size),
                           torch.zeros(b, dtype=torch.long, device="meta"),
                           meta(b, 77, u.cross_attention_dim))
            elif what == "decode":
                model.vae.decode(meta(b, v.latent_channels, u.sample_size, u.sample_size))
            else:
                model.vae.encode(meta(b, v.in_channels, v.sample_size, v.sample_size))
    for h in hooks:
        h.remove()
    calls["train_unet_dx"] = [(m, n, k, False) for m, k, n, _ in calls["train_unet"]]
    return calls


def matmul_bound(m, k, n, bias=False):
    """(bound ms, 'operations' or 'bytes', ops, bytes): 2MKN operations (and
    MN adds for a bias); x, w (and the bias) read once and o written once in
    16 bits."""
    ops = 2.0 * m * k * n + (m * n if bias else 0)
    nbytes = 2.0 * (m * k + k * n + m * n + (n if bias else 0))
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def host_us_per_call(fn, calls=200):
    """Host microseconds to issue one call of `fn` while the card is busy
    (a sleep kernel ahead of them), so that no call waits for the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_kernel_mm(paths):
    """The skinny-N kernel at every distinct routed product of MM_TIMED (the
    train step's dx products with the weight read as [K, N], as the backward
    reads it): in bf16 and fp16, with a bias and without one, in both layouts
    of w (the other one a transposed copy of the same weight), against its
    plain version (the largest difference) and both against an fp64 product
    of the same inputs. In bf16, in the path's layout: the tile width, the
    time with and without a bias, the plain version's, torch.matmul's and
    F.linear's (with the bias; yardsticks only), TFLOP/s and the bound's
    share. Then the wrapper's host microseconds per call beside F.linear's."""
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn.kernels.skinny_matmul import (
        skinny_matmul,
        skinny_matmul_ref,
        tile_n,
    )

    shapes = {}
    for path in MM_TIMED:
        for m, k, n, bias in paths[path]:
            per = shapes.setdefault((m, k, n, path.endswith("_dx")),
                                    {"calls": {}, "bias_calls": {}})
            per["calls"][path] = per["calls"].get(path, 0) + 1
            per["bias_calls"][path] = per["bias_calls"].get(path, 0) + bias
    gen = torch.Generator(device="cuda").manual_seed(6)
    results = []
    for (m, k, n, w_kn), per in shapes.items():
        row = {"phase": "kernel_mm", "mkn": [m, k, n], "w_kn": w_kn, **per,
               "tile_n": tile_n(n, w_kn), "checks": {}}
        ok = True
        for dtype in (torch.bfloat16, torch.float16):
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5).to(dtype)
            b = torch.randn(n, generator=gen, device="cuda").to(dtype)
            w_nk = w.t().contiguous()
            for bias in (None, b):
                plain = skinny_matmul_ref(x, w, bias, w_kn=True)
                ref = x.double() @ w.double()
                if bias is not None:
                    ref += bias.double()
                plain_err = (plain.double() - ref).abs().max().item()
                for kn in (False, True):
                    o = skinny_matmul(x, w if kn else w_nk, bias, w_kn=kn)
                    torch.cuda.synchronize()
                    kernel_err = (o.double() - ref).abs().max().item()
                    max_err = (o.float() - plain.float()).abs().max().item()
                    # both round one fp32 sum per element to 16 bits (and the
                    # bias sum once more): each is within half a unit in the
                    # last place (plus the fp32 sum's error) of the fp64
                    # product, so the kernel may be no farther from it than
                    # VS_PLAIN times the plain version's largest distance
                    good = bool(torch.isfinite(o).all()) and kernel_err <= VS_PLAIN * plain_err
                    ok &= good
                    key = (f"{str(dtype)[6:]}_{'kn' if kn else 'nk'}"
                           f"_{'bias' if bias is not None else 'no_bias'}")
                    row["checks"][key] = [max_err, kernel_err, plain_err]
                    if dtype == torch.bfloat16:
                        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), max_err)
                    del o
                del plain, ref
            if dtype == torch.bfloat16:
                wl = w if w_kn else w_nk
                wt = w if w_kn else w_nk.t()
                bound_ms, bound_by, ops, nbytes = matmul_bound(m, k, n)
                row.update({
                    "ms": device_ms(lambda: skinny_matmul(x, wl, w_kn=w_kn)),
                    "ms_bias": None if w_kn else device_ms(lambda: skinny_matmul(x, wl, b)),
                    "plain_ms": device_ms(lambda: skinny_matmul_ref(x, wl, w_kn=w_kn),
                                          reps=10, warmup=1),
                    "matmul_ms": device_ms(lambda: torch.matmul(x, wt)),
                    "linear_ms": None if w_kn else device_ms(lambda: F.linear(x, wl, b)),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_bias_ms": matmul_bound(m, k, n, bias=True)[0]})
                row["tflops"] = ops / row["ms"] / 1e9
                row["bound_share"] = bound_ms / row["ms"]
            del x, w, w_nk, b
            torch.cuda.empty_cache()
        row["ok"] = ok
        emit(row)
        results.append(row)
    # the wrapper's host cost at a biased product of the sampler UNet, in
    # layers: the C entry alone (three tensor maps encoded and the launch,
    # through ctypes), `launch` (+ the output's allocation and the stream),
    # `skinny_matmul` (+ the checks), a Dense module (+ the route, the casts);
    # beside F.linear and an nn.Linear module on the same inputs
    from difashion_tpu_torch.nn.kernels import skinny_matmul as sm
    from difashion_tpu_torch.nn.layers import Dense

    x = torch.randn(4096, 1280, device="cuda", dtype=torch.bfloat16)
    dense = Dense(1280, 1280).to("cuda", torch.bfloat16)
    w, b = dense.weight.detach(), dense.bias.detach()
    o = torch.empty(4096, 1280, device="cuda", dtype=torch.bfloat16)
    bn = tile_n(1280)
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(), 4096, 1280, 1280, 1280, 0,
            0, bn)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.inference_mode():
        host = {"mkn": [4096, 1280, 1280],
                "c_entry_us": host_us_per_call(lambda: sm._fn()(*args, stream)),
                "launch_us": host_us_per_call(lambda: sm.launch(x, w, b, False, bn)),
                "skinny_matmul_us": host_us_per_call(lambda: skinny_matmul(x, w, b)),
                "dense_module_us": host_us_per_call(lambda: dense(x)),
                "linear_us": host_us_per_call(lambda: F.linear(x, w, b)),
                "linear_module_us": host_us_per_call(
                    lambda: torch.nn.Linear.forward(dense, x)),
                "matmul_us": host_us_per_call(lambda: torch.matmul(x, w.t()))}
    emit({"phase": "kernel_mm", "host_per_call": host})
    del x, w, b, o, dense
    bad = [(r["mkn"], r["w_kn"]) for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"skinny_matmul disagrees with its plain version at {bad}")
    return results, host


def mm_path_totals(results, paths):
    """Per path: the skinny kernel's bf16 numbers summed over the path's
    calls, each call with its bias or without: ms, the bound, the plain
    version, torch.matmul (no bias), and the library (torch.matmul for the
    calls without a bias, F.linear for those with one)."""
    out = {}
    for path in paths:
        tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "matmul_ms", "library_ms"), 0.0)
        tot["calls"] = 0
        for r in results:
            calls = r["calls"].get(path, 0)
            biased = r["bias_calls"].get(path, 0)
            plain_calls = calls - biased
            tot["ms"] += r["ms"] * plain_calls + (r["ms_bias"] or 0.0) * biased
            tot["plain_ms"] += r["plain_ms"] * calls
            tot["bound_ms"] += r["bound_ms"] * plain_calls + r["bound_bias_ms"] * biased
            tot["matmul_ms"] += r["matmul_ms"] * calls
            tot["library_ms"] += r["matmul_ms"] * plain_calls + (r["linear_ms"] or 0.0) * biased
            tot["calls"] += calls
        out[path] = tot
    return out


def phase_unet(model, mm_paths):
    """One sd2_base UNet forward through the kernels (attention and
    GroupNorm) and one through their plain versions, both in bf16, held
    against each other; and both against an fp32 forward of the same weights
    (plain versions), which shows the bf16 noise floor the two paths share."""
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
        launches = dict(kernels.LAUNCHES)
        with kernels.plain_versions():
            plain = unet(x, t, ctx).float()
    unet.float()
    with torch.inference_mode(), kernels.plain_versions():
        ref = unet(x, t, ctx)
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
    want = all_counts({"flash_attention_fwd": 32, "group_norm_silu": count_groupnorms(unet),
                       "skinny_matmul": len(mm_paths["sampler_unet"])})
    if not (finite and rel(fast, plain) <= UNET_REL_L2_TOL and launches == want
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


REFERENCE_SCHEDULERS = (  # (scheduler, ddim_eta): the tiny path's runs, 20 steps
    ("pndm", 0.0), ("ddim", 0.0), ("ddim", 0.5), ("dpmpp", 0.0))


def phase_reference():
    """The whole generation path at the tiny config (20 steps, 4-branch CFG)
    with each scheduler of REFERENCE_SCHEDULERS: on the card in fp16 through
    the kernels, against the port's CPU run in fp32 of the same weights and
    inputs (DDIM at eta 0.5 with the same step noise fed to both), which the
    CPU tests hold against the JAX package and the committed torch-oracle
    trajectories."""
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
    models = (("cpu", cpu, "cpu"),
              ("cpu_fp16", copy.deepcopy(cpu).to(torch.float16), "cpu"),
              ("cuda", copy.deepcopy(cpu).to("cuda", torch.float16), "cuda"))
    n_attn = sum(isinstance(m, CrossAttention) for m in cpu.unet.modules())
    bad = []
    for scheduler, ddim_eta in REFERENCE_SCHEDULERS:
        forwards = 21 if scheduler == "pndm" else 20
        # the UNet forwards, then the decoder's mid-attention (d = 32 at this size)
        expect = all_counts({  # the tiny products have at most 1024 rows: no skinny_matmul
            "flash_attention_fwd": forwards * n_attn
            + sum(isinstance(m, VAEAttention) for m in cpu.vae.decoder.modules()),
            "group_norm_silu": forwards * count_groupnorms(cpu.unet)
            + count_groupnorms(cpu.vae.decoder)})
        out = {}
        for name, model, dev in models:
            gen = torch.Generator().manual_seed(0)
            inputs = gor_inputs(model, gen, dev)
            noise = (torch.randn((20,) + tuple(inputs.init_latents.shape), generator=gen)
                     if ddim_eta > 0 else None)
            sampler = build_sampler(model, num_inference_steps=20,
                                    spec=make_guidance_spec(*CFG_SCALES), eta=ETA,
                                    scheduler=scheduler, ddim_eta=ddim_eta)
            kernels.reset_launches()
            latents = sampler(inputs, step_noise=noise)
            out[name] = (latents.cpu(), decode_to_uint8(model, latents).cpu(),
                         dict(kernels.LAUNCHES))
        ref, ref_img, _ = out["cpu"]

        def diff(name):
            lat, img, _ = out[name]
            pix = (img.int() - ref_img.int()).abs().float()
            return ((lat - ref).norm() / ref.norm()).item(), pix.mean().item(), pix.max().item()

        rel, pix_mean, pix_max = diff("cuda")
        floor = diff("cpu_fp16")
        launches = out["cuda"][2]
        emit({"phase": "reference", "config": "tiny", "scheduler": scheduler,
              "ddim_eta": ddim_eta, "steps": 20, "dtype": "float16",
              "latents_rel_l2_vs_cpu_fp32": rel, "image_mean_abs_diff": pix_mean,
              "image_max_abs_diff": pix_max, "cpu_fp16_rel_l2_vs_cpu_fp32": floor[0],
              "cpu_fp16_image_mean_abs_diff": floor[1], "kernel_launches": launches,
              "expected_launches": expect})
        # fp16 rounding through 20 guided steps at CFG scale 12 moves the
        # result; the CPU's own fp16 run, printed beside, shows by how much
        if not (rel <= REF_REL_L2_TOL and pix_mean <= REF_PIXEL_TOL and launches == expect):
            bad.append((scheduler, ddim_eta, rel, pix_mean, launches))
    if bad:
        raise AssertionError(f"tiny generation on the card vs CPU fp32: {bad}")


def phase_sd15_unet():
    """One full-width sd15 UNet forward (conv projections, 8 fixed heads: head
    dims 40, 80 and 160; seeded weights, bf16, batch 16) through the kernels
    against one through their plain versions, and both against an fp32
    forward of the same weights (plain versions), as `phase_unet` holds the
    sd2_base UNet. The 20 attentions of head dim 40 and 80 run on the forward
    kernel (its TMA boxes zero-fill them to 64 and 128 columns); the 12 of
    head dim 160 take plain matmul + softmax, as in the JAX package."""
    import torch

    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.weights import param_count

    cfg = ModelConfig.sd15()
    sites = main_path_attention_sites(cfg, UNET_BATCH)
    n_kernel = sum(c for *_, d, c in sites if d <= 128)
    unet = create_difashion(cfg, seed=0, device="cuda", dtype=torch.bfloat16).unet
    gen = torch.Generator(device="cuda").manual_seed(9)
    s = cfg.unet.sample_size
    x = torch.randn(UNET_BATCH, cfg.unet.in_channels, s, s, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (UNET_BATCH,), generator=gen, device="cuda")
    ctx = torch.randn(UNET_BATCH, 77, cfg.unet.cross_attention_dim, generator=gen,
                      device="cuda")
    mm = dense_sites(cfg)["sampler_unet"]
    with torch.inference_mode():
        kernels.reset_launches()
        fast = unet(x, t, ctx).float()
        launches = dict(kernels.LAUNCHES)
        with kernels.plain_versions():
            plain = unet(x, t, ctx).float()
    unet.float()
    with torch.inference_mode(), kernels.plain_versions():
        ref = unet(x, t, ctx)
    torch.cuda.synchronize()
    fast_ref, plain_ref = rel_l2(fast, ref), rel_l2(plain, ref)
    finite = bool(torch.isfinite(fast).all() and torch.isfinite(plain).all())
    want = all_counts({"flash_attention_fwd": n_kernel,
                       "group_norm_silu": count_groupnorms(unet), "skinny_matmul": len(mm)})
    emit({"phase": "sd15_unet", "config": "sd15", "dtype": "bfloat16",
          "params": param_count(unet), "batch": UNET_BATCH,
          "head_dims": sorted({d for *_, d, _ in sites}), "kernel_attentions": n_kernel,
          "plain_attentions": sum(c for *_, c in sites) - n_kernel,
          "out_shape": list(fast.shape), "rel_l2": rel_l2(fast, plain),
          "kernel_vs_fp32_rel_l2": fast_ref, "plain_vs_fp32_rel_l2": plain_ref,
          "finite": finite, "kernel_launches": launches, "expected_launches": want})
    ok = (finite and rel_l2(fast, plain) <= UNET_REL_L2_TOL and launches == want
          and fast_ref <= VS_PLAIN * plain_ref)
    del unet, fast, plain, ref
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"sd15 UNet kernel vs plain: vs fp32 {fast_ref} / {plain_ref}, "
                             f"finite {finite}, launches {launches}")


def phase_fp32_reference():
    """The tiny path in fp32 on the card, as a model built with
    mixed_precision other than "bf16" runs it: generation (PNDM, 20 steps,
    4-branch CFG, the decode to uint8) and the training loss and gradients
    with injected draws (autocast off), every attention on the fp32 kernels,
    against the port's CPU fp32 run of the same weights and inputs. Returns
    the launches of the two runs (the fp32 kernels' path)."""
    import copy

    import numpy as np
    import torch

    from difashion_tpu_torch.config import ModelConfig, TrainConfig
    from difashion_tpu_torch.engine.generate import (
        build_sampler,
        decode_to_uint8,
        make_guidance_spec,
    )
    from difashion_tpu_torch.engine.train import TrainBatch, difashion_loss
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.attention import CrossAttention, VAEAttention

    cfg, tc = ModelConfig.tiny(), TrainConfig(mixed_precision="no")
    cpu = create_difashion(cfg, seed=0, device="cpu")
    cuda = copy.deepcopy(cpu).to("cuda")
    n_attn = sum(isinstance(m, CrossAttention) for m in cpu.unet.modules())
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", cuda, "cuda")):
        inputs = gor_inputs(model, torch.Generator().manual_seed(0), dev)
        sampler = build_sampler(model, num_inference_steps=20,
                                spec=make_guidance_spec(*CFG_SCALES), eta=ETA)
        kernels.reset_launches()
        latents = sampler(inputs)
        out[name] = (latents.cpu(), decode_to_uint8(model, latents).cpu(),
                     dict(kernels.LAUNCHES))
    (ref, ref_img, _), (lat, img, gen_launches) = out["cpu"], out["cuda"]
    rel = ((lat - ref).norm() / ref.norm()).item()
    pix = (img.int() - ref_img.int()).abs().float()
    gen_want = all_counts({
        "flash_attention_fwd_f32": 21 * n_attn
        + sum(isinstance(m, VAEAttention) for m in cpu.vae.decoder.modules()),
        "group_norm_silu": 21 * count_groupnorms(cpu.unet) + count_groupnorms(cpu.vae.decoder)})

    # the training loss and gradients, injected draws as in phase_train_reference
    rng = np.random.RandomState(0)
    B, olen, h, C = 2, 4, cfg.unet.sample_size, cfg.vae.latent_channels
    n = B * olen
    f32 = lambda x: np.asarray(x, np.float32)
    x = {"mean": f32(rng.randn(B, olen, h, h, C) * 2),
         "logvar": f32(rng.uniform(-8, -2, (B, olen, h, h, C))),
         "hist": f32(rng.randn(B, olen, h, h, C) * 0.3), "null_latent": f32(rng.randn(h, h, C) * 0.05),
         "ids": rng.randint(0, cfg.text.vocab_size, (B, olen, 77)),
         "enc_eps": f32(rng.randn(n, h, h, C)), "noise": f32(rng.randn(n, h, h, C)),
         "t_outfit": rng.randint(0, 1000, (B,)), "p_mask": f32(rng.uniform(0, 1, n)),
         "p_cate": f32(rng.uniform(0, 1, n))}

    def train(model, dev):
        model.prepare_for_training()
        t = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
        batch = TrainBatch(None, t["mean"], t["logvar"], t["ids"].long(), t["hist"])
        with torch.no_grad():
            null_text = model.encode_text(torch.zeros(1, 77, dtype=torch.long, device=dev))[0]
        kernels.reset_launches()
        loss, _ = difashion_loss(model, batch, t["null_latent"], null_text, None, tc,
                                 injected={k: t[k] for k in ("enc_eps", "noise", "t_outfit",
                                                             "p_mask", "p_cate")})
        loss.backward()
        launches = dict(kernels.LAUNCHES)
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                           for _, p in model.trainable_parameters()]).cpu()
        return loss.item(), grads, launches

    ref_loss, ref_grads, _ = train(cpu, "cpu")
    loss, grads, train_launches = train(cuda, "cuda")
    loss_rel, grad_rel = abs(loss - ref_loss) / abs(ref_loss), rel_l2(grads, ref_grads)
    train_want = all_counts({"flash_attention_fwd_f32": n_attn, "flash_attention_dq_f32": n_attn,
                             "flash_attention_dkv_f32": n_attn,
                             "group_norm_silu": count_groupnorms(cpu.unet)})
    finite = bool(torch.isfinite(lat).all() and np.isfinite(loss) and torch.isfinite(grads).all())
    emit({"phase": "fp32_reference", "config": "tiny", "dtype": "float32", "scheduler": "pndm",
          "steps": 20, "latents_rel_l2_vs_cpu_fp32": rel, "image_mean_abs_diff": pix.mean().item(),
          "image_max_abs_diff": pix.max().item(), "loss_cpu_fp32": ref_loss, "loss_cuda_fp32": loss,
          "loss_rel_diff": loss_rel, "grad_rel_l2_vs_cpu_fp32": grad_rel, "finite": finite,
          "generation_launches": gen_launches, "train_launches": train_launches})
    if not (finite and rel <= F32_REF_TOL and pix.mean().item() <= REF_PIXEL_TOL
            and loss_rel <= F32_REF_TOL and grad_rel <= F32_REF_TOL
            and gen_launches == gen_want and train_launches == train_want):
        raise AssertionError(f"tiny fp32 path on the card vs CPU fp32: latents {rel}, loss "
                             f"{loss_rel}, gradients {grad_rel}, launches {gen_launches} / "
                             f"{train_launches}")
    return {name: gen_launches[name] + train_launches[name]
            for name in ("flash_attention_fwd_f32", "flash_attention_dq_f32",
                         "flash_attention_dkv_f32")}


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
    n_gn = count_groupnorms(cpu.unet)
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
    expect = all_counts({"flash_attention_fwd": n_attn, "flash_attention_dq": n_attn,
                         "flash_attention_dkv": n_attn, "group_norm_silu": n_gn})
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


def phase_main_path(model, mm_paths):
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
    gn_expect = (STEPS + 1) * count_groupnorms(model.unet) + count_groupnorms(model.vae.decoder)
    mm_expect = (STEPS + 1) * len(mm_paths["sampler_unet"]) + len(mm_paths["vae_decode"])
    emit({"phase": "main_path", "config": "sd2_base", "dtype": "bfloat16",
          "mode": "GOR", "outfits": 1, "items": 4, "steps": STEPS,
          "unet_forwards": STEPS + 1, "cfg_branches": 4, "eta": ETA,
          "images_shape": list(images.shape), "images_dtype": str(images.dtype),
          "latents_finite": finite, "launches": launches,
          "expected_flash_launches": expect, "expected_group_norm_launches": gn_expect,
          "expected_skinny_matmul_launches": mm_expect,
          "seconds_per_outfit": seconds,
          "wall_seconds": wall, **ms, "ms_per_unet_step": ms["sampler_ms"] / (STEPS + 1),
          "peak_memory_bytes": peak})
    if tuple(images.shape) != (4, 512, 512, 3) or images.dtype != torch.uint8:
        raise AssertionError(f"main path images {tuple(images.shape)} {images.dtype}")
    if not finite:
        raise AssertionError("main path latents are not finite")
    # generation runs under inference_mode: the forward kernels alone, no backward
    want = all_counts({"flash_attention_fwd": expect, "group_norm_silu": gn_expect,
                       "skinny_matmul": mm_expect})
    if launches != want:
        raise AssertionError(f"main path launches {launches}, expected {want}")
    return launches


SERVE_STEPS, SERVE_MAX_BATCH, DDIM_STEPS = 20, 4, 50
REGROUP_MEAN_TOL = 1.0   # uint8 levels


def serve_requests():
    """The service's requests: a GOR request for one outfit (padded to
    SERVE_MAX_BATCH x 4 fills), a FITB request for three outfits with 1 / 2 /
    1 blanks (4 fills), and that FITB request cut in two (3 fills, 1 fill)."""
    gor = {"task": "GOR", "uids": [11], "oids": [900], "outfits": [[0, 0, 0, 0]],
           "category": [[1, 2, 3, 4]], "seed": 5}
    fitb = {"task": "FITB", "uids": [1, 2, 3], "oids": [101, 102, 103],
            "outfits": [[0, 5, 6, 7], [0, 0, 8, 9], [10, 11, 0, 12]],
            "category": [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], "seed": 5}
    part = lambda sl: dict(fitb, **{k: fitb[k][sl] for k in ("uids", "oids", "outfits",
                                                             "category")})
    return gor, fitb, part(slice(0, 2)), part(slice(2, 3))


def images_by_fill(prep, imgs):
    """{(uid, oid, i): image} for the i-th generated slot of each outfit."""
    out, seen = {}, {}
    for k in range(len(imgs)):
        if prep.valid[k]:
            key = (int(prep.fill_uids[k]), int(prep.fill_oids[k]))
            i = seen[key] = seen.get(key, -1) + 1
            out[key + (i,)] = imgs[k]
    return out


def serve_tiny_checkpoint():
    """A tiny checkpoint (EMA apart from the weights) and a dataset saved to a
    temporary directory, restored and served on the card through the serve
    command's own functions (`--tiny --device cuda`), and its /healthz over
    HTTP on 127.0.0.1."""
    import tempfile
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from difashion_tpu_torch.checkpoint import CheckpointStore
    from difashion_tpu_torch.cli import serve
    from difashion_tpu_torch.config import Config
    from difashion_tpu_torch.data.precompute import save_processed
    from difashion_tpu_torch.engine.train import build_train_step
    from difashion_tpu_torch.models.difashion import FROZEN, create_difashion

    cfg = Config.preset_tiny()
    model = create_difashion(cfg.model, seed=3, device="cuda")
    _, init = build_train_step(model, cfg.train)
    state = init()
    torch._foreach_mul_(state.ema.params, 0.5)
    state.step = 3
    s, C = cfg.model.unet.sample_size, cfg.model.vae.latent_channels
    with tempfile.TemporaryDirectory() as tmp:
        data, ckpt = os.path.join(tmp, "data"), os.path.join(tmp, "ckpt")
        store = CheckpointStore(ckpt)
        store.save(state, 3)
        store.save_frozen({t: getattr(model, t).state_dict() for t in FROZEN})
        os.makedirs(data)
        np.save(os.path.join(data, "id_cate_dict.npy"),
                np.array({c: f"category {c}" for c in range(1, 6)}, dtype=object))
        np.save(os.path.join(data, "test_history.npy"), np.array({1: {2: [3]}}, dtype=object))
        lat = np.random.RandomState(4).randn(8, s, s, C).astype(np.float32)
        save_processed(data, "all_item_moments", mean=lat, logvar=np.zeros_like(lat))
        service = serve.build_service(serve.parse_args([
            "--data_path", data, "--ckpt_dir", ckpt, "--tiny", "--device", "cuda",
            "--allow_random_weights", "--max_batch", "2", "--num_inference_steps", "4"]))
    served = dict(service.pipeline.model.trainable_parameters())
    restored = all(torch.equal(served[n], e.to(served[n].dtype))
                   for n, e in zip(state.names, state.ema.params))
    prep, latents, imgs = service.generate_images(
        {"task": "FITB", "uids": [1, 2], "oids": [7, 8], "outfits": [[0, 1, 2, 3], [4, 0, 5, 6]],
         "category": [[1, 2, 3, 4], [2, 3, 4, 5]], "seed": 1})
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/healthz",
                                    timeout=30) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    row = {"checkpoint_step": service.checkpoint_step, "ema_restored": restored,
           "images_shape": list(imgs.shape), "images_dtype": str(imgs.dtype),
           "latents_finite": bool(torch.isfinite(latents).all()), "healthz": health}
    ok = (service.checkpoint_step == 3 and restored and imgs.shape == (2, 64, 64, 3)
          and imgs.dtype == np.uint8 and row["latents_finite"]
          and health == {"status": "ok", "devices": torch.cuda.device_count()})
    return row, ok


def phase_serve(model, mm_paths):
    """The generation service at the sd2_base widths: DPM-Solver++ at
    SERVE_STEPS steps, 4-branch CFG, `GenerationService(max_batch=4)` over a
    `GenerationPipeline` with seeded catalog latents and history. Each
    request of `serve_requests` after a warm-up of both batch shapes: its
    seconds (host clock around the device half of the request, which ends in
    the copy of the uint8 images), peak memory and launches; the FITB request
    again (bit-identical) and in two parts (the same images, see
    REGROUP_MEAN_TOL); the sampler's
    ms per UNet step by CUDA events; one DDIM_STEPS-step DDIM GOR batch at eta
    0; then `serve_tiny_checkpoint`."""
    import numpy as np
    import torch

    from difashion_tpu_torch.cli.serve import GenerationService, apply_generation_overrides
    from difashion_tpu_torch.config import Config
    from difashion_tpu_torch.data.datasets import HistLatentStore
    from difashion_tpu_torch.data.tokenizer import HashTokenizer
    from difashion_tpu_torch.engine.generate import decode_to_uint8
    from difashion_tpu_torch.engine.pipeline import GenerationPipeline
    from difashion_tpu_torch.nn import kernels

    mcfg = model.config
    s, C = mcfg.unet.sample_size, mcfg.vae.latent_channels
    rng = np.random.RandomState(12)
    catalog = (rng.randn(16, s, s, C) * 0.5).astype(np.float32)
    history = {1: {1: [3, 4]}, 11: {2: [7]}}
    cates = {c: f"category {c}" for c in range(1, 51)}

    def pipeline(scheduler, steps):
        cfg = apply_generation_overrides(Config(model=mcfg), scheduler=scheduler,
                                         num_inference_steps=steps)
        return GenerationPipeline(model, cfg, cates, HashTokenizer(mcfg.text.vocab_size),
                                  HistLatentStore.from_catalog(history, catalog),
                                  item_latents=catalog)

    pipe = pipeline("dpmpp", SERVE_STEPS)
    service = GenerationService(pipe, max_batch=SERVE_MAX_BATCH)
    n_gn_unet, n_gn_dec = count_groupnorms(model.unet), count_groupnorms(model.vae.decoder)

    def expected(steps, fills):
        unet, dec = (("serve_unet", "serve_decode") if fills == SERVE_ROWS // 4
                     else ("sampler_unet", "vae_decode"))
        assert 4 * fills == (SERVE_ROWS if unet == "serve_unet" else UNET_BATCH)
        return all_counts({"flash_attention_fwd": steps * 32,
                           "group_norm_silu": steps * n_gn_unet + n_gn_dec,
                           "skinny_matmul": steps * len(mm_paths[unet]) + len(mm_paths[dec])})

    def run(req):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        prep, latents, imgs = service.generate_images(req)
        seconds = time.perf_counter() - t0
        return {"prep": prep, "latents": latents, "imgs": imgs, "seconds": seconds,
                "launches": dict(kernels.LAUNCHES),
                "peak_memory_bytes": torch.cuda.max_memory_allocated()}

    gor, fitb, part_a, part_b = serve_requests()
    run(gor)                       # warm-up: the allocator and cuDNN's plans at both shapes
    run(fitb)
    runs = {"gor": run(gor), "fitb": run(fitb), "fitb_again": run(fitb),
            "fitb_part_a": run(part_a), "fitb_part_b": run(part_b)}
    ms_per_step = {}
    for name in ("gor", "fitb"):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        pipe.sample(runs[name]["prep"])
        ev[1].record()
        torch.cuda.synchronize()
        ms_per_step[name] = ev[0].elapsed_time(ev[1]) / SERVE_STEPS
    rows, ok = {}, True
    for name, r in runs.items():
        fills = len(r["prep"].valid)
        want = expected(SERVE_STEPS, fills)
        good = (r["imgs"].dtype == np.uint8 and r["imgs"].shape == (fills, 512, 512, 3)
                and bool(torch.isfinite(r["latents"]).all()) and r["launches"] == want)
        ok = ok and good
        rows[name] = {"fills": fills, "valid_fills": int(r["prep"].valid.sum()),
                      "unet_rows": 4 * fills, "seconds": r["seconds"],
                      "peak_memory_bytes": r["peak_memory_bytes"], "launches": r["launches"],
                      "expected_launches": want, "ok": good}
    repeat = bool(np.array_equal(runs["fitb"]["imgs"], runs["fitb_again"]["imgs"]))
    whole = images_by_fill(runs["fitb"]["prep"], runs["fitb"]["imgs"])
    parts = {**images_by_fill(runs["fitb_part_a"]["prep"], runs["fitb_part_a"]["imgs"]),
             **images_by_fill(runs["fitb_part_b"]["prep"], runs["fitb_part_b"]["imgs"])}
    if set(whole) != set(parts):
        raise AssertionError(f"serve: regrouped fills {sorted(parts)} vs {sorted(whole)}")
    diffs = [np.abs(whole[k].astype(np.int16) - parts[k]) for k in whole]
    regroup = {"max_abs_diff": int(max(d.max() for d in diffs)),
               "mean_abs_diff": float(np.mean([d.mean() for d in diffs])),
               "bit_identical": all(not d.any() for d in diffs)}
    # the scale of a real difference: two fills of the request, other noise
    ka, kb = sorted(whole)[:2]
    regroup["other_fill_mean_abs_diff"] = float(
        np.abs(whole[ka].astype(np.int16) - whole[kb]).mean())
    # why not bit-identical: a cuDNN convolution of the UNet rounds a row's
    # sums in an order that depends on the row's place in the batch
    conv = model.unet.down_blocks[1].resnets[0].conv2
    xc = torch.randn((UNET_BATCH, conv.in_channels, s // 2, s // 2), device="cuda",
                     dtype=torch.bfloat16)
    with torch.inference_mode():
        yc, yr = conv(xc), conv(xc.roll(4, 0))
    regroup["conv_rows_position_independent"] = bool(torch.equal(yc.roll(4, 0), yr))
    del runs, xc, yc, yr

    # one DDIM GOR batch, unpadded: 4 fills, 16 UNet rows
    ddim = pipeline("ddim", DDIM_STEPS)
    prep = ddim.prepare_batch({k: np.asarray(gor[k]) for k in ("uids", "oids", "outfits",
                                                               "category")}, "GOR", 5)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    latents = ddim.sample(prep)
    imgs = decode_to_uint8(model, latents).cpu().numpy()
    ddim_seconds = time.perf_counter() - t0
    ddim_launches = dict(kernels.LAUNCHES)
    ddim_ok = (imgs.dtype == np.uint8 and imgs.shape == (4, 512, 512, 3)
               and bool(torch.isfinite(latents).all())
               and ddim_launches == expected(DDIM_STEPS, 4))
    del ddim, prep, latents, imgs
    torch.cuda.empty_cache()
    tiny, tiny_ok = serve_tiny_checkpoint()
    emit({"phase": "serve", "config": "sd2_base", "dtype": "bfloat16", "scheduler": "dpmpp",
          "steps": SERVE_STEPS, "cfg_branches": 4, "max_batch": SERVE_MAX_BATCH,
          "requests": rows, "ms_per_unet_step": ms_per_step,
          "repeat_bit_identical": repeat, "regrouped": regroup,
          "ddim": {"steps": DDIM_STEPS, "ddim_eta": 0.0, "fills": 4, "seconds": ddim_seconds,
                   "launches": ddim_launches, "ok": ddim_ok},
          "tiny_checkpoint": tiny})
    # regrouped fills: the same noise and the same inputs, but cuDNN's
    # position-dependent rounding in bf16, amplified through 20 steps at CFG
    # scale 12: within REGROUP_MEAN_TOL levels on average (another fill's
    # noise moves the average pixel by tens of levels)
    regrouped_ok = (regroup["bit_identical"]
                    or (regroup["mean_abs_diff"] <= REGROUP_MEAN_TOL
                        and not regroup["conv_rows_position_independent"]))
    if not (ok and repeat and regrouped_ok and ddim_ok and tiny_ok):
        raise AssertionError(f"serve: requests ok {ok}, repeat {repeat}, regrouped "
                             f"{regroup}, ddim {ddim_ok}, tiny checkpoint {tiny}")
    return {name: r["launches"] for name, r in rows.items()}


# CUDA kernel names -> what they do, first match wins
PROFILE_CATEGORIES = [
    ("group_norm_silu", ("gn_stats_kernel", "gn_apply_kernel")),
    ("skinny_matmul", ("skinny_matmul_kernel",)),
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("flash_attention_dq", ("flash_dq_kernel",)),
    ("flash_attention_dkv", ("flash_dkv_kernel",)),
    ("layout NCHW<->NHWC", ("nchwToNhwc", "nhwcToNchw")),
    ("norm statistics", ("layer_norm", "RowwiseMoments", "group_norm", "GroupNorm")),
    ("convolution", ("fprop", "dgrad", "wgrad", "implicit_gemm", "conv", "cudnn")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas")),
    ("optimizer and EMA (foreach)", ("multi_tensor_apply", "foreach")),
    ("softmax (VAE mid-attention)", ("softmax", "SoftMax")),
    ("elementwise and copies", ("elementwise", "copy", "reduce", "cat")),
]


def device_profile(fn, top=15):
    """One call of `fn` (already warmed up) timed on the host, then one under
    torch.profiler: host wall ms, device kernel ms, the device's busy share,
    device ms by PROFILE_CATEGORIES, and the `top` kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
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
    return {"host_wall_ms": wall_ms, "device_kernel_ms": device_ms_total,
            "device_busy_share": device_ms_total / wall_ms,
            "by_category_ms": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
            "top": [{"name": k[:100], "ms": us / 1e3, "calls": c} for us, k, c in rows[:top]]}


def phase_profile(model):
    """Device time of one UNet forward by CUDA kernel (torch.profiler), and the
    device's busy share against the host time of an unprofiled forward."""
    import torch

    cfg = model.config.unet
    gen = torch.Generator(device="cuda").manual_seed(2)
    s = cfg.sample_size
    x = torch.randn(UNET_BATCH, cfg.in_channels, s, s, generator=gen, device="cuda")
    t = torch.full((UNET_BATCH,), 501, device="cuda")
    ctx = torch.randn(UNET_BATCH, 77, cfg.cross_attention_dim, generator=gen, device="cuda")
    with torch.inference_mode():
        model.apply_unet(x, t, ctx)
        prof = device_profile(lambda: model.apply_unet(x, t, ctx))
    emit({"phase": "profile", "what": "one sd2_base UNet forward, batch 16, bf16", **prof})


def phase_unet_grad(model, mm_paths):
    """One full-width UNet forward and backward at batch 4 under bf16 autocast
    over fp32 weights, with a random cotangent on the output: through the
    kernels (attention forward and backward, GroupNorm) against the plain
    versions, on the gradient of every UNet parameter; and both against an
    fp32 run through the plain versions, which shows the bf16 noise floor
    they share."""
    import contextlib

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
        with kernels.plain_versions() if plain else contextlib.nullcontext():
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
                out = unet(x, t, ctx)
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
    want = all_counts({"flash_attention_fwd": 32, "flash_attention_dq": 32,
                       "flash_attention_dkv": 32, "group_norm_silu": count_groupnorms(unet),
                       "skinny_matmul": 2 * len(mm_paths["grad_unet"])})   # forward and dx
    if not (finite and launches == want and fast_ref <= VS_PLAIN * plain_ref):
        raise AssertionError(f"UNet gradient kernel vs plain: vs fp32 {fast_ref} / {plain_ref}, "
                             f"finite {finite}, launches {launches}")


def train_inputs(model, tc, seed):
    """A maker of synthetic batches of the recipe's shape (train_batch_size
    outfits x 4 items; latents as the VAE's moments, or with `images=True`
    512 px images in [-1, 1] that the step encodes) and the null conditions,
    made on the card from `seed`."""
    import torch

    from difashion_tpu_torch.engine.train import TrainBatch

    cfg = model.config
    s, C = cfg.unet.sample_size, cfg.vae.latent_channels
    B, olen = tc.train_batch_size, 4
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")

    def batch(images=False):
        ids = torch.randint(0, cfg.text.vocab_size, (B, olen, 77), generator=gen,
                            device="cuda")
        if images:
            px = cfg.vae.sample_size
            return TrainBatch(
                images=torch.rand(B, olen, px, px, 3, generator=gen, device="cuda") * 2 - 1,
                latent_mean=None, latent_logvar=None, input_ids=ids,
                hist_latents=r(B, olen, s, s, C) * 0.3)
        return TrainBatch(
            images=None, latent_mean=r(B, olen, s, s, C) * 4.0,
            latent_logvar=torch.rand(B, olen, s, s, C, generator=gen, device="cuda") * 6 - 8,
            input_ids=ids, hist_latents=r(B, olen, s, s, C) * 0.3)
    with torch.no_grad():
        null_text = model.encode_text(torch.zeros(1, 77, dtype=torch.long, device="cuda"))[0]
    return batch, r(s, s, C) * 0.05, null_text


TRAIN_WARMUP, TRAIN_STEPS = 2, 10
DENSE_COST_ROUNDS, DENSE_COST_STEPS = 4, 3


def dense_route_cost(step, state, batches, null_latent, null_text, gen, want_mm):
    """Train steps with the Dense route as shipped and with every
    `Dense.forward` bound to `nn.Linear.forward` (F.linear: cuBLAS with the
    bias fused, no kernel, no autograd Function), a yardstick bound here
    only, in turns (route, linear, route, linear): one untimed step after
    each switch, then DENSE_COST_STEPS steps each between a synchronize and
    the next, timed by CUDA events and by the host clock. Returns the state
    and {variant: per-step ms lists and medians}, with the difference."""
    import torch

    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.layers import Dense

    shipped = Dense.forward
    out = {v: {"events_ms": [], "host_ms": []} for v in ("route", "linear")}
    launches = {}
    try:
        for _ in range(DENSE_COST_ROUNDS):
            for variant in ("route", "linear"):
                Dense.forward = shipped if variant == "route" else torch.nn.Linear.forward
                state, _ = step(state, batches[0], null_latent, null_text, gen)
                for i in range(DENSE_COST_STEPS):
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    torch.cuda.synchronize()
                    kernels.reset_launches()
                    t0 = time.perf_counter()
                    ev[0].record()
                    state, _ = step(state, batches[1 + i], null_latent, null_text, gen)
                    ev[1].record()
                    torch.cuda.synchronize()
                    out[variant]["host_ms"].append((time.perf_counter() - t0) * 1e3)
                    out[variant]["events_ms"].append(ev[0].elapsed_time(ev[1]))
                    launches[variant] = kernels.LAUNCHES["skinny_matmul"]
    finally:
        Dense.forward = shipped
    for v in out.values():
        v["median_host_ms"] = statistics.median(v["host_ms"])
        v["median_events_ms"] = statistics.median(v["events_ms"])
    out["route_minus_linear_host_ms"] = (out["route"]["median_host_ms"]
                                         - out["linear"]["median_host_ms"])
    out["skinny_launches_per_step"] = launches
    if launches != {"route": want_mm, "linear": 0}:
        raise AssertionError(f"dense route cost: skinny launches {launches}")
    return state, out


def phase_train(model, mm_paths):
    """The sd2_base recipe (TrainConfig defaults: fp32 master weights, bf16
    autocast, AdamW lr 1e-5, clip 1.0, EMA, min-SNR 5, the dropout windows,
    eta 0.1, 2 outfits x 4 items) through build_train_step: warm-up steps,
    then timed steps with CUDA events and the launches of each step; then one
    step with gradient checkpointing, one with 8-bit AdamW and one on an
    image batch, whose VAE encode (no gradient) runs inside the step."""
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
    n_gn = count_groupnorms(model.unet)
    n_mm = len(mm_paths["train_unet"])
    want = all_counts({"flash_attention_fwd": 32, "flash_attention_dq": 32,
                       "flash_attention_dkv": 32, "group_norm_silu": n_gn,
                       "skinny_matmul": n_mm + len(mm_paths["train_unet_dx"])})
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
    state, cost = dense_route_cost(step, state, batches, null_latent, null_text, gen,
                                   want["skinny_matmul"])
    emit({"phase": "train", "variant": "dense_route_cost", "config": "sd2_base",
          "recipe": "TrainConfig()", **cost})
    del state, rows
    # checkpointing recomputes every ResnetBlock2D and Transformer2D in the
    # backward (every gated Dense is inside a Transformer2D); the image batch
    # adds the encoder's GroupNorms and its mid-attention products
    from difashion_tpu_torch.nn.attention import Transformer2D
    from difashion_tpu_torch.nn.layers import ResnetBlock2D

    recomputed = count_groupnorms(model.unet, (ResnetBlock2D, Transformer2D))
    variants = [("gradient_checkpointing", TrainConfig(gradient_checkpointing=True),
                 dict(want, flash_attention_fwd=64, group_norm_silu=n_gn + recomputed,
                      skinny_matmul=want["skinny_matmul"] + n_mm),
                 batches[0]),
                ("use_8bit_adam", TrainConfig(use_8bit_adam=True), want, batches[0]),
                ("image_batch", TrainConfig(), dict(
                    want, group_norm_silu=n_gn + count_groupnorms(model.vae.encoder),
                    skinny_matmul=want["skinny_matmul"] + len(mm_paths["train_encode"])),
                 batch(images=True))]
    for name, vc, vwant, vbatch in variants:
        for p in model.parameters():
            p.grad = None
        torch.cuda.empty_cache()
        vstep, vinit = build_train_step(model, vc)
        vstate = vinit()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        vstate, m = vstep(vstate, vbatch, null_latent, null_text, gen)
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
    prof = device_profile(lambda: step(state, b, null_latent, null_text, gen), top=20)
    emit({"phase": "profile_train", "what": "one sd2_base recipe step, 2 x 4 rows",
          "split_ms": split, **prof})
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
            f"{prefix}bound_ms", f"{prefix}bound_by", f"{prefix}max_abs_err", f"{prefix}share",
            f"{prefix}host_us", "dkv_splits")
    source = extra.pop("source", f"difashion_tpu_torch/csrc/{name}.cu")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": extra.pop("replaces"), "launches": launches,
            "max_abs_err": max(r[f"{prefix}max_abs_err"] for r in rows),
            "ms": total(f"{prefix}ms"), "plain_ms": total(f"{prefix}plain_ms"),
            "bound_ms": bound, "bound_by": "operations" if by_ops >= bound / 2 else "bytes",
            "library_ms": total("library_ms"), "share_of_bound": bound / total(f"{prefix}ms"),
            "per": f"{per} ({sum(r[calls] for r in main)} calls)", **extra,
            "shapes": [{k: r[k] for k in keys if k in r} for r in rows]}


def gn_entry(gn_results, launches, train_launches, precompute_launches):
    """The GroupNorm kernel's entry of the kernels line: numbers per sampler
    UNet forward (61 calls at batch 16, bf16) and per call of every path,
    launches the main path's."""
    totals = path_totals(gn_results, [path for path, _ in GN_PATHS])
    main = totals["sampler_unet"]
    return {"name": "group_norm_silu", "route": "cuda",
            "source": "difashion_tpu_torch/csrc/group_norm_silu.cu",
            "replaces": "difashion_tpu/nn/pallas/groupnorm.py:40",
            "launches": launches["group_norm_silu"],
            "max_abs_err": max(r["max_abs_err"] for r in gn_results),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": main["library_ms"],
            "library": "F.group_norm then F.silu in the input dtype",
            "per": f"one sampler UNet forward ({main['calls']} calls, bf16)",
            "per_path": totals, "train_step_launches": train_launches["group_norm_silu"],
            "precompute_launches": precompute_launches["group_norm_silu"]}


def mm_entry(mm_results, mm_host, launches, train_launches, precompute_launches,
             serve_launches):
    """The skinny-N kernel's entry of the kernels line: numbers per sampler
    UNet forward (batch 16, bf16, each product with its bias or without) and
    per call of every path, launches the main path's, and those of a serve
    request, a train step and the precompute."""
    totals = mm_path_totals(mm_results, MM_TIMED)
    main = totals["sampler_unet"]
    return {"name": "skinny_matmul", "route": "cuda",
            "source": "difashion_tpu_torch/csrc/skinny_matmul.cu",
            "replaces": "tools/pallas_skinny_matmul.py:36",
            "launches": launches["skinny_matmul"],
            "max_abs_err": max(r["max_abs_err"] for r in mm_results),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "operations", "library_ms": main["library_ms"],
            "library": "torch.matmul(x, w.t()) for the products without a bias, "
                       "F.linear(x, w, b) for those with one, in the input dtype",
            "matmul_ms": main["matmul_ms"],
            "per": f"one sampler UNet forward ({main['calls']} calls, bf16)",
            "per_path": totals, "host_per_call": mm_host,
            "tile_n": sorted({(r["mkn"][2], r["w_kn"], r["tile_n"]) for r in mm_results}),
            "serve_request_launches": {k: v["skinny_matmul"] for k, v in serve_launches.items()},
            "train_step_launches": train_launches["skinny_matmul"],
            "precompute_launches": precompute_launches["skinny_matmul"]}


def kernels_line(results, launches, bwd_results, train_launches, gn_results,
                 precompute_launches, mm_results, mm_host, serve_launches, sd15_results,
                 f32_results, bwd_f32_results, f32_launches, bwd_sd15_results):
    """The forward's numbers are per sampler UNet forward (batch 16) and its
    launches the main path's; the backward kernels' numbers are per train
    step (batch 8, one backward per attention) and their launches one train
    step's; the fp32 kernels' numbers are per sampler UNet forward and per
    train step in fp32 and their launches the fp32 tiny path's (generation
    and a training step: `phase_fp32_reference`); the GroupNorm kernel's as
    `gn_entry` says, the skinny-N kernel's as `mm_entry` says."""
    fwd_rows = [dict(r, ms=r["kernel_ms"]) for r in results]
    sd15_rows = [dict(r, ms=r["kernel_ms"]) for r in sd15_results]
    f32_rows = [dict(r, ms=r["kernel_ms"]) for r in f32_results]
    library = ("F.scaled_dot_product_attention's backward, computing dQ, dK and dV "
               "together: the same number on both backward entries")
    pallas = "difashion_tpu/nn/pallas/flash_attention.py:"
    f32_source = "difashion_tpu_torch/csrc/flash_attention_f32.cu"
    sd15 = kernel_entry("flash_attention_fwd", sd15_rows, "calls_per_unet_forward", "",
                        "one sd15 UNet forward, d <= 128", 0, replaces=pallas + "50")

    def sd15_bwd(prefix, line):
        e = kernel_entry("flash_attention_" + prefix[:-1], bwd_sd15_results,
                         "calls_per_train_step", prefix, "one sd15 train step, d <= 128", 0,
                         replaces=pallas + line)
        return {k: e[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "share_of_bound",
                                  "per", "shapes")}

    return {"kernels": [
        kernel_entry("flash_attention_fwd", fwd_rows, "calls_per_unet_forward", "",
                     "one sampler UNet forward", launches["flash_attention_fwd"],
                     replaces=pallas + "50",
                     train_step_launches=train_launches["flash_attention_fwd"],
                     sd15_per_unet_forward={k: sd15[k] for k in
                                            ("ms", "plain_ms", "bound_ms", "library_ms",
                                             "per", "shapes")}),
        kernel_entry("flash_attention_dq", bwd_results, "calls_per_train_step", "dq_",
                     "one train step", train_launches["flash_attention_dq"],
                     replaces=pallas + "145", library=library,
                     main_path_launches=launches["flash_attention_dq"],
                     sd15_per_train_step=sd15_bwd("dq_", "145")),
        kernel_entry("flash_attention_dkv", bwd_results, "calls_per_train_step", "dkv_",
                     "one train step", train_launches["flash_attention_dkv"],
                     replaces=pallas + "191", library=library,
                     main_path_launches=launches["flash_attention_dkv"],
                     sd15_per_train_step=sd15_bwd("dkv_", "191")),
        kernel_entry("flash_attention_fwd_f32", f32_rows, "calls_per_unet_forward", "",
                     "one sampler UNet forward in fp32",
                     f32_launches["flash_attention_fwd_f32"], replaces=pallas + "50",
                     source=f32_source, main_path_launches=launches["flash_attention_fwd_f32"]),
        kernel_entry("flash_attention_dq_f32", bwd_f32_results, "calls_per_train_step", "dq_",
                     "one train step in fp32", f32_launches["flash_attention_dq_f32"],
                     replaces=pallas + "145", library=library, source=f32_source,
                     main_path_launches=launches["flash_attention_dq_f32"]),
        kernel_entry("flash_attention_dkv_f32", bwd_f32_results, "calls_per_train_step", "dkv_",
                     "one train step in fp32", f32_launches["flash_attention_dkv_f32"],
                     replaces=pallas + "191", library=library, source=f32_source,
                     main_path_launches=launches["flash_attention_dkv_f32"]),
        gn_entry(gn_results, launches, train_launches, precompute_launches),
        mm_entry(mm_results, mm_host, launches, train_launches, precompute_launches,
                 serve_launches),
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
    sd15_sites = [s for s in main_path_attention_sites(ModelConfig.sd15(), UNET_BATCH)
                  if s[5] <= 128]
    results, sd15_results, f32_results = phase_kernel(sites, sd15_sites)
    phase_sd15_unet()
    gn_results = phase_kernel_gn(groupnorm_sites(cfg))
    mm_paths = dense_sites(cfg)
    mm_results, mm_host = phase_kernel_mm(mm_paths)
    phase_reference()
    model = create_difashion(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    phase_unet(model, mm_paths)
    launches = phase_main_path(model, mm_paths)
    phase_profile(model)
    serve_launches = phase_serve(model, mm_paths)
    precompute_launches = phase_precompute(model, mm_paths)
    del model
    torch.cuda.empty_cache()
    # the training path, after the generation path: a backward leaves buffers
    # of its own (the autograd thread's cuBLAS workspace) that would count in
    # the main path's peak memory
    sd15_train_sites = [s for s in main_path_attention_sites(ModelConfig.sd15(), TRAIN_ROWS)
                        if s[5] <= 128]
    bwd_results, bwd_f32_results, bwd_sd15_results = phase_kernel_bwd(
        main_path_attention_sites(cfg, TRAIN_ROWS), sd15_train_sites)
    phase_train_reference()
    f32_launches = phase_fp32_reference()
    # fp32 master weights under bf16 autocast
    model = create_difashion(cfg, seed=0, device="cuda").prepare_for_training()
    phase_unet_grad(model, mm_paths)
    train_launches = phase_train(model, mm_paths)
    phase_profile_train(model)
    emit(kernels_line(results, launches, bwd_results, train_launches, gn_results,
                      precompute_launches, mm_results, mm_host, serve_launches, sd15_results,
                      f32_results, bwd_f32_results, f32_launches, bwd_sd15_results))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

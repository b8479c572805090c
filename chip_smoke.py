#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`difashion_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

It drives the port's paths at the sd2_base widths through the entry
points a user calls, DiFashion's GOR generation, the generation service
(DPM-Solver++ at 20 steps, the fast-serving recipe), its training step, the
train command around it (checkpoints and a resume, and a checkpoint in the
JAX package's layout), the catalog precompute (VAE encode at 512 px), the
catalog features command with its evaluation towers (ViT-H/14 at full
width), the evaluate and parity commands over generated runs, and a short
leg of the mid-scale learning proof, and checks every hand-written
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
     cross-attentions), all in bf16, and the fp32 kernels (3xTF32 on the
     tensor cores: wgmma at d = 64 and 40, mma.sync at 80) at the sampler's
     shapes and sd15's in fp32; per site its time, the plain version's, one
     library call's (F.scaled_dot_product_attention, timed as a yardstick
     only), the card's lower bound for the same work and its share of it
     (the fp32 rows also their share of the SIMT bound the earlier fp32
     forward was read against), TFLOP/s and the wrapper's host microseconds
     per call;
  3a. sd15_unet: one full-width sd15 UNet forward (bf16, seeded weights,
     batch 16) through the kernels against one through the plain versions
     (d = 40 and 80 on the forward kernel, d = 160 plain), both against fp32;
  3b. kernel_gn: the GroupNorm(+SiLU) kernel against its plain version at
     every distinct GroupNorm shape of the sampler's UNet forward (batch 16),
     the train step's (batch 8), the VAE decode (batch 4) and the VAE encode
     at the precompute batch (64, 2^31 elements at its first level), in bf16
     and fp32, with and without SiLU, on channels-last input (the models'
     layout): per shape the kernel's plan (route, band of k groups, cluster
     size or chunks), its time, its share of the bound, the plain version's
     time, the library's (F.group_norm then F.silu on an NCHW copy, its best
     case; a yardstick only) and the bound; every UNet shape must take the
     one-read route;
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
  7. profile: the CUDA kernels of one UNet forward by device time, with the
     layout (NCHW <-> NHWC) and copy buckets on their own;
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
     sd2_base VAE in bf16, from in-memory arrays (no decode), then
     `build_processed_cache` on a synthetic outfit table and history;
     seconds per 1000 items, peak memory, 22 GroupNorm launches per batch,
     and one batch's moments through the kernels and through the plain
     versions, both against fp32;
  7c. native_loader: the native image library built from
     `native/difashion_io.cc` (its seconds; where it cannot be built, why,
     and the PIL path is the command's), 256 synthetic 512 px JPEG and RGBA
     PNG items through the native path (one by one and on its thread pool)
     and the PIL path, ms per item each, and native against PIL;
  7d. eval_towers: every evaluation tower at full width in fp32 (OpenCLIP
     ViT-H/14 image on 200 images and text on the 50 eval prompts, both
     InceptionV3s on 64 images at 299, LPIPS-VGG16 on 16 pairs at 512, the
     compatibility net on 256 outfits): ms per batch, items per second, peak
     bytes, and 2 rows against the same tower on the CPU in fp32;
  7e. extract_clip: `extract-features --stage all --device cuda` over those
     256 items at the sd2_base widths: the VAE stage's files and launches
     (the precompute's per batch), the CLIP features bit for bit against a
     direct `Extractors.clip_image_embs`, the history means, and seconds per
     1000 items per stage split into the loader's and the rest;
  7f. evaluate_parity: the parity command (generate -> evaluate with the
     grounding cascade -> the 2 % table) at the sd2_base widths with the
     full-size towers at random weights, in FITB (16 UNet rows) and GOR (32),
     over a test split on those items and a checkpoint of the seeded model;
     evaluate again over the cached runs; parity against the run's own
     results, then against its FID x 1.05 (refused): every metric of the
     four cascades finite, no tower called when cached, the cascade's CLIP
     scores against the metric on direct tower features, each UNet forward's
     launches (the main path's at 16 rows), the memory held when evaluate
     starts; generate seconds and evaluate seconds per image split into the
     loader, each tower and the rest, and the peak;
  8. kernel_bwd: the dQ and dK/dV kernels against the plain backward at the
     training UNet's attention shapes (batch 8 = 2 outfits x 4 items) and the
     ragged ones, both held against the plain backward in fp32, with their
     times, the plain versions', the library backward's, the bounds and each
     kernel's share of its bound, the dK/dV split count and the wrapper's
     host microseconds per call, also at sd15's training shapes (d = 40 and
     80, read in place); and the fp32 dQ and dK/dV kernels (3xTF32 on the
     tensor cores) against the fp32 plain backward at the training shapes,
     with each kernel's share of its 3xTF32 bound and of the SIMT bound the
     earlier fp32 kernels were read against;
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
 12. profile_train: one training step by CUDA kernel (the layout and copy
     buckets on their own) and its split into forward, backward and
     optimizer/EMA;
 13. train_fp32: one full-width sd2_base train step with
     mixed_precision="no" (fp32 throughout, the path the JAX package's
     train command builds for any precision but bf16), 8 rows, after one
     warm-up step: seconds by CUDA events, peak memory, launches (the fp32
     forward, dQ and dK/dV kernels under every attention), and one profiled
     step's device time with the fp32 forward's share and the fp32 dQ and
     dK/dV kernels';
 14. train_cli: the train command (`cli/train.py::main --device cuda`) at
     the sd2_base widths with the recipe on a synthetic 64-outfit dataset:
     3 steps and checkpoint-3 (~14 GB, in a temporary directory deleted at
     the end), the checkpoint loaded into a fresh template and held bit for
     bit against the state the command returned, then a resume from it and
     step 4; per leg its seconds per step, peak memory and launches (every
     step's equal to the train phase's), the checkpoint's bytes and its
     snapshot, write and load seconds, and the logged losses read back from
     the JSONL and the TensorBoard events;
 15. info: `cli/info.py --json` on the card: its device kind, and its
     memory plan (on the meta device) against the train command's live
     state (exactly) and the train phase's peak;
 16. jax_checkpoint: an sd2_base train state written in the JAX package's
     layout (flax msgpack), read into a fresh cuda state bit for bit, the
     read's seconds, host peak RSS and device peak against the fresh
     state's, then one train step from it.
 17. learning_proof: `scripts/learning_proof_cuda.py --steps 100` at the mid
     config (two legs of 50 with a resume, four generation runs, the report):
     the legs, checkpoints, runs and report, the same launches every train
     step (flash forward, dQ, dK/dV, GroupNorm) and every sampler forward,
     finite losses; seconds per step (the gates are the 6000-step run's).

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
PEAK_FP32_FLOPS = 67e12      # outside the tensor cores: the SIMT bound kept beside the fp32 rows
PEAK_TF32_FLOPS = 495e12     # the tensor cores' TF32 rate: the fp32 kernels run 3xTF32
PEAK_HBM_BYTES = 3.35e12

# kernel vs plain, bf16 inputs: P is rounded to bf16 before the PV product
# (as in the TPU kernel); the plain version keeps it in fp32. The bound of
# tests/test_flash_attention.py::test_flash_bf16_precision.
MAX_ABS_TOL, MEAN_ABS_TOL = 3e-2, 3e-3
# the LSE is fp32 from the same bf16 products: ex2.approx and another
# summation order only
LSE_TOL = 1e-3
# the fp32 kernels vs their plain versions in fp32 (TF32 off for PyTorch's
# products): fp32 sums in another order and exp2f for exp. The kernels run
# 3xTF32 on the tensor cores (each operand split into a TF32 high part and
# remainder, three products summed: about 2^-22 of a product, where fp32
# keeps 2^-24), which keeps fp32 accuracy and so is not a TF32 pass that
# allow_tf32 would gate. The forward's O and LSE within 2e-5 per element; a
# backward gradient within 2e-5 relative L2 (sums of up to 4096 terms: about
# sqrt(4096) * 3 * 2^-22 = 5e-6, with margin)
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
    2*Sq*Skv*d each per (batch, head) at the rate of the kernel's design:
    the bf16 tensor-core rate, and for fp32 three times the operations
    (3xTF32) at the TF32 rate; q, k, v read once, o written once in the
    input dtype, the LSE written once in fp32."""
    f32 = dtype is not None and str(dtype) == "torch.float32"
    ops = _forward_ops(b, h, sq, skv, d)
    nbytes = _forward_bytes(b, h, sq, skv, d, 4.0 if f32 else 2.0)
    t_ops = 3 * ops / PEAK_TF32_FLOPS if f32 else ops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def _forward_ops(b, h, sq, skv, d):
    return 4.0 * b * h * sq * skv * d


def _forward_bytes(b, h, sq, skv, d, size):
    return size * b * h * d * (2 * sq + 2 * skv) + 4.0 * b * h * sq


def backward_bound(kind, b, h, sq, skv, d, dtype=None):
    """(bound ms, 'operations' or 'bytes', ops, bytes) of one backward kernel:
    dQ is 3 products (6*B*H*Sq*Skv*d operations), dK/dV 4 (8*B*H*Sq*Skv*d),
    at the rate of the kernel's design: the bf16 tensor-core rate, and for
    fp32 three times the operations (3xTF32) at the TF32 rate; q, k, v and
    dO read once in the input dtype, the LSE and D once in fp32, the
    kernel's gradients written once in the input dtype."""
    f32 = dtype is not None and str(dtype) == "torch.float32"
    ops = _backward_ops(kind, b, h, sq, skv, d)
    nbytes = _backward_bytes(kind, b, h, sq, skv, d, 4.0 if f32 else 2.0)
    t_ops = 3 * ops / PEAK_TF32_FLOPS if f32 else ops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def simt_bound_ms(kind, b, h, sq, skv, d):
    """An fp32 kernel's bound ("fwd", "dq" or "dkv") as SIMT FFMA would have
    it (the operations at the fp32 rate outside the tensor cores, or the
    bytes): the bound the fp32 kernels' shares were read against before they
    moved to the tensor cores, kept for comparison."""
    if kind == "fwd":
        ops, nbytes = _forward_ops(b, h, sq, skv, d), _forward_bytes(b, h, sq, skv, d, 4.0)
    else:
        ops = _backward_ops(kind, b, h, sq, skv, d)
        nbytes = _backward_bytes(kind, b, h, sq, skv, d, 4.0)
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3


def _backward_ops(kind, b, h, sq, skv, d):
    return 2.0 * (3 if kind == "dq" else 4) * b * h * sq * skv * d


def _backward_bytes(kind, b, h, sq, skv, d, size):
    written = sq if kind == "dq" else 2 * skv
    return size * b * h * d * (2 * sq + 2 * skv + written) + 8.0 * b * h * sq


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


def ptxas_entries(log):
    """Each entry of an `nvcc -Xptxas -v` log: {kernel (its mangled name),
    registers, spill store and load bytes}."""
    out = []
    for block in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        out.append({"kernel": block.split("'", 1)[0],
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None,
                    "spill_load_bytes": int(spill.group(2)) if spill else None})
    return out


def phase_build():
    from difashion_tpu_torch.nn import kernels

    t0 = time.perf_counter()
    logs = kernels.build_all()
    seconds = time.perf_counter() - t0
    # registers and spills of every instantiation, and warnings (a setmaxnreg
    # the compiler ignored)
    ptxas = {name: ptxas_entries(log) for name, log in logs.items()}
    warnings = {name: [ln.strip() for ln in log.splitlines() if "warning" in ln]
                for name, log in logs.items()}
    # bytes of spill stores summed over each source's instantiations
    spills = {name: sum(e["spill_store_bytes"] or 0 for e in entries)
              for name, entries in ptxas.items()}
    emit({"phase": "build", "kernels": list(logs), "seconds": seconds,
          "spill_store_bytes": spills, "ptxas": ptxas,
          "warnings": {k: v for k, v in warnings.items() if v}})


def phase_kernel(sites, sd15_sites):
    """The forward kernel against its plain version, timed beside its plain
    version, SDPA (a yardstick only) and the bound, with its share of the
    bound, TFLOP/s and the wrapper's host microseconds per call: at the
    sampler's sites and EXTRA_SHAPES in bf16, the sd15 UNet's sites (d = 40
    and 80) in bf16, and the sampler's and sd15's sites in fp32 (the fp32
    kernels, an fp32 model's path: wgmma at d = 64 and 40, mma.sync at 80;
    beside the 3xTF32 bound, the SIMT one). Returns the four lists of rows."""
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
                       for n, b, h, sq, skv, d, c in sites],
              "sd15_fp32": [(n, b, h, sq, skv, d, c, torch.float32)
                            for n, b, h, sq, skv, d, c in sd15_sites]}
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
            if f32:
                simt = simt_bound_ms("fwd", b, h, sq, skv, d)
                row.update({"simt_bound_ms": simt, "simt_share": simt / kernel_ms})
            emit(row)
            results.append(row)
            del q, k, v, o, lse
            torch.cuda.empty_cache()
    rows = [r for rs in out.values() for r in rs]
    # the SIMT bound only for the fp32 groups, whose rows carry it
    totals = {config: {key: sum(r[key] * r["calls_per_unet_forward"] for r in rs)
                       for key in ("kernel_ms", "library_ms", "bound_ms", "plain_ms",
                                   "simt_bound_ms") if key in rs[0]}
              for config, rs in out.items()}
    emit({"phase": "kernel", "per_unet_forward": totals,
          "host_per_call": flash_host_per_call(sites[0])})
    bad = [(r["config"], r["site"]) for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_attention_fwd disagrees with its plain version at {bad}")
    return out["sd2_base"], out["sd15"], out["fp32"], out["sd15_fp32"]


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
           "loader": "in-memory uint8 arrays to float (no file, no decode)",
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
    share of its bound (`dq_share`, `dkv_share`; in fp32 also of the SIMT
    bound, `dq_simt_share`, `dkv_simt_share`), the dK/dV kernel's split
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
            if f32:
                simt = simt_bound_ms(kind, b, h, sq, skv, d)
                row.update({f"{kind}_simt_bound_ms": simt,
                            f"{kind}_simt_share": simt / row[f"{kind}_ms"]})
        row["dkv_splits"] = dkv_splits(b, h, sq, skv, d, dtype)
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
    and with SiLU, on channels-last x: against its plain version on the same
    inputs, with its plan, times and the bound (x read once, y written once,
    scale and bias read once). Every UNet site must take the one-read
    route."""
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn.kernels.groupnorm import (
        gn_plan,
        group_norm_silu,
        group_norm_silu_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    results = []
    for site in sites:
        shape, groups, eps = site["shape"], site["groups"], site["eps"]
        c = shape[1]
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        bias = torch.randn(c, generator=gen, device="cuda") * 0.2
        nhwc = [shape[0]] + shape[2:] + [c]
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(nhwc, generator=gen, device="cuda", dtype=dtype).mul_(2).add_(0.5)
            x = x.movedim(-1, 1)                      # channels-last [B, C, H, W]
            plan = gn_plan(x.shape, groups, dtype)
            pre = group_norm_silu_ref(x, scale, bias, groups, eps)
            lib_w, lib_b = scale.to(dtype), bias.to(dtype)
            x_nchw = x.contiguous()                   # F.group_norm's own layout
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
                    out = F.group_norm(x_nchw, groups, lib_w, lib_b, eps)
                    return F.silu(out) if act else out

                row = {"phase": "kernel_gn", "shape": shape, "groups": groups, "eps": eps,
                       "dtype": str(dtype).replace("torch.", ""), "act": act,
                       "elements": x.numel(), "route": plan.route, "k": plan.k,
                       ("cluster" if plan.route == "one_read" else "chunks"): plan.n,
                       "slice_bytes": plan.slice_bytes(c // groups, x.element_size()),
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
                row["share"] = row["bound_ms"] / row["ms"]
                if dtype == torch.bfloat16 and x.numel() < 2 ** 27:
                    row["host_us"] = host_us_per_call(
                        lambda: group_norm_silu(x, scale, bias, groups, eps, act))
                row["ok"] = ok
                emit(row)
                results.append(row)
            del x, x_nchw, pre
            torch.cuda.empty_cache()
    bad = [(r["shape"], r["dtype"], r["act"]) for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"group_norm_silu disagrees with its plain version at {bad}")
    two_pass = [r["shape"] for r in results if r["route"] != "one_read"
                and any(r["calls"].get(p) for p in ("sampler_unet", "train_unet"))]
    if two_pass:
        raise AssertionError(f"UNet GroupNorm shapes off the one-read route: {two_pass}")
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


def dense_sites(cfg, paths=DENSE_PATHS):
    """{path: [(M, K, N, bias) of each gated Dense call]} for `paths`,
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
        for path, what, b in paths:
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
    if "train_unet" in calls:
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
    ("group_norm_silu", ("gn_cluster_kernel", "gn_partials_kernel", "gn_finalize_kernel",
                         "gn_apply_kernel")),
    ("skinny_matmul", ("skinny_matmul_kernel",)),
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("flash_attention_dq", ("flash_dq_kernel",)),
    ("flash_attention_dkv", ("flash_dkv_kernel",)),
    ("flash_attention_fwd_f32", ("fwd_wg_kernel", "fwd_tc_kernel")),
    ("flash_attention_dq_f32", ("dq_tc_kernel", "dq_wg_kernel")),
    ("flash_attention_dkv_f32", ("dkv_tc_kernel", "dkv_wg_kernel", "dkv_f32_reduce_kernel")),
    ("layout NCHW<->NHWC", ("nchwToNhwc", "nhwcToNchw")),
    ("norm statistics", ("layer_norm", "RowwiseMoments", "group_norm", "GroupNorm")),
    ("convolution", ("fprop", "dgrad", "wgrad", "implicit_gemm", "conv", "cudnn")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas")),
    ("optimizer and EMA (foreach)", ("multi_tensor_apply", "foreach")),
    ("softmax (VAE mid-attention)", ("softmax", "SoftMax")),
    ("copies", ("copy",)),
    ("elementwise", ("elementwise", "reduce", "cat")),
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
            "layout_ms": by_category.get("layout NCHW<->NHWC", 0.0),
            "copies_ms": by_category.get("copies", 0.0),
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
    return train_launches, peak, seconds


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


def phase_train_fp32(model):
    """One full-width train step in fp32: the sd2_base recipe with
    mixed_precision="no" (autocast off, fp32 throughout: what a model built
    for any precision but "bf16" trains with), 8 rows, through
    build_train_step. One warm-up step, then one step timed with CUDA events
    (its seconds, peak memory and launches: the fp32 forward, dQ and dK/dV
    kernels under each of the 32 attentions, no 16-bit flash kernel), then
    one step under torch.profiler: device time by kernel, the fp32 forward's
    share of it and the fp32 dQ and dK/dV kernels'. Returns the numbers."""
    import torch

    from difashion_tpu_torch.config import TrainConfig
    from difashion_tpu_torch.engine.train import build_train_step
    from difashion_tpu_torch.nn import kernels

    tc = TrainConfig(mixed_precision="no")
    batch, null_latent, null_text = train_inputs(model, tc, seed=9)
    gen = torch.Generator(device="cuda").manual_seed(tc.seed)
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    step, init = build_train_step(model, tc)
    state = init()
    b0, b1 = batch(), batch()
    state, _ = step(state, b0, null_latent, null_text, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    state, m = step(state, b1, null_latent, null_text, gen)
    ev[1].record()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(lambda: step(state, b0, null_latent, null_text, gen), top=12)
    bwd_ms = sum(prof["by_category_ms"].get(k, 0.0)
                 for k in ("flash_attention_dq_f32", "flash_attention_dkv_f32"))
    fwd_ms = prof["by_category_ms"].get("flash_attention_fwd_f32", 0.0)
    out = {"seconds_per_step": ev[0].elapsed_time(ev[1]) / 1e3, "peak_memory_bytes": peak,
           "fwd_f32_device_ms": fwd_ms,
           "fwd_f32_share_of_device": fwd_ms / prof["device_kernel_ms"],
           "dq_dkv_f32_device_ms": bwd_ms,
           "dq_dkv_f32_share_of_device": bwd_ms / prof["device_kernel_ms"],
           "loss": float(m["loss"]), "update_skipped": float(m["update_skipped"])}
    emit({"phase": "train_fp32", "config": "sd2_base",
          "recipe": 'TrainConfig(mixed_precision="no")', "rows_per_step": TRAIN_ROWS,
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32},
          **out, "launches": launches, "profile": prof})
    del state
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    flash = {k: v for k, v in launches.items() if k.startswith("flash")}
    want = {k: (32 if k.endswith("_f32") else 0) for k in flash}
    if not (flash == want and math.isfinite(out["loss"]) and out["update_skipped"] == 0.0
            and launches["group_norm_silu"] == count_groupnorms(model.unet)):
        raise AssertionError(f"train_fp32: launches {launches}, loss {out['loss']}, "
                             f"skipped {out['update_skipped']}")
    return out


TRAIN_CLI_ROWS, TRAIN_CLI_ITEMS = 64, 128   # the synthetic outfit table, the catalog


def write_train_cli_dataset(root, cfg):
    """A synthetic dataset for the train command: an outfit table of 64 rows x
    4 items over a 128-item catalog and 5 categories, a history table, and
    the catalog's VAE moments [128, 64, 64, 4] (mean ~ N(0, 4^2), logvar in
    [-8, -2]) written through the port's `save_processed`."""
    import numpy as np

    from difashion_tpu_torch.data.precompute import save_processed

    rng = np.random.RandomState(11)
    n = TRAIN_CLI_ROWS
    table = {"uids": list(rng.randint(1, 9, n)), "oids": list(range(1000, 1000 + n)),
             "outfits": [list(o) for o in rng.randint(1, TRAIN_CLI_ITEMS, (n, 4))],
             "category": [list(c) for c in rng.randint(1, 6, (n, 4))]}
    history = {u: {c: list(rng.randint(1, TRAIN_CLI_ITEMS, 3)) for c in range(1, 6)}
               for u in range(1, 9)}
    for name, d in (("train.npy", table), ("train_history.npy", history),
                    ("id_cate_dict.npy", {1: "pants", 2: "shoes", 3: "bag", 4: "t-shirt",
                                          5: "earrings"})):
        np.save(os.path.join(root, name), np.array(d, dtype=object))
    s, C = cfg.unet.sample_size, cfg.vae.latent_channels
    shape = (TRAIN_CLI_ITEMS, s, s, C)
    save_processed(root, "all_item_moments",
                   mean=(rng.randn(*shape) * 4.0).astype(np.float32),
                   logvar=rng.uniform(-8, -2, shape).astype(np.float32))


class TrainCliProbe:
    """Instruments `cli/train.py` from outside for the train_cli phase: the
    step that `build_train_step` returns is wrapped to record each call's
    launches (the difference of the counters around it), the TrainState's
    step at entry, the host clock at entry (the loop's interval from one step
    to the next: batch assembly and the step's dispatch and sync) and CUDA
    events around it; `checkpoint.snapshot` (the device -> host copy),
    `CheckpointStore._write` (the files, on the writer thread) and
    `CheckpointStore.load` are timed. `restore()` puts the originals back."""

    def __init__(self):
        from difashion_tpu_torch import checkpoint
        from difashion_tpu_torch.cli import train as train_cli

        self.steps, self.times = [], {"snapshot": [], "write": [], "load": []}
        self._orig = [(train_cli, "build_train_step", train_cli.build_train_step),
                      (checkpoint, "snapshot", checkpoint.snapshot),
                      (checkpoint.CheckpointStore, "_write", checkpoint.CheckpointStore._write),
                      (checkpoint.CheckpointStore, "load", checkpoint.CheckpointStore.load)]
        build, snapshot, write, load = (o[2] for o in self._orig)
        probe = self

        def timed(kind, fn):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                probe.times[kind].append(time.perf_counter() - t0)
                return out
            return run

        def build_train_step(model, cfg):
            import torch

            from difashion_tpu_torch.nn import kernels

            step, init = build(model, cfg)

            def counted(state, *args):
                before = dict(kernels.LAUNCHES)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                at, t0 = state.step, time.perf_counter()
                ev[0].record()
                out = step(state, *args)
                ev[1].record()
                probe.steps.append({"at_step": at, "events": ev, "host_start": t0, "launches": {
                    k: kernels.LAUNCHES[k] - before.get(k, 0) for k in kernels.COUNTERS}})
                return out
            return counted, init

        train_cli.build_train_step = build_train_step
        checkpoint.snapshot = timed("snapshot", snapshot)
        checkpoint.CheckpointStore._write = timed("write", write)
        checkpoint.CheckpointStore.load = timed("load", load)

    def restore(self):
        for obj, name, fn in self._orig:
            setattr(obj, name, fn)


def state_tensors(state):
    """The tensors of a TrainState with AdamW: {group: [tensor]}."""
    return {"params": list(state.params), "mu": list(state.opt_state.mu),
            "nu": list(state.opt_state.nu), "ema": list(state.ema.params)}


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def phase_train_cli(train_launches, train_seconds):
    """The train command (`cli/train.py::main --device cuda`) at the sd2_base
    widths on a synthetic dataset written into a temporary directory, with
    the sd2_base recipe (`Config.preset_eta01()`: fp32 master weights, bf16
    autocast, AdamW, EMA, min-SNR, 2 outfits x 4 items), seeded random
    weights and the hash tokenizer, through a config file with
    checkpointing_steps 3 and checkpoints_total_limit 1. Leg 1 runs steps
    0-2 and saves checkpoint-3; its checkpoint is loaded through
    `CheckpointStore.load` into a fresh template and held bit for bit
    against the state leg 1 returned; leg 2 resumes from the latest and runs
    step 3. Checks: every step's launches equal the train phase's for every
    counter; leg 2 starts at step 3 and ends at step 4; its peak memory is
    within one trainable copy of leg 1's; the JSONL losses are finite and
    equal the TensorBoard events' (read back through the port's
    `read_events`). Prints seconds per step (CUDA events around each step,
    and the host's interval between steps beside the train phase's
    `train_seconds`), peak memory, and the bytes and seconds of the
    checkpoint's write and load. Returns the bytes of leg 1's TrainState
    tensors by group."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from difashion_tpu_torch.checkpoint import CheckpointStore
    from difashion_tpu_torch.cli import train as train_cli
    from difashion_tpu_torch.config import Config
    from difashion_tpu_torch.core.tensorboard import read_events
    from difashion_tpu_torch.engine.train import AdamState, EMAState, TrainState
    from difashion_tpu_torch.nn import kernels

    root = tempfile.mkdtemp(prefix="difashion_train_cli_")
    probe = TrainCliProbe()
    try:
        cfg = Config.preset_eta01()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpointing_steps=3, checkpoints_total_limit=1))
        data, out = os.path.join(root, "data"), os.path.join(root, "ckpt")
        os.makedirs(data)
        write_train_cli_dataset(data, cfg.model)
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        args = ["--data_path", data, "--output_dir", out, "--config", cfg_path,
                "--device", "cuda"]
        free_disk = shutil.disk_usage(root).free

        def leg(steps, *extra):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            first = len(probe.steps)
            kernels.reset_launches()
            t0 = time.perf_counter()
            state, model = train_cli.main(args + ["--max_train_steps", str(steps), *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            totals = dict(kernels.LAUNCHES)
            rows = probe.steps[first:]
            return state, model, {
                "wall_seconds": wall, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "steps": len(rows), "first_step": rows[0]["at_step"] if rows else None,
                "step_ms": [r["events"][0].elapsed_time(r["events"][1]) for r in rows],
                "host_interval_ms": [(b["host_start"] - a["host_start"]) * 1e3
                                     for a, b in zip(rows, rows[1:])],
                "launches": totals}, rows

        state, model, leg1, rows1 = leg(3)
        trainable = sum(t.numel() * t.element_size() for t in state.params)
        live = {k: sum(t.numel() * t.element_size() for t in v)
                for k, v in state_tensors(state).items()}
        live_bytes = {"params_trainable": live["params"], "opt_state": live["mu"] + live["nu"],
                      "ema": live["ema"]}
        ckpt_bytes = dir_bytes(os.path.join(out, "checkpoint-3"))
        frozen_bytes = os.path.getsize(os.path.join(out, "frozen.pt"))
        end1 = (state.step, state.opt_state.count, state.ema.step)
        steps_after_leg1 = CheckpointStore(out).all_steps()

        # the checkpoint against leg 1's state, loaded into a fresh template
        empty = lambda ts: [torch.empty_like(t) for t in ts]
        template = TrainState(names=list(state.names), params=empty(state.params),
                              opt_state=AdamState(0, empty(state.opt_state.mu),
                                                  empty(state.opt_state.nu)),
                              ema=EMAState(empty(state.ema.params), 0))
        torch.cuda.synchronize()
        loaded = CheckpointStore(out).load(template)
        torch.cuda.synchronize()
        unequal = [f"{group} {name}"
                   for group, ts in state_tensors(state).items()
                   for name, a, b in zip(state.names, ts, state_tensors(loaded)[group])
                   if not torch.equal(a, b)]
        restored = {"bit_equal": not unequal, "unequal": unequal[:5],
                    "step": loaded.step, "opt_count": loaded.opt_state.count,
                    "ema_step": loaded.ema.step, "expected": list(end1)}
        del state, model, template, loaded
        torch.cuda.empty_cache()

        state, model, leg2, rows2 = leg(4, "--resume_from_checkpoint", "latest")
        end2 = (state.step, state.opt_state.count, state.ema.step)
        steps_after_leg2 = CheckpointStore(out).all_steps()
        del state, model
        torch.cuda.empty_cache()

        recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
        tb = os.path.join(out, "tb")
        events = [e for f in sorted(os.listdir(tb)) for e in read_events(os.path.join(tb, f))]
        tb_loss = {e["step"]: e["scalars"]["loss"] for e in events if "loss" in e["scalars"]}
        logged = [{"step": r["step"], "loss": r["loss"], "tb_loss": tb_loss.get(r["step"]),
                   "step_time_s": r["step_time_s"]} for r in recs if "loss" in r]
        times = probe.times
    finally:
        probe.restore()
        shutil.rmtree(root, ignore_errors=True)

    want = all_counts(train_launches)
    bad_steps = [{"leg": i, "at_step": r["at_step"], "launches": r["launches"]}
                 for i, rows in ((1, rows1), (2, rows2)) for r in rows
                 if r["launches"] != want]
    for lg in (leg1, leg2):
        lg["seconds_per_step"] = statistics.median(lg["step_ms"]) / 1e3
    row = {"phase": "train_cli", "config": "sd2_base", "recipe": "Config.preset_eta01()",
           "command": "cli/train.py::main --device cuda", "rows_per_step": TRAIN_ROWS,
           "dataset": {"outfits": TRAIN_CLI_ROWS, "items": TRAIN_CLI_ITEMS},
           "train_phase_seconds_per_step": train_seconds,
           "leg1": leg1, "leg2": leg2, "logged": logged,
           "checkpoint": {"bytes": ckpt_bytes, "frozen_bytes": frozen_bytes,
                          "snapshot_seconds": times["snapshot"],
                          "write_seconds": times["write"], "load_seconds": times["load"],
                          "free_disk_bytes": free_disk},
           "trainable_bytes": trainable, "live_state_bytes": live_bytes,
           "restored": restored, "end_leg1": list(end1), "end_leg2": list(end2),
           "checkpoints_after": {"leg1": steps_after_leg1, "leg2": steps_after_leg2},
           "peak_growth_bytes": leg2["peak_memory_bytes"] - leg1["peak_memory_bytes"]}
    emit(row)
    problems = []
    if bad_steps:
        problems.append(f"launches differ from the train phase's {want}: {bad_steps}")
    if not all(want[k] > 0 for k in ("flash_attention_fwd", "flash_attention_dq",
                                     "flash_attention_dkv", "group_norm_silu",
                                     "skinny_matmul")):
        problems.append(f"a kernel of the path was not launched: {want}")
    if [r["at_step"] for r in rows1] != [0, 1, 2] or [r["at_step"] for r in rows2] != [3]:
        problems.append(f"steps: leg 1 {[r['at_step'] for r in rows1]}, "
                        f"leg 2 {[r['at_step'] for r in rows2]}")
    for lg, n in ((leg1, 3), (leg2, 1)):
        if lg["launches"] != {k: n * v for k, v in want.items()}:
            problems.append(f"leg launches {lg['launches']} != {n} x a step's")
    if end1 != (3, 3, 3) or end2 != (4, 4, 4):
        problems.append(f"ends {end1}, {end2}")
    if not restored["bit_equal"] or [restored["step"], restored["opt_count"],
                                     restored["ema_step"]] != list(end1):
        problems.append(f"restored state {restored}")
    if row["peak_growth_bytes"] > trainable:
        problems.append(f"leg 2's peak exceeds leg 1's by {row['peak_growth_bytes']} bytes, "
                        f"more than one trainable copy ({trainable})")
    if steps_after_leg1 != [3] or steps_after_leg2 != [4]:
        problems.append(f"checkpoints {steps_after_leg1}, {steps_after_leg2}")
    if [r["step"] for r in logged] != [3, 4] or not all(
            math.isfinite(r["loss"]) and r["loss"] == r["tb_loss"] for r in logged):
        problems.append(f"logged losses {logged}")
    if problems:
        raise AssertionError("train_cli: " + "; ".join(problems))
    return live_bytes


def phase_info(live_state_bytes, train_peak):
    """`cli/info.py::main(["--json"])` on the card: its device kind must be
    the card's name, its planned params_trainable + opt_state + ema (on the
    meta device) the bytes of the train command's live TrainState exactly,
    and its data-parallel bytes per device at most the train phase's
    measured peak."""
    import contextlib
    import io

    import torch

    from difashion_tpu_torch.cli import info

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        info.main(["--json"])
    seconds = time.perf_counter() - t0
    got = json.loads(buf.getvalue())
    acc = got["hbm_accounting"]
    planned = sum(acc["buckets"][k] for k in ("params_trainable", "opt_state", "ema"))
    live = sum(live_state_bytes.values())
    emit({"phase": "info", "seconds": seconds, **got, "planned_state_bytes": planned,
          "live_state_bytes": live, "train_phase_peak_bytes": train_peak})
    if not (got["device_kind"] == torch.cuda.get_device_name(0) and got["backend"] == "cuda"
            and got["devices"] == torch.cuda.device_count()
            and all(acc["buckets"][k] == v for k, v in live_state_bytes.items())
            and acc["per_chip_bytes_dp"] <= train_peak):
        raise AssertionError(f"info: {got}, live state {live_state_bytes}, "
                             f"train peak {train_peak}")


# ---- slice 12: the native loader, JAX checkpoints, the evaluation towers ----------

NATIVE_ITEMS = 256          # synthetic catalog items, half JPEG, half RGBA PNG
NATIVE_MEAN_TOL, NATIVE_MAX_TOL = 0.01, 0.2   # tests/test_native_io.py's bound vs PIL
# the eval towers on the card (fp32, TF32 off) vs the same tower on the CPU in
# fp32 at 2 rows: the same fp32 arithmetic summed in another order
EVAL_REL_L2_TOL = 1e-4
CLIP_IMAGES, INCEPTION_IMAGES, LPIPS_PAIRS, COMPAT_OUTFITS = 200, 64, 16, 256


def write_synthetic_catalog(root, n, px=512, seed=13):
    """n catalog images under root: even items JPEG (RGB, quality 90), odd
    items RGBA PNG, 512 px wide and 384-512 px high (padded to a square by
    the catalog pipeline), smooth colour fields with noise on white. Returns
    the file names."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    names = []
    for i in range(n):
        h = int(rng.randint(384, px + 1))
        low = rng.randint(0, 256, (8, 8, 3)).astype(np.float32)
        field = np.kron(low, np.ones((px // 8, px // 8, 1)))[:h]
        img = np.clip(field + rng.randn(h, px, 3) * 12, 0, 255).astype(np.uint8)
        img[:, :24] = 255
        if i % 2:
            alpha = np.full((h, px, 1), 255, np.uint8)
            alpha[: h // 6] = 0
            name = f"item{i:04d}.png"
            Image.fromarray(np.concatenate([img, alpha], axis=2), "RGBA").save(
                os.path.join(root, name))
        else:
            name = f"item{i:04d}.jpg"
            Image.fromarray(img).save(os.path.join(root, name), quality=90)
        names.append(name)
    return names


def phase_native_loader(img_dir, names):
    """The native image library (`data/native.py`): its build from
    `native/difashion_io.cc` and its seconds (or the failed attempt's), then the catalog pipeline over
    NATIVE_ITEMS synthetic 512 px items by the native path (one at a time,
    and batched on its thread pool) and by the PIL path, ms per item each,
    and the native images against PIL's (tests/test_native_io.py's bound).
    Where the library cannot be built (no libjpeg / libpng headers), the
    command takes the PIL path: the row says so and why, and times PIL."""
    import numpy as np
    from PIL import Image

    from difashion_tpu_torch.cli.extract_features import make_item_loader
    from difashion_tpu_torch.data import native
    from difashion_tpu_torch.data.preprocessing import prepare_catalog_image

    t0 = time.perf_counter()
    available = native.native_available()      # builds it (nothing is built in a checkout)
    build_s = time.perf_counter() - t0
    loader = make_item_loader(img_dir, names, 512)

    def pil(i):
        img = Image.open(os.path.join(img_dir, names[i]))
        return np.asarray(prepare_catalog_image(img, 512), np.float32) / 127.5 - 1.0

    t0 = time.perf_counter()
    ref = np.stack([pil(i) for i in range(len(names))])
    pil_ms = (time.perf_counter() - t0) * 1e3 / len(names)
    row = {"phase": "native_loader", "items": len(names), "px": 512,
           "formats": "JPEG (RGB) and PNG (RGBA), 512 x 384..512",
           "native_available": available, "native_unavailable_reason": native.unavailable(),
           "build_seconds": build_s,
           "command_loader": loader.kind, "pil_ms_per_item": pil_ms,
           "cpu_cores": os.cpu_count()}
    ok = loader.kind == ("native" if available else "pil") and np.isfinite(ref).all()
    if available:
        t0 = time.perf_counter()
        one = np.stack([loader(i) for i in range(len(names))])
        row["native_ms_per_item"] = (time.perf_counter() - t0) * 1e3 / len(names)
        pool = native.NativeCatalogLoader([os.path.join(img_dir, n) for n in names], 512)
        t0 = time.perf_counter()
        batched = pool.load(list(range(len(names))))
        row["native_pool_ms_per_item"] = (time.perf_counter() - t0) * 1e3 / len(names)
        pool.close()
        diff = np.abs(one - ref)
        row.update(mean_abs_diff=float(diff.mean()), max_abs_diff=float(diff.max()),
                   pool_equals_single=bool(np.array_equal(batched, one)))
        ok = ok and row["pool_equals_single"] and diff.mean() < NATIVE_MEAN_TOL \
            and diff.max() < NATIVE_MAX_TOL
    emit(row)
    if not ok:
        raise AssertionError(f"native_loader: {row}")
    return loader.kind


def rss_bytes():
    """This process's resident set (Linux /proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class RssPeak:
    """The largest resident set seen while the block runs, sampled every
    2 ms on a thread (VmHWM cannot be reset in the card's sandbox)."""

    def __enter__(self):
        import threading

        self.peak, self._stop = rss_bytes(), threading.Event()

        def watch():
            while not self._stop.wait(0.002):
                self.peak = max(self.peak, rss_bytes())
        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def phase_jax_checkpoint(train_launches):
    """The JAX package's checkpoint layout at the sd2_base widths: a train
    state of the recipe (fp32 parameters, AdamW moments seeded off zero,
    EMA, step and count 3) written with `CheckpointStore.save_jax_layout`
    (flax msgpack by `core/msgpack.py`, which the CPU tests hold byte for
    byte against flax), read back by `CheckpointStore.load` into a fresh
    cuda state, every tensor, step and count held bit-equal; the read's
    seconds, the host's peak RSS over it (each file's structure parsed
    from reads of its headers, each leaf mapped on its own and unmapped
    once copied) and the device's peak against the fresh state's; then one
    train step
    from the restored state (its launches the train phase's)."""
    import tempfile

    import torch

    from difashion_tpu_torch.checkpoint import CheckpointStore
    from difashion_tpu_torch.config import ModelConfig, TrainConfig
    from difashion_tpu_torch.engine.train import build_train_step
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn import kernels

    cfg, tc = ModelConfig.sd2_base(), TrainConfig()
    dims = (cfg.mutual.latent_channels, cfg.mutual.latent_size)
    model = create_difashion(cfg, seed=0, device="cuda")
    _, init_state = build_train_step(model, tc)
    state = init_state()
    gen = torch.Generator(device="cuda").manual_seed(21)
    with torch.no_grad():
        for m, v, e in zip(state.opt_state.mu, state.opt_state.nu, state.ema.params):
            m.copy_(torch.randn(m.shape, generator=gen, device="cuda") * 1e-3)
            v.copy_(torch.rand(v.shape, generator=gen, device="cuda") * 1e-5)
            e.add_(torch.randn(e.shape, generator=gen, device="cuda") * 1e-3)
    state.step, state.opt_state.count, state.ema.step = 3, 3, 3
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(tmp)
        t0 = time.perf_counter()
        store.save_jax_layout(state, 3, tc, dims)
        write_s = time.perf_counter() - t0
        ckpt_bytes = dir_bytes(store.ckpt_path(3))
        # a fresh model and state on the card, as a resumed train command has
        model2 = create_difashion(cfg, seed=1, device="cuda")
        step_fn, init2 = build_train_step(model2, tc)
        fresh = init2()
        torch.cuda.synchronize()
        fresh_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rss0 = rss_bytes()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            restored = store.load(fresh, mutual_dims=dims)
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
        device_peak = torch.cuda.max_memory_allocated()
    equal = (restored.step == 3 and restored.opt_state.count == 3 and restored.ema.step == 3
             and all(torch.equal(a, b) for g in ("params", "mu", "nu", "ema")
                     for a, b in zip(state_tensors(restored)[g], state_tensors(state)[g])))
    del state, model, init_state
    torch.cuda.empty_cache()
    batch, null_latent, null_text = train_inputs(model2, tc, seed=5)
    b = batch()
    kernels.reset_launches()
    restored, metrics = step_fn(restored, b, null_latent, null_text,
                                torch.Generator(device="cuda").manual_seed(3))
    loss = float(metrics["loss"])
    launches = dict(kernels.LAUNCHES)
    want = all_counts(train_launches)
    row = {"phase": "jax_checkpoint", "config": "sd2_base", "recipe": "TrainConfig()",
           "layout": "flax msgpack (difashion_tpu/core/checkpoint.py)",
           "checkpoint_bytes": ckpt_bytes, "write_seconds": write_s, "read_seconds": read_s,
           "bit_equal": equal, "host_rss_before_read_bytes": rss0,
           "host_peak_rss_over_read_bytes": rss.peak - rss0,
           "device_fresh_state_bytes": fresh_bytes, "device_peak_over_read_bytes": device_peak,
           "device_peak_minus_fresh_bytes": device_peak - fresh_bytes,
           "resumed_step": restored.step, "resumed_loss": loss, "launches": launches}
    emit(row)
    del restored, model2, b
    torch.cuda.empty_cache()
    if not (equal and math.isfinite(loss) and launches == want and restored_ok(row)):
        raise AssertionError(f"jax_checkpoint: {row}")


def restored_ok(row):
    """The read kept no second copy: the card's peak within 8 MB of the
    fresh state's (the largest leaf is 118 MB, staged on the host), the
    host's peak RSS over the read under 1 GB (one leaf's map at a time,
    against 14 GB of files: a map of a whole file counts in full on the
    card's host once its pages are cached)."""
    return (row["device_peak_minus_fresh_bytes"] <= 8 << 20
            and row["host_peak_rss_over_read_bytes"] < 1 << 30 and row["resumed_step"] == 4)


def rel_l2_np(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def phase_eval_towers():
    """Every evaluation tower at full width (seeded random weights, fp32) on
    the card, built by `eval/extractors.py::build_extractors`: ViT-H/14 on
    200 images at 224, the text tower on the eval prompts of 50 categories,
    both Inceptions on 64 images resized from 512 to 299, LPIPS on 16 pairs
    at 512 and the compatibility net on 256 outfits. Per tower, on inputs
    already on the card (one batch: the workload), its ms per batch by CUDA
    events, items per second and the peak bytes over the call; and its
    output at 2 rows against the same tower on the CPU in fp32 (relative L2
    <= EVAL_REL_L2_TOL)."""
    import copy

    import numpy as np
    import torch

    from difashion_tpu_torch.data.prompts import eval_prompt
    from difashion_tpu_torch.eval.extractors import _resize_bilinear, build_extractors
    from difashion_tpu_torch.eval.models.open_clip_vit import preprocess_clip_image

    t0 = time.perf_counter()
    X = build_extractors(None, batch_size=256, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated()
    rng = np.random.RandomState(17)
    clip_in = preprocess_clip_image(rng.rand(CLIP_IMAGES, 256, 256, 3).astype(np.float32),
                                    224, "cuda")
    prompts = [eval_prompt(f"category {c}") for c in range(50)]
    ids = torch.as_tensor(np.asarray(X.clip_tokenizer(prompts)), dtype=torch.long).cuda()
    x299 = _resize_bilinear(rng.rand(INCEPTION_IMAGES, 512, 512, 3).astype(np.float32), 299,
                            "cuda") * 2 - 1
    a, b = (torch.rand(LPIPS_PAIRS, 3, 512, 512, device="cuda") * 2 - 1 for _ in range(2))
    outfits = torch.randn(COMPAT_OUTFITS, 4, 1024, device="cuda")
    specs = {"clip_image": (X.clip, "encode_image", (clip_in,)),
             "clip_text": (X.clip, "encode_text", (ids,)),
             "fid_inception": (X.fid_inception, "forward", (x299,)),
             "finetuned_inception": (X.inception, "forward", (x299,)),
             "lpips": (X.lpips_net, "forward", (a, b)),
             "compat": (X.compat, "forward", (outfits,))}
    rows, cpu_towers = [], {}
    for name, (tower, method, inputs) in specs.items():
        fn = lambda: getattr(tower, method)(*inputs)
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = device_ms(fn, reps=5, warmup=1)
            peak = torch.cuda.max_memory_allocated() - base
            out = fn().float()
            got = out[:2].cpu().numpy()
            if id(tower) not in cpu_towers:
                cpu_towers = {id(tower): copy.deepcopy(tower).cpu()}
            cpu = cpu_towers[id(tower)]
            want = getattr(cpu, method)(*(t[:2].cpu() for t in inputs)).float().numpy()
        err = rel_l2_np(got, want)
        row = {"phase": "eval_towers", "tower": name, "dtype": "float32 (TF32 off)",
               "batch": len(inputs[0]), "input_shape": list(inputs[0].shape),
               "ms_per_batch": ms, "items_per_second": len(inputs[0]) / ms * 1e3,
               "peak_bytes_over_call": peak, "out_shape": list(out.shape),
               "finite": bool(torch.isfinite(out).all()), "cpu_fp32_rel_l2_2_rows": err}
        emit(row)
        rows.append(row)
        if not (row["finite"] and err <= EVAL_REL_L2_TOL):
            raise AssertionError(f"eval_towers: {row}")
    emit({"phase": "eval_towers", "build_seconds": build_s, "weights_bytes": weights,
          "params": {k: sum(p.numel() for p in m.parameters()) for k, m in
                     (("open_clip", X.clip), ("clip_image", X.clip.visual),
                      ("fid_inception", X.fid_inception), ("finetuned_inception", X.inception),
                      ("lpips", X.lpips_net), ("compat", X.compat))},
          "random_towers": list(X.random_towers)})
    del X, specs, cpu_towers, clip_in, ids, x299, a, b, outfits
    torch.cuda.empty_cache()
    return rows


def phase_extract_clip(img_dir, names, encode_per_batch):
    """`cli/extract_features.main([... --stage all --device cuda])` at the
    sd2_base widths (VAE stage at 512 px, batch 64; CLIP ViT-H/14 stage,
    batch 200; seeded random weights) over the NATIVE_ITEMS synthetic items
    and a history table: the files' shapes and finiteness, the VAE stage's
    GroupNorm launches (the precompute phase's per batch; no skinny-N launch
    in fp32), the
    CLIP features bit for bit against a direct `Extractors.clip_image_embs`
    over the same images, and seconds per 1000 items by stage, each split
    into the host loader's and the rest (device and transfers), timed by
    wrapping the loaders from outside. Returns the catalog features."""
    import tempfile

    import numpy as np
    import torch

    from difashion_tpu_torch.cli import extract_features as xf
    from difashion_tpu_torch.data import preprocessing
    from difashion_tpu_torch.eval.extractors import build_extractors
    from difashion_tpu_torch.nn import kernels

    timers = {"vae_loader": 0.0, "clip_loader": 0.0}
    real_make, real_load = xf.make_item_loader, preprocessing.load_catalog_image

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            timers[key] += time.perf_counter() - t0
            return out
        return run

    stage_s = {}
    real_vae, real_clip = xf.run_vae_stage, xf.run_clip_stage

    def stage(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage_s[key] = time.perf_counter() - t0
            return out
        return run

    kinds = []

    def make(*a, **k):
        loader = real_make(*a, **k)
        kinds.append(loader.kind)
        return timed("vae_loader", loader)

    rng = np.random.RandomState(19)
    n = len(names)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        cates = {c: f"category {c}" for c in range(1, 51)}
        np.save(os.path.join(data, "id_cate_dict.npy"), np.array(cates, dtype=object))
        for split in ("train", "test"):
            hist = {u: {int(c): [int(i) for i in rng.randint(1, n, rng.randint(1, 6))]
                        for c in rng.randint(1, 51, 4)} for u in range(1, 33)}
            np.save(os.path.join(data, f"{split}_history.npy"), np.array(hist, dtype=object))
        table = {"uids": [1], "oids": [1], "outfits": [[1, 2, 3, 4]], "category": [[1, 2, 3, 4]]}
        np.save(os.path.join(data, "train.npy"), np.array(table, dtype=object))
        paths = os.path.join(tmp, "paths.npy")
        np.save(paths, np.array(names, dtype=object))
        xf.make_item_loader = make
        preprocessing.load_catalog_image = timed("clip_loader", real_load)
        xf.run_vae_stage, xf.run_clip_stage = stage("vae", real_vae), stage("clip", real_clip)
        kernels.reset_launches()
        try:
            xf.main(["--data_path", data, "--img_folder_path", img_dir, "--image_paths_npy",
                     paths, "--stage", "all", "--device", "cuda"])
        finally:
            xf.make_item_loader, preprocessing.load_catalog_image = real_make, real_load
            xf.run_vae_stage, xf.run_clip_stage = real_vae, real_clip
        launches = dict(kernels.LAUNCHES)
        proc = os.path.join(data, "processed")
        feats = np.load(os.path.join(proc, "cnn_features_clip.npy"))
        with np.load(os.path.join(proc, "all_item_moments.npz")) as z:
            moments = {k: z[k] for k in z.files}
        hists = {s: np.load(os.path.join(proc, f"{s}_history_clipembs.npy"),
                            allow_pickle=True).item() for s in ("train", "test")}
        # the same images through a direct call of a tower built the same way
        X = build_extractors(None, batch_size=200, device="cuda")
        load01 = lambda i: (real_load(os.path.join(img_dir, names[i]), size=512) + 1.0) / 2.0
        direct = np.concatenate([X.clip_image_embs(np.stack([load01(i) for i in
                                                             range(s, min(s + 200, n))]))
                                 for s in range(0, n, 200)])
        del X
        torch.cuda.empty_cache()
    batches = -(-n // 64)
    # the precompute phase's GroupNorm launches per batch; no skinny-N one:
    # the command runs the VAE in fp32 (as the JAX command does), and the
    # Dense gate sends only 16-bit products to that kernel (`dense_route`)
    want = all_counts({"group_norm_silu": batches * encode_per_batch})
    hist_ok = all(v.shape == (1024,) and np.isfinite(v).all()
                  for h in hists.values() for by in h.values() for v in by.values())
    row = {"phase": "extract_clip", "config": "sd2_base VAE + ViT-H/14", "items": n,
           "vae_batch": 64, "clip_batch": 200, "vae_item_loader": kinds,
           "clip_item_loader": "PIL training transform at 512 (load_catalog_image)",
           "features_shape": list(feats.shape), "moments_shape": list(moments["mean"].shape),
           "finite": bool(np.isfinite(feats).all() and all(np.isfinite(v).all()
                                                           for v in moments.values())),
           "history_ok": hist_ok, "bit_equal_direct": bool(np.array_equal(feats, direct)),
           "launches": launches, "want_launches": want}
    for key in ("vae", "clip"):
        total, loader = stage_s[key], timers[f"{key}_loader"]
        row[f"{key}_seconds_per_1000_items"] = total / n * 1e3
        row[f"{key}_loader_seconds_per_1000_items"] = loader / n * 1e3
        row[f"{key}_rest_seconds_per_1000_items"] = (total - loader) / n * 1e3
    emit(row)
    if not (row["finite"] and hist_ok and row["bit_equal_direct"] and launches == want
            and feats.shape == (n, 1024) and moments["mean"].shape == (n, 64, 64, 4)):
        raise AssertionError(f"extract_clip: {row}")
    return feats


# ---- slice 13: the evaluation cascades, evaluate / parity, the learning proof ------

PARITY_OUTFITS = 8          # the FITB test table; GOR takes the first batch of 2
PARITY_CATES = {1: "pants", 2: "shoes", 3: "bag", 4: "t-shirt", 5: "earrings"}
PARITY_FITB_BATCH, PARITY_GOR_BATCH = 4, 2   # UNet rows: 16 (the main path's) and 32
# the cascade's CLIP scores against the metric on features taken directly from
# the same towers and images: the same fp32 products at the same batch
PARITY_SCORE_RTOL = 1e-6
CASCADE_METRICS = {
    ("FITB", False): ("fid", "is", "clip_score", "grd_clip_score", "clip_retrieval_acc",
                      "clip_image_score", "lpips", "personal_sim", "compatibility",
                      "grd_compatibility"),
    ("GOR", False): ("fid", "is", "clip_score", "clip_image_score", "lpips", "personal_sim",
                     "compatibility", "grd_compatibility"),
    ("FITB", True): ("retrieval_acc", "clip_score", "clip_image_score", "lpips",
                     "personal_sim", "compatibility"),
    ("GOR", True): ("recall@10", "recall@20", "recall@50", "recall@100", "clip_score",
                    "personal_sim", "compatibility"),
}
TOWER_CALLS = ("fid_features", "inception_probs", "clip_image_embs", "clip_text_embs",
               "lpips", "compat_scores")


def write_parity_dataset(root, n_items, feats, model_cfg):
    """A test split over the synthetic catalog (item i of category 1 + i % 5,
    item 0 unused): a FITB table of PARITY_OUTFITS outfits of 4 categories
    with one blank each, its ground truth, retrieval candidates (the blank's
    item and 4 of its category), the category pools, histories of 3 items per
    (user, category) and their mean CLIP features from `feats` (the
    extract_clip phase's catalog features), and the catalog's VAE moments
    (seeded) at `model_cfg`'s latent shape. Returns {flag: path} for the
    commands."""
    import numpy as np

    from difashion_tpu_torch.data.precompute import save_processed
    from difashion_tpu_torch.eval.drivers import process_history_clip_embs

    rng = np.random.RandomState(23)
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "map"))
    pools = {c: [i for i in range(1, n_items) if 1 + i % 5 == c] for c in PARITY_CATES}
    uids = [1 + i % 4 for i in range(PARITY_OUTFITS)]
    oids = list(range(500, 500 + PARITY_OUTFITS))
    cates = [[1 + (i + j) % 5 for j in range(4)] for i in range(PARITY_OUTFITS)]
    outfits = [[int(rng.choice(pools[c])) for c in cs] for cs in cates]
    fitb = [[0 if j == i % 4 else o[j] for j in range(4)] for i, o in enumerate(outfits)]
    cands = {}
    for u, oid, o, cs, i in zip(uids, oids, outfits, cates, range(PARITY_OUTFITS)):
        pool = [x for x in pools[cs[i % 4]] if x != o[i % 4]]
        cands.setdefault(u, {})[oid] = [o[i % 4]] + [int(x) for x in rng.choice(pool, 4, False)]
    history = {u: {c: [int(x) for x in rng.choice(pools[c], 3, False)] for c in PARITY_CATES}
               for u in range(1, 5)}
    save = lambda name, obj: np.save(os.path.join(data, name), np.array(obj, dtype=object))
    save("fitb_test.npy", {"uids": uids, "oids": oids, "outfits": fitb, "category": cates})
    save("test_grd.npy", {oid: {"outfits": o, "category": cs}
                          for oid, o, cs in zip(oids, outfits, cates)})
    save("fitb_test_retrieval_candidates.npy", cands)
    save(os.path.join("map", "cate_iid_dict.npy"), pools)
    save("test_history.npy", history)
    save("id_cate_dict.npy", PARITY_CATES)
    shape = (n_items, model_cfg.unet.sample_size, model_cfg.unet.sample_size,
             model_cfg.vae.latent_channels)
    save_processed(data, "all_item_moments", mean=rng.randn(*shape).astype(np.float32),
                   logvar=np.full(shape, -8.0, np.float32))
    paths = {"--data_path": data, "--cnn_features_npy": os.path.join(root, "cnn.npy"),
             "--hist_clipembs_npy": os.path.join(root, "hist.npy")}
    np.save(paths["--cnn_features_npy"], feats)
    np.save(paths["--hist_clipembs_npy"],
            np.array(process_history_clip_embs(history, feats), dtype=object))
    return paths


class ParityProbe:
    """Instruments the parity and evaluate commands from outside: each UNet
    forward's launches and batch (`UNet2DCondition.forward` wrapped), the
    seconds of every generate and evaluate call and the device memory held
    when an evaluate starts, the towers each evaluate builds (their method
    calls counted and timed on the instance), and the image loader's calls and
    seconds (`drivers.load_image01`). `restore()` puts the originals back."""

    def __init__(self):
        from difashion_tpu_torch.cli import evaluate, generate
        from difashion_tpu_torch.eval import drivers
        from difashion_tpu_torch.models.unet import UNet2DCondition
        from difashion_tpu_torch.nn import kernels

        import torch

        self.forwards, self.calls = [], []
        self.towers = {k: {"calls": 0, "items": 0, "seconds": 0.0} for k in TOWER_CALLS}
        self.loader = {"calls": 0, "seconds": 0.0}
        self.builds = 0
        self._orig = [(UNet2DCondition, "forward", UNet2DCondition.forward),
                      (generate, "main", generate.main), (evaluate, "main", evaluate.main),
                      (evaluate, "build_extractors", evaluate.build_extractors),
                      (drivers, "load_image01", drivers.load_image01)]
        forward, gen_main, eval_main, build, load = (o[2] for o in self._orig)
        probe = self

        def unet_forward(mod, sample, *args, **kwargs):
            before = dict(kernels.LAUNCHES)
            out = forward(mod, sample, *args, **kwargs)
            probe.forwards.append({"rows": sample.shape[0], "launches": {
                k: kernels.LAUNCHES[k] - before[k] for k in kernels.COUNTERS}})
            return out

        def command(kind, fn):
            def run(argv):
                torch.cuda.synchronize()
                rec = {"command": kind, "argv": list(argv),
                       "allocated_at_entry_bytes": torch.cuda.memory_allocated()}
                t0 = time.perf_counter()
                try:
                    return fn(argv)
                finally:
                    torch.cuda.synchronize()
                    rec["seconds"] = time.perf_counter() - t0
                    probe.calls.append(rec)
            return run

        def timed_method(name, fn):
            def run(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                rec = probe.towers[name]
                rec["calls"] += 1
                rec["items"] += len(args[0])
                rec["seconds"] += time.perf_counter() - t0
                return out
            return run

        def build_extractors(*args, **kwargs):
            X = build(*args, **kwargs)
            for name in TOWER_CALLS:
                setattr(X, name, timed_method(name, getattr(X, name)))
            probe.builds += 1
            return X

        def load_image01(*args, **kwargs):
            t0 = time.perf_counter()
            out = load(*args, **kwargs)
            probe.loader["calls"] += 1
            probe.loader["seconds"] += time.perf_counter() - t0
            return out

        UNet2DCondition.forward = unet_forward
        generate.main = command("generate", gen_main)
        evaluate.main = command("evaluate", eval_main)
        evaluate.build_extractors = build_extractors
        drivers.load_image01 = load_image01

    def snapshot(self):
        """The towers' and the loader's totals so far."""
        return ({k: dict(v) for k, v in self.towers.items()}, dict(self.loader))

    def restore(self):
        for obj, name, fn in self._orig:
            setattr(obj, name, fn)


def unet_kernel_calls(cfg, rows):
    """Launches of one sampler UNet forward at `rows` rows in bf16: every
    attention on the flash forward, every GroupNorm on its kernel, and the
    Dense products that the skinny-N gate routes (`dense_sites`)."""
    import torch

    from difashion_tpu_torch.models.difashion import DiFashion

    with torch.device("meta"):
        unet = DiFashion(cfg).unet
    return all_counts({
        "flash_attention_fwd": sum(c for *_, c in main_path_attention_sites(cfg, rows)),
        "group_norm_silu": count_groupnorms(unet),
        "skinny_matmul": len(dense_sites(cfg, (("unet", "unet", rows),))["unet"])})


def write_parity_checkpoint(cfg, ckpt):
    """The cheapest checkpoint of the port's store that `generate` restores:
    the seeded bf16 sd2_base model's trainable weights (1.7 GB), an empty
    optimizer state, no EMA (the restore seeds it from the weights) and no
    frozen towers (the seeded VAE and text encoder are the model's own)."""
    import torch

    from difashion_tpu_torch.checkpoint import CheckpointStore
    from difashion_tpu_torch.engine.train import AdamState, TrainState
    from difashion_tpu_torch.models.difashion import create_difashion

    model = create_difashion(cfg.model, seed=cfg.train.seed, device="cuda",
                             dtype=torch.bfloat16)
    named = model.trainable_parameters()
    state = TrainState(names=[n for n, _ in named], params=[p for _, p in named],
                       opt_state=AdamState(0, [], []), ema=None, step=0)
    CheckpointStore(ckpt).save(state, 0)
    del model, state, named
    torch.cuda.empty_cache()


def phase_evaluate_parity(img_dir, names, feats, main_fwd):
    """The evaluate and parity commands at the sd2_base widths with the
    full-size towers (ViT-H/14, both InceptionV3s at 299, LPIPS-VGG16 at
    512, compat; seeded random weights), through the dispatcher
    (`__main__.main`, in this process, so that the probe can count), on a
    test split over the synthetic 512 px catalog (`write_parity_dataset`,
    with the extract_clip phase's catalog features `feats`) and a checkpoint
    of the seeded sd2_base model (`write_parity_checkpoint`):

      1. `parity --grounding --allow_random_weights --device cuda` for FITB
         (8 outfits, 2 batches of 4: 16 UNet rows, the main path's batch),
         then for GOR (`--max_batches 1`: 2 outfits, 32 rows), 50-step PNDM
         with the recipe's CFG: generate, the cascade, the grounding cascade;
      2. `evaluate` and `evaluate --grounding` again over both runs;
      3. `parity` with the FITB run's own results as `--reference_results`,
         then with its FID scaled by 1.05.

    Checks: every metric of the four cascades present and finite; the
    evaluates of step 2 build their towers and call none of them, nor the
    image loader; the FITB cascade's clip_score and clip_image_score equal the
    metric functions on features taken directly from `Extractors` (the same
    seeded towers, rebuilt) on the same images, within PARITY_SCORE_RTOL;
    step 3 passes at 0 % and then exits non-zero; every UNet forward of the
    generate legs launches what `unet_kernel_calls` gives for its rows, and
    at 16 rows the main path's per forward (`main_fwd`); the device holds no
    more than 256 MB over the phase's start when the first evaluate of a leg
    starts (the UNet freed). Prints per leg the generate seconds, the
    evaluate seconds per generated image split into the image loader, each
    tower and the rest (the cascades' metric math, the grids, I/O), the
    phase's peak device memory and the host's resident set before and after.
    Returns the launches of the generate legs' UNet forwards."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from difashion_tpu_torch.__main__ import main as dispatch
    from difashion_tpu_torch.config import Config
    from difashion_tpu_torch.data.prompts import eval_prompt
    from difashion_tpu_torch.eval import drivers
    from difashion_tpu_torch.eval.extractors import build_extractors
    from difashion_tpu_torch.eval.metrics import clip_image_score, clip_score

    cfg = Config.preset_eta01()
    cfg = dataclasses.replace(cfg, generation=dataclasses.replace(
        cfg.generation, fitb_batch_size=PARITY_FITB_BATCH, gor_batch_size=PARITY_GOR_BATCH))
    want_fwd = {"FITB": unet_kernel_calls(cfg.model, 4 * PARITY_FITB_BATCH),
                "GOR": unet_kernel_calls(cfg.model, 4 * 4 * PARITY_GOR_BATCH)}
    root = tempfile.mkdtemp(prefix="difashion_parity_")
    rss0 = rss_bytes()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    probe = None
    try:
        flags = write_parity_dataset(root, len(names), feats, cfg.model)
        paths_npy = os.path.join(root, "paths.npy")
        np.save(paths_npy, np.array(names, dtype=object))
        cfg_path, ckpt, out = (os.path.join(root, n) for n in ("config.json", "ckpt", "out"))
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        t0 = time.perf_counter()
        write_parity_checkpoint(cfg, ckpt)
        ckpt_s = time.perf_counter() - t0
        common = [*(x for kv in flags.items() for x in kv), "--img_folder_path", img_dir,
                  "--image_paths_npy", paths_npy, "--weights_dir", os.path.join(root, "none"),
                  "--mode", "test", "--device", "cuda", "--allow_random_weights"]
        parity = common + ["--ckpt_dir", ckpt, "--out_dir", out, "--config", cfg_path]

        # 1) parity for FITB and GOR, with the grounding cascades
        probe = ParityProbe()
        legs = {}
        for task, extra in (("FITB", []), ("GOR", ["--max_batches", "1"])):
            first_call, first_fwd = len(probe.calls), len(probe.forwards)
            towers0, loader0 = probe.snapshot()
            if dispatch(["parity", *parity, "--task", task, "--grounding", *extra]) != 0:
                raise AssertionError(f"evaluate_parity: parity {task} returned non-zero")
            towers1, loader1 = probe.snapshot()
            legs[task] = {"calls": probe.calls[first_call:],
                          "forwards": probe.forwards[first_fwd:],
                          "towers": {k: {f: towers1[k][f] - towers0[k][f] for f in v}
                                     for k, v in towers0.items()},
                          "loader": {f: loader1[f] - loader0[f] for f in loader0}}
        results = np.load(os.path.join(out, "eval_results.npy"), allow_pickle=True).item()
        grounding = np.load(os.path.join(out, "eval_results_grounding.npy"),
                            allow_pickle=True).item()
        runs = {task: next(r for r in results if r.startswith(task + "-")) for task in legs}
        manifests = {task: np.load(os.path.join(out, run + ".npy"), allow_pickle=True).item()
                     for task, run in runs.items()}

        # 2) evaluate again: every metric is in the files already
        towers0, loader0 = probe.snapshot()
        builds0 = probe.builds
        for task in legs:
            for g in ([], ["--grounding"]):
                dispatch(["evaluate", *common, "--gen_dir", out, "--task", task, *g])
        towers1, loader1 = probe.snapshot()
        cached = {"builds": probe.builds - builds0,
                  "tower_calls": sum(towers1[k]["calls"] - towers0[k]["calls"] for k in towers0),
                  "loader_calls": loader1["calls"] - loader0["calls"]}
        probe.restore()
        probe = None

        # the FITB cascade's CLIP scores against features taken directly
        X = build_extractors(None, batch_size=32, device="cuda")
        grd = np.load(os.path.join(flags["--data_path"], "test_grd.npy"),
                      allow_pickle=True).item()
        _, oids, cates, _, gen_paths = drivers._flatten_fitb_manifest(manifests["FITB"])
        gen = np.stack([drivers.load_image01(p, 512) for p in gen_paths])
        real = np.stack([drivers.load_image01(os.path.join(img_dir, names[i]), 512)
                         for i in drivers._grd_item_iids(grd, oids, cates)])
        gen_emb, grd_emb = X.clip_image_embs(gen), X.clip_image_embs(real)
        txt = X.clip_text_embs([eval_prompt(PARITY_CATES[c]) for c in cates])
        direct = {"clip_score": clip_score(gen_emb, txt),
                  "clip_image_score": clip_image_score(gen_emb, grd_emb)}
        del X, gen, real
        torch.cuda.empty_cache()

        # 3) the run's own numbers as the reference, then its FID 5 % off
        ref_ok, ref_bad = (os.path.join(root, n) for n in ("ref_ok.npy", "ref_bad.json"))
        fitb_res = results[runs["FITB"]]
        np.save(ref_ok, np.array({runs["FITB"]: fitb_res}, dtype=object))
        with open(ref_bad, "w") as f:
            json.dump({"fid": fitb_res["fid"] * 1.05, "lpips": fitb_res["lpips"]}, f)
        ref_pass = dispatch(["parity", *parity, "--task", "FITB", "--reference_results", ref_ok])
        with open(os.path.join(out, "parity_table.json")) as f:
            table_ok = json.load(f)
        refused = None
        try:
            dispatch(["parity", *parity, "--task", "FITB", "--reference_results", ref_bad])
        except SystemExit as e:   # the refusal this step is for
            refused = str(e)
        with open(os.path.join(out, "parity_table.json")) as f:
            table_bad = json.load(f)
        peak = torch.cuda.max_memory_allocated()
    finally:
        if probe is not None:
            probe.restore()
        shutil.rmtree(root, ignore_errors=True)

    def finite(v):
        return all(map(math.isfinite, v.values())) if isinstance(v, dict) else math.isfinite(v)

    missing = {}
    for (task, g), metrics in CASCADE_METRICS.items():
        res = (grounding if g else results)[runs[task]]
        missing[task + (" grounding" if g else "")] = [
            m for m in metrics if m not in res or not finite(res[m])]
    row = {"phase": "evaluate_parity", "config": "sd2_base + full-size eval towers (fp32)",
           "recipe": "Config.preset_eta01(): 50-step PNDM, CFG 12 / 4 / 5",
           "checkpoint_write_seconds": ckpt_s, "peak_memory_bytes": peak, "cached": cached,
           "host_rss_start_bytes": rss0, "host_rss_end_bytes": rss_bytes(),
           "direct_clip": direct, "results": {t: results[r] for t, r in runs.items()},
           "grounding": {t: grounding[r] for t, r in runs.items()},
           "reference_pass_rc": ref_pass, "reference_pass_ok": table_ok["ok"],
           "fid_delta_pct": {r["metric"]: r["delta_pct"] for r in table_ok["rows"]}.get("fid"),
           "refused": refused, "refused_table_ok": table_bad["ok"],
           "main_path_per_forward": main_fwd}
    problems = [f"{k}: missing or non-finite {v}" for k, v in missing.items() if v]
    for task, leg in legs.items():
        gen_calls = [c for c in leg["calls"] if c["command"] == "generate"]
        eval_calls = [c for c in leg["calls"] if c["command"] == "evaluate"]
        n = sum(len(rec["image_paths"]) for by in manifests[task].values()
                for rec in by.values())
        eval_s = sum(c["seconds"] for c in eval_calls)
        tower_s = sum(v["seconds"] for v in leg["towers"].values())
        bad_fwd = [f for f in leg["forwards"] if f["launches"] != want_fwd[task]]
        row[task] = {
            "images": n, "generate_seconds": sum(c["seconds"] for c in gen_calls),
            "unet_forwards": len(leg["forwards"]),
            "unet_rows": sorted({f["rows"] for f in leg["forwards"]}),
            "launches_per_forward": want_fwd[task], "forwards_off_expected": len(bad_fwd),
            "allocated_at_first_evaluate_bytes": eval_calls[0]["allocated_at_entry_bytes"] - base,
            "evaluate_seconds": eval_s, "evaluate_seconds_per_image": eval_s / n,
            "loader_seconds_per_image": leg["loader"]["seconds"] / n,
            "tower_seconds_per_image": {k: v["seconds"] / n for k, v in leg["towers"].items()},
            "rest_seconds_per_image": (eval_s - leg["loader"]["seconds"] - tower_s) / n,
            "loader": leg["loader"], "towers": leg["towers"]}
        if bad_fwd or not leg["forwards"]:
            problems.append(f"{task}: {len(bad_fwd)} of {len(leg['forwards'])} UNet forwards "
                            f"off {want_fwd[task]}: {bad_fwd[:2]}")
        if row[task]["allocated_at_first_evaluate_bytes"] > 256 << 20:
            problems.append(f"{task}: {row[task]['allocated_at_first_evaluate_bytes']} bytes "
                            "held when evaluate started")
    if want_fwd["FITB"] != main_fwd:
        problems.append(f"FITB per forward {want_fwd['FITB']} != the main path's {main_fwd}")
    if cached != {"builds": 4, "tower_calls": 0, "loader_calls": 0}:
        problems.append(f"cached evaluates: {cached}")
    for k, v in direct.items():
        if abs(v - results[runs["FITB"]][k]) > PARITY_SCORE_RTOL * abs(v):
            problems.append(f"{k}: cascade {results[runs['FITB']][k]} vs direct {v}")
    if not (ref_pass == 0 and table_ok["ok"] and row["fid_delta_pct"] == 0.0):
        problems.append(f"parity against its own results: rc {ref_pass}, table {table_ok}")
    if refused is None or "parity FAILED" not in refused or table_bad["ok"]:
        problems.append(f"parity with FID x 1.05 was not refused: {refused}")
    emit(row)
    if problems:
        raise AssertionError("evaluate_parity: " + "; ".join(problems))
    return {k: sum(f["launches"][k] for leg in legs.values() for f in leg["forwards"])
            for k in want_fwd["FITB"]}


LEARNING_PROOF_STEPS = 100   # two legs of 50: the plumbing, not the gates


def phase_learning_proof():
    """`scripts/learning_proof_cuda.py --steps 100` (its `main`, in this
    process) at the mid config on the card: train 50 steps, resume from
    checkpoint-50 to 100, generate FITB and GOR with the EMA and the raw
    weights (50-step PNDM, 4-branch CFG), the reconstruction gates, the
    report (into a temporary file). Checks the plumbing, not the gates:
    both legs ran and the second started at step 50; checkpoints 50 and 100;
    the four runs wrote their manifests and JPEGs; the report was written;
    every train step launched the same kernels, the flash forward, dQ,
    dK/dV and GroupNorm among them; every sampler UNet forward of a task the
    same, the flash forward and GroupNorm among them; the losses finite.
    Prints seconds per train step and the report's launches. Returns the
    launches of one train step and one sampler forward of each task."""
    import importlib.util
    import tempfile as tf

    spec = importlib.util.spec_from_file_location(
        "learning_proof_cuda", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                            "scripts", "learning_proof_cuda.py"))
    lp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lp)
    with tf.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "report.json")
        rc = lp.main(["--steps", str(LEARNING_PROOF_STEPS), "--device", "cuda",
                      "--report", path])
        with open(path) as f:
            r = json.load(f)
    half = LEARNING_PROOF_STEPS // 2
    launches = r["preset"]["launches"]
    train, fwd = launches["per_train_step"], launches["per_sampler_unet_forward"]
    row = {"phase": "learning_proof", "config": "mid (tools/learning_proof_tpu.py)",
           "steps": LEARNING_PROOF_STEPS, "rc": rc, "legs": r["legs"],
           "checkpoints": r["checkpoints"], "runs": r["runs"], "launches": launches,
           "train_wall_s": r["train_wall_s"], "generate_wall_s": r["generate_wall_s"],
           "train_seconds_per_step": r["train_wall_s"] / LEARNING_PROOF_STEPS,
           "losses": r["losses"], "loss_first": r["loss_first"], "loss_last": r["loss_last"],
           "gates": {t: {v: r[t]["variants"][v]["n_correct"] for v in ("ema", "raw")}
                     for t in ("FITB", "GOR")}, "all_gates_passed": r["all_gates_passed"],
           "preset": {k: v for k, v in r["preset"].items() if k != "launches"}}
    emit(row)
    problems = []
    if r["legs"] != [{"first_step": 0, "steps": half, "end_step": half},
                     {"first_step": half, "steps": half, "end_step": 2 * half}]:
        problems.append(f"legs {r['legs']}")
    if r["checkpoints"] != [half, 2 * half]:
        problems.append(f"checkpoints {r['checkpoints']}")
    if set(r["runs"]) != {"FITB_ema", "FITB_raw", "GOR_ema", "GOR_raw"} or not all(
            v["jpegs_exist"] and v["images"] == (4 if k.startswith("FITB") else 16)
            for k, v in r["runs"].items()):
        problems.append(f"runs {r['runs']}")
    if len(train) != 1 or not all(train[0][k] > 0 for k in (
            "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
            "group_norm_silu")) or launches["train_steps"] != LEARNING_PROOF_STEPS:
        problems.append(f"train step launches {train} over {launches['train_steps']} steps")
    for task, per in fwd.items():
        if len(per) != 1 or not (per[0]["flash_attention_fwd"] > 0
                                 and per[0]["group_norm_silu"] > 0):
            problems.append(f"{task} sampler forward launches {per}")
    if not r["losses_finite"] or not r["losses"]:
        problems.append(f"losses {r['losses']}")
    if rc != (0 if r["all_gates_passed"] else 1):
        problems.append(f"exit code {rc} for all_gates_passed={r['all_gates_passed']}")
    if problems:
        raise AssertionError("learning_proof: " + "; ".join(problems))
    return {"train_step": train[0], **{f"{t}_sampler_forward": per[0] for t, per in fwd.items()}}


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
            f"{prefix}host_us", f"{prefix}simt_bound_ms", f"{prefix}simt_share", "dkv_splits")
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
            "share_of_bound": main["bound_ms"] / main["ms"],
            "host_us_per_call": statistics.median(r["host_us"] for r in gn_results
                                                  if "host_us" in r),
            "plans": sorted({(tuple(r["shape"]), r["dtype"], r["route"], r["k"],
                              r.get("cluster", r.get("chunks"))) for r in gn_results}),
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
                 f32_results, sd15_f32_results, bwd_f32_results, f32_launches,
                 bwd_sd15_results, train_fp32, parity_launches, proof_launches):
    """The forward's numbers are per sampler UNet forward (batch 16) and its
    launches the main path's; the backward kernels' numbers are per train
    step (batch 8, one backward per attention) and their launches one train
    step's; the fp32 kernels' numbers are per sampler UNet forward and per
    train step in fp32 and their launches the fp32 tiny path's (generation
    and a training step: `phase_fp32_reference`), each with its SIMT bound
    beside, the forward's also per sd15 UNet forward in fp32 (d = 40 and
    80), the backward's with the full-width fp32 step's numbers
    (`phase_train_fp32`); the GroupNorm kernel's as `gn_entry` says, the
    skinny-N kernel's as `mm_entry` says. Each entry also carries its
    launches in the parity phase's generate legs (their UNet forwards) and in
    one train step and one sampler forward of the learning proof."""
    fwd_rows = [dict(r, ms=r["kernel_ms"]) for r in results]
    sd15_rows = [dict(r, ms=r["kernel_ms"]) for r in sd15_results]
    f32_rows = [dict(r, ms=r["kernel_ms"]) for r in f32_results]
    sd15_f32_rows = [dict(r, ms=r["kernel_ms"]) for r in sd15_f32_results]
    library = ("F.scaled_dot_product_attention's backward, computing dQ, dK and dV "
               "together: the same number on both backward entries")
    pallas = "difashion_tpu/nn/pallas/flash_attention.py:"
    f32_source = "difashion_tpu_torch/csrc/flash_attention_f32.cu"
    f32_simt = lambda prefix: sum(r[f"{prefix}simt_bound_ms"] * r["calls_per_train_step"]
                                  for r in bwd_f32_results)
    sd15 = kernel_entry("flash_attention_fwd", sd15_rows, "calls_per_unet_forward", "",
                        "one sd15 UNet forward, d <= 128", 0, replaces=pallas + "50")
    sd15_f32 = kernel_entry("flash_attention_fwd_f32", sd15_f32_rows, "calls_per_unet_forward",
                            "", "one sd15 UNet forward in fp32, d <= 128", 0,
                            replaces=pallas + "50")
    fwd_simt = lambda rows: sum(r["simt_bound_ms"] * r["calls_per_unet_forward"] for r in rows)

    def sd15_bwd(prefix, line):
        e = kernel_entry("flash_attention_" + prefix[:-1], bwd_sd15_results,
                         "calls_per_train_step", prefix, "one sd15 train step, d <= 128", 0,
                         replaces=pallas + line)
        return {k: e[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "share_of_bound",
                                  "per", "shapes")}

    entries = [
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
                     source=f32_source, main_path_launches=launches["flash_attention_fwd_f32"],
                     simt_bound_ms=fwd_simt(f32_rows), train_fp32=train_fp32,
                     sd15_per_unet_forward=dict(
                         {k: sd15_f32[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                   "share_of_bound", "max_abs_err", "per",
                                                   "shapes")},
                         simt_bound_ms=fwd_simt(sd15_f32_rows))),
        kernel_entry("flash_attention_dq_f32", bwd_f32_results, "calls_per_train_step", "dq_",
                     "one train step in fp32", f32_launches["flash_attention_dq_f32"],
                     replaces=pallas + "145", library=library, source=f32_source,
                     main_path_launches=launches["flash_attention_dq_f32"],
                     simt_bound_ms=f32_simt("dq_"), train_fp32=train_fp32),
        kernel_entry("flash_attention_dkv_f32", bwd_f32_results, "calls_per_train_step", "dkv_",
                     "one train step in fp32", f32_launches["flash_attention_dkv_f32"],
                     replaces=pallas + "191", library=library, source=f32_source,
                     main_path_launches=launches["flash_attention_dkv_f32"],
                     simt_bound_ms=f32_simt("dkv_"), train_fp32=train_fp32),
        gn_entry(gn_results, launches, train_launches, precompute_launches),
        mm_entry(mm_results, mm_host, launches, train_launches, precompute_launches,
                 serve_launches),
    ]
    for e in entries:
        e["parity_generate_unet_launches"] = parity_launches[e["name"]]
        e["learning_proof_launches"] = {k: v[e["name"]] for k, v in proof_launches.items()}
    return {"kernels": entries}


def main():
    import tempfile

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
    results, sd15_results, f32_results, sd15_f32_results = phase_kernel(sites, sd15_sites)
    phase_sd15_unet()
    gn_results = phase_kernel_gn(groupnorm_sites(cfg))
    mm_paths = dense_sites(cfg)
    mm_results, mm_host = phase_kernel_mm(mm_paths)
    phase_reference()
    model = create_difashion(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    phase_unet(model, mm_paths)
    launches = phase_main_path(model, mm_paths)
    # one sampler UNet forward's launches on the main path (batch 16)
    main_fwd = all_counts({
        "flash_attention_fwd": launches["flash_attention_fwd"] // (STEPS + 1),
        "group_norm_silu": (launches["group_norm_silu"]
                            - count_groupnorms(model.vae.decoder)) // (STEPS + 1),
        "skinny_matmul": (launches["skinny_matmul"]
                          - len(mm_paths["vae_decode"])) // (STEPS + 1)})
    phase_profile(model)
    serve_launches = phase_serve(model, mm_paths)
    precompute_launches = phase_precompute(model, mm_paths)
    encode_gn = count_groupnorms(model.vae.encoder)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as catalog:
        names = write_synthetic_catalog(catalog, NATIVE_ITEMS)
        phase_native_loader(catalog, names)
        phase_eval_towers()
        feats = phase_extract_clip(catalog, names, encode_gn)
        parity_launches = phase_evaluate_parity(catalog, names, feats, main_fwd)
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
    train_launches, train_peak, train_seconds = phase_train(model, mm_paths)
    phase_profile_train(model)
    train_fp32 = phase_train_fp32(model)
    del model
    torch.cuda.empty_cache()
    live_state_bytes = phase_train_cli(train_launches, train_seconds)
    phase_info(live_state_bytes, train_peak)
    phase_jax_checkpoint(train_launches)
    proof_launches = phase_learning_proof()
    emit(kernels_line(results, launches, bwd_results, train_launches, gn_results,
                      precompute_launches, mm_results, mm_host, serve_launches, sd15_results,
                      f32_results, sd15_f32_results, bwd_f32_results, f32_launches,
                      bwd_sd15_results, train_fp32, parity_launches, proof_launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

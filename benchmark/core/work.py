"""The work of a forward, counted from shapes: each attention, GroupNorm and
linear product the towers compute, the operations of the whole forward, and
the roofline bound of each kernel's share of it.

The towers are the reference's (`reference/models.py`), run on the meta
device: nothing is computed, hooks record the shapes, and PyTorch's
`FlopCounterMode` counts the operations of every matrix product and
convolution. The bound and operation formulas are frozen copies of the
program's measuring script (`chip_smoke.py`: `attention_bound`,
`backward_bound`, `matmul_bound`, the GroupNorm byte count), and the rules
by which the program sends a call to its kernels are frozen here too
(`FLASH_MAX_D`, `skinny_gate`): a reader holds them against the program's
launch counters and reports nothing where they disagree.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import models as ref

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

FLASH_MAX_D = 128     # sdpa sends d <= 128 to the flash kernels, larger d plain


def skinny_gate(rows: int, n: int, k: int, size: int = 2) -> bool:
    """The Dense route to the skinny-N kernel in a 16-bit compute dtype:
    N <= 1280, the weight at most 8 MiB, M >= 2048 and M % 512 == 0."""
    return n <= 1280 and n * k * size <= 8 * 1024 * 1024 and rows >= 2048 and rows % 512 == 0


def attention_bound_s(b, h, sq, skv, d, size=2) -> float:
    """Forward: two products of 2*Sq*Skv*d per (batch, head) at the bf16
    rate, or q, k, v read and o written once plus the fp32 LSE."""
    ops = 4.0 * b * h * sq * skv * d
    nbytes = size * b * h * d * (2 * sq + 2 * skv) + 4.0 * b * h * sq
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def backward_bound_s(kind, b, h, sq, skv, d, size=2) -> float:
    """dQ (3 products) or dK/dV (4 products); q, k, v, dO read once, the LSE
    and D in fp32, the kernel's gradients written once."""
    ops = 2.0 * (3 if kind == "dq" else 4) * b * h * sq * skv * d
    written = sq if kind == "dq" else 2 * skv
    nbytes = size * b * h * d * (2 * sq + 2 * skv + written) + 8.0 * b * h * sq
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def matmul_bound_s(m, k, n, bias=False, size=2) -> float:
    ops = 2.0 * m * k * n + (m * n if bias else 0)
    nbytes = size * (m * k + k * n + m * n + (n if bias else 0))
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def groupnorm_bound_s(shape, size=2) -> float:
    """x read once, y written once, scale and bias read once (fp32)."""
    return (2 * math.prod(shape) * size + 2 * shape[1] * 4) / PEAK_HBM_BYTES


@dataclass
class Work:
    """One forward's calls: attention (B, H, Sq, Skv, D), GroupNorm input
    shapes, linear products (M, K, N, bias); `flops` its matmul and
    convolution operations."""

    attention: List[Tuple[int, int, int, int, int]] = field(default_factory=list)
    groupnorm: List[Tuple[int, ...]] = field(default_factory=list)
    dense: List[Tuple[int, int, int, bool]] = field(default_factory=list)
    flops: float = 0.0

    def flash(self):
        return [a for a in self.attention if a[4] <= FLASH_MAX_D]

    def skinny(self, size=2):
        return [d for d in self.dense if skinny_gate(d[0], d[2], d[1], size)]

    def flash_fwd_bound_s(self) -> float:
        return sum(attention_bound_s(*a) for a in self.flash())

    def flash_bwd_bound_s(self) -> float:
        return sum(backward_bound_s(k, *a) for a in self.flash() for k in ("dq", "dkv"))

    def groupnorm_bound_s(self) -> float:
        return sum(groupnorm_bound_s(s) for s in self.groupnorm)

    def skinny_bound_s(self) -> float:
        return sum(matmul_bound_s(*d) for d in self.skinny())


def _record(tower: torch.nn.Module, work: Work):
    def on_attention(mod, args, out):
        x = args[0]
        if isinstance(mod, ref.CrossAttention):
            ctx = args[1] if len(args) > 1 and args[1] is not None else x
            work.attention.append((x.shape[0], mod.heads, x.shape[1], ctx.shape[1],
                                   mod.head_dim))
        else:   # the VAE's single-head spatial attention
            s = x.shape[2] * x.shape[3]
            work.attention.append((x.shape[0], 1, s, s, x.shape[1]))

    def on_norm(mod, args, out):
        work.groupnorm.append(tuple(args[0].shape))

    def on_linear(mod, args, out):
        work.dense.append((math.prod(args[0].shape[:-1]), mod.in_features,
                           mod.out_features, mod.bias is not None))

    hooks = []
    for m in tower.modules():
        if isinstance(m, (ref.CrossAttention, ref.VAEAttention)):
            hooks.append(m.register_forward_hook(on_attention))
        elif isinstance(m, ref.GroupNorm):
            hooks.append(m.register_forward_hook(on_norm))
        elif isinstance(m, ref.Linear):
            hooks.append(m.register_forward_hook(on_linear))
    return hooks


def _count(tower, fn) -> Work:
    work = Work()
    hooks = _record(tower, work)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn()
    for h in hooks:
        h.remove()
    work.flops = float(fc.get_total_flops())
    return work


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


def unet_work(model_cfg: dict, rows: int) -> Work:
    u = model_cfg["unet"]
    unet = ref.build_tower("unet", model_cfg)
    s = u["sample_size"]
    return _count(unet, lambda: unet(meta(rows, u["in_channels"], s, s),
                                     meta(rows, dtype=torch.long),
                                     meta(rows, 77, u["cross_attention_dim"])))


def decode_work(model_cfg: dict, images: int) -> Work:
    vae = ref.build_tower("vae", model_cfg)
    s = model_cfg["unet"]["sample_size"]
    return _count(vae, lambda: vae.decode(meta(images, model_cfg["vae"]["latent_channels"], s, s)))


def text_work(model_cfg: dict, rows: int) -> Work:
    text = ref.build_tower("text_encoder", model_cfg)
    return _count(text, lambda: text(meta(rows, 77, dtype=torch.long)))


def mutual_work(model_cfg: dict, rows: int) -> Work:
    m = model_cfg["mutual"]
    mutual = ref.build_tower("fashion_encoder", model_cfg)
    return _count(mutual, lambda: mutual(meta(rows, m["latent_channels"], m["latent_size"],
                                              m["latent_size"])))

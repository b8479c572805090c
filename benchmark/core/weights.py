"""Seeded weights of the four towers, made on the device in HF layout.

The rule is a frozen copy of the program's seeded initialisation: linear and
convolution weights lecun-normal (std 1 / sqrt(fan_in)) with zero biases,
the MutualEncoder's linears xavier-normal (std sqrt(2 / (fan_in +
fan_out))), norms at unit scale and zero shift, embeddings N(0, 1); in the
UNet, the VAE and the text tower the layers whose output is added to a
residual stream are scaled by 1 / sqrt(their number), so that a random
network at full depth stays tame.

Each tower is drawn in one call: one N(0, 1) buffer from a generator on the
device, cut into the tensors of its state dict (views), each scaled by its
std in one foreach call, and cast to the dtype the cell serves in. The keys
and shapes are the reference's (`reference/models.py`), which are the
diffusers / transformers names the program loads. The same seed gives the
same tensors on the same device, so the reference makes its own copy after
the program's run.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from benchmark.reference.models import TOWERS, build_tower, residual_outputs

TOWER_SALT = {"unet": 1, "vae": 2, "text_encoder": 3, "fashion_encoder": 4}


def _leaf_std(module: nn.Module, pname: str, mutual: bool, residual: float) -> float:
    """The std of a drawn parameter, or 0 for a zero one, -1 for a one."""
    if isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
        return -1.0 if pname == "weight" else 0.0
    if isinstance(module, nn.Embedding):
        return 1.0
    if pname == "bias":
        return 0.0
    w = module.weight
    fan_in = w[0].numel()
    if mutual:
        return math.sqrt(2.0 / (fan_in + w.shape[0]))
    return residual / math.sqrt(fan_in)


def make_tower(name: str, model_cfg: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """{HF key: tensor} of one tower (a key of TOWERS) on `device` in `dtype`."""
    tower = build_tower(name, model_cfg)
    res = set(residual_outputs(tower)) if name != "fashion_encoder" else set()
    res_scale = 1.0 / math.sqrt(len(res)) if res else 1.0
    leaves = []
    for mname, module in tower.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            std = _leaf_std(module, pname, name == "fashion_encoder",
                            res_scale if mname in res else 1.0)
            leaves.append((f"{mname}.{pname}" if mname else pname, tuple(p.shape), std))
    total = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + TOWER_SALT[name]) % (2 ** 63 - 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    views, off = {}, 0
    for key, shape, _ in leaves:
        n = math.prod(shape)
        views[key] = flat[off:off + n].view(shape)
        off += n
    drawn = [(views[k], std) for k, _, std in leaves if std > 0]
    torch._foreach_mul_([v for v, _ in drawn], [s for _, s in drawn])
    for key, _, std in leaves:
        if std == 0.0:
            views[key].zero_()
        elif std < 0:
            views[key].fill_(1.0)
    if dtype != torch.float32:
        flat = flat.to(dtype)
        off, out = 0, {}
        for key, shape, _ in leaves:
            n = math.prod(shape)
            out[key] = flat[off:off + n].view(shape)
            off += n
        return out
    return views


def make_weights(model_cfg: dict, seed: int, device, dtype,
                 towers=tuple(TOWERS)) -> Dict[str, Dict[str, torch.Tensor]]:
    return {name: make_tower(name, model_cfg, seed, device, dtype) for name in towers}


def reference_towers(model_cfg: dict, seed: int, device, dtype, prec=None,
                     towers=tuple(TOWERS)) -> Dict[str, nn.Module]:
    """The reference's towers in fp32 (or the control's `prec`) holding the
    weights of `seed` as drawn in `dtype`, the cell's serving type (its
    rounding is part of the weights both sides get), in eval mode and
    frozen: a caller that trains one turns its gradient on."""
    from benchmark.reference.precision import FP32

    out = {}
    for name in towers:
        sd = {k: v.float().clone() if dtype != torch.float32 else v
              for k, v in make_tower(name, model_cfg, seed, device, dtype).items()}
        tower = build_tower(name, model_cfg, prec or FP32)
        tower.load_state_dict(sd, strict=True, assign=True)
        out[name] = tower.eval().requires_grad_(False)
    return out

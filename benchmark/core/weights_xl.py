"""Seeded weights of the SDXL cells' five towers, made on the device in HF
layout: `core/weights.py`'s rule and draw (one N(0, 1) buffer per tower
from a generator on the device, each tensor scaled by its std, the layers
added to a residual stream scaled by 1 / sqrt(their number), cast to the
cell's dtype), over the towers of `reference/sdxl.py`: the SDXL UNet with
its `add_embedding`, the VAE, both text towers (`text_encoder_2` with its
`text_projection`) and the MutualEncoder.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from benchmark.core.weights import TOWER_SALT, _leaf_std
from benchmark.reference.sdxl import TOWERS, build_tower, residual_outputs

SALT = dict(TOWER_SALT, text_encoder_2=6)


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
    gen = torch.Generator(device=device).manual_seed((int(seed) * 8 + SALT[name]) % (2 ** 63 - 1))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in leaves), generator=gen, device=device,
                       dtype=torch.float32)

    def cut(buf):
        out, off = {}, 0
        for key, shape, _ in leaves:
            out[key] = buf[off:off + math.prod(shape)].view(shape)
            off += math.prod(shape)
        return out

    views = cut(flat)
    drawn = [(views[k], std) for k, _, std in leaves if std > 0]
    torch._foreach_mul_([v for v, _ in drawn], [s for _, s in drawn])
    for key, _, std in leaves:
        if std == 0.0:
            views[key].zero_()
        elif std < 0:
            views[key].fill_(1.0)
    return views if dtype == torch.float32 else cut(flat.to(dtype))


def make_weights(model_cfg: dict, seed: int, device, dtype,
                 towers=tuple(TOWERS)) -> Dict[str, Dict[str, torch.Tensor]]:
    return {name: make_tower(name, model_cfg, seed, device, dtype) for name in towers}


def reference_towers(model_cfg: dict, seed: int, device, dtype, prec=None,
                     towers=tuple(TOWERS)) -> Dict[str, nn.Module]:
    """The reference's towers in fp32 (or the control's `prec`) holding the
    weights of `seed` as drawn in `dtype`, in eval mode and frozen, as
    `core/weights.py::reference_towers` makes the SD cells'."""
    from benchmark.reference.precision import FP32

    out = {}
    for name in towers:
        sd = {k: v.float().clone() if dtype != torch.float32 else v
              for k, v in make_tower(name, model_cfg, seed, device, dtype).items()}
        tower = build_tower(name, model_cfg, prec or FP32)
        tower.load_state_dict(sd, strict=True, assign=True)
        out[name] = tower.eval().requires_grad_(False)
    return out

"""Weight loading: HF-layout state dicts into the port's modules.

The port's parameter names are the diffusers / transformers keys that the JAX
package's `core/importer.py::export_params` writes (for example
`down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_k.weight`,
`text_model.encoder.layers.0.self_attn.k_proj.weight`, `mlp.0.weight`), with
torch's own tensor layouts (OIHW convs, [out, in] linears). So a tower loads
with `load_state_dict(strict=True)` and no renaming. Two things beyond that,
as the JAX importer does them: HF's `position_ids` buffer is dropped, and the
UNet's conv_in is widened 4 -> 8 input channels with zeros when the source
has 4 (a pretrained SD UNet; `core/importer.py:293-306`).

The MutualEncoder flattens NCHW as the reference does, so its exported weights
load unchanged. SDXL's bundle (the port's own) holds a fifth tower,
`text_encoder_2` (transformers' CLIPTextModelWithProjection: `text_model.*`
and `text_projection.weight`), and its UNet the keys `add_embedding.linear_1.*`
and `add_embedding.linear_2.*`.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

BASE_TOWERS = ("unet", "vae", "text_encoder", "fashion_encoder")
TOWERS = BASE_TOWERS + ("text_encoder_2",)


def towers_of(model) -> tuple:
    """The TOWERS a `DiFashion` bundle holds (text_encoder_2 with a second
    text tower only)."""
    return tuple(t for t in TOWERS if getattr(model, t, None) is not None)


def _to_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value))


def prepare_state_dict(module: nn.Module, state_dict: Mapping[str, object],
                       kind: str) -> Dict[str, torch.Tensor]:
    """The HF-layout `state_dict` (numpy arrays or tensors) as the tensors that
    `module.load_state_dict(..., strict=True)` takes. `kind` is one of
    TOWERS."""
    if kind not in TOWERS:
        raise ValueError(f"unknown tower {kind!r}, expected one of {TOWERS}")
    out: Dict[str, torch.Tensor] = {
        key: _to_tensor(value) for key, value in state_dict.items()
        if not key.endswith("position_ids")}
    w = out.get("conv_in.weight")
    if kind == "unet" and w is not None:
        want = module.conv_in.weight.shape
        if w.shape != want and w.shape[0] == want[0] and w.shape[2:] == want[2:] \
                and w.shape[1] < want[1]:
            wide = torch.zeros(want, dtype=w.dtype)
            wide[:, :w.shape[1]] = w
            out["conv_in.weight"] = wide
    return out


def load_tower(module: nn.Module, state_dict: Mapping[str, object], kind: str) -> None:
    """Load an HF-layout state dict into `module` strictly, keeping the
    module's device and dtype."""
    module.load_state_dict(prepare_state_dict(module, state_dict, kind), strict=True)


def load_difashion(model, state_dicts: Mapping[str, Mapping[str, object]]) -> None:
    """Load every tower of a `DiFashion` bundle from {tower: HF state dict}
    (the keys of TOWERS that the bundle holds, `towers_of`; all of them are
    required)."""
    towers = towers_of(model)
    missing = [t for t in towers if t not in state_dicts]
    if missing:
        raise KeyError(f"state dicts missing for towers {missing}")
    for kind in towers:
        load_tower(getattr(model, kind), state_dicts[kind], kind)


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())

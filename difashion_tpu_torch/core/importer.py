"""Stable Diffusion weights from a local diffusers directory. Counterpart of
the reading half of `difashion_tpu/core/importer.py` (`load_state_dict`,
`find_weights_file`, `import_sd_checkpoint`).

    <model_dir>/unet/diffusion_pytorch_model.safetensors
    <model_dir>/vae/diffusion_pytorch_model.safetensors
    <model_dir>/text_encoder/model.safetensors

(or the `.bin` / fp16 / sharded variants that `find_weights_file` lists).
The port's parameter names are the diffusers / transformers keys, so the
towers load through `weights.py::load_tower`, which also widens the UNet's
conv_in from 4 to 8 input channels with zeros. The MutualEncoder
(`fashion_encoder`) is new in DiFashion and keeps its initialisation.

safetensors files are read by this module's own reader (no package): an
8-byte little-endian header length, a JSON header of {name: {dtype, shape,
data_offsets}} with offsets counted from the end of the header, then the raw
little-endian bytes.
"""
from __future__ import annotations

import glob
import json
import logging
import math
import os
import struct
from typing import Dict

import torch
from torch import nn

from difashion_tpu_torch.weights import load_tower, prepare_state_dict

log = logging.getLogger("difashion_tpu_torch")

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U64": torch.uint64, "U32": torch.uint32,
    "U16": torch.uint16, "U8": torch.uint8, "BOOL": torch.bool,
}

# the file names diffusers and transformers save under, in the order checked
WEIGHT_NAMES = (
    "diffusion_pytorch_model.safetensors",
    "model.safetensors",
    "diffusion_pytorch_model.bin",
    "pytorch_model.bin",
    # fp16 variants (diffusers' variant="fp16")
    "diffusion_pytorch_model.fp16.safetensors",
    "model.fp16.safetensors",
    "diffusion_pytorch_model.fp16.bin",
    "pytorch_model.fp16.bin",
)

# older diffusers VAE checkpoints name the attention projections so
_VAE_LEGACY = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}

SD_TOWERS = ("unet", "vae", "text_encoder")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, as CPU tensors of its dtype."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            shape = [int(s) for s in info["shape"]]
            begin, end = info["data_offsets"]
            numel = math.prod(shape)
            need = numel * torch.empty((), dtype=dtype).element_size()
            if end - begin != need:
                raise ValueError(f"{path}: {name} holds {end - begin} bytes, its shape "
                                 f"{shape} in {info['dtype']} needs {need}")
            if numel == 0:
                out[name] = torch.empty(shape, dtype=dtype)
                continue
            f.seek(base + begin)
            buf = bytearray(end - begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: {name} runs past the end of the file")
            out[name] = torch.frombuffer(buf, dtype=dtype).reshape(shape)
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file, a sharded `*.safetensors.index.json` (every shard
    of its weight map merged), or a torch .bin / .pt file (loaded with
    weights_only, a {"state_dict": ...} wrapper unwrapped; entries that are
    not tensors dropped), as {key: CPU tensor} in the stored dtypes."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    if path.endswith(".safetensors.index.json"):
        with open(path) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        sd: Dict[str, torch.Tensor] = {}
        for s in shards:
            sd.update(read_safetensors(os.path.join(os.path.dirname(path), s)))
        return sd
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def find_weights_file(model_dir: str, subfolder: str) -> str:
    """The first of WEIGHT_NAMES under <model_dir>/<subfolder>, else the
    first sharded index there."""
    d = os.path.join(model_dir, subfolder)
    for name in WEIGHT_NAMES:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    idx = sorted(glob.glob(os.path.join(d, "*.safetensors.index.json")))
    if idx:
        return idx[0]
    raise FileNotFoundError(f"no weights file under {d}")


def modern_vae_names(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The VAE's legacy attention keys (query / key / value / proj_attn)
    under the names the port's VAE uses (to_q / to_k / to_v / to_out.0),
    where the modern key is not there already."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if len(parts) >= 2 and parts[-2] in _VAE_LEGACY:
            new = ".".join(parts[:-2] + [_VAE_LEGACY[parts[-2]], parts[-1]])
            if new not in state_dict:
                key = new
        out[key] = value
    return out


def import_tower(module: nn.Module, state_dict: Dict[str, torch.Tensor], kind: str) -> None:
    """Load a diffusers / transformers state dict into one tower. Keys the
    tower does not have are left out with a warning (checkpoints carry
    extras); a missing key raises."""
    if kind == "vae":
        state_dict = modern_vae_names(state_dict)
    own = module.state_dict()
    sd = prepare_state_dict(module, state_dict, kind)
    extra = sorted(k for k in sd if k not in own)
    if extra:
        log.warning("%d %s state-dict keys not consumed by any parameter (naming drift "
                    "or extras?), e.g. %s", len(extra), kind, extra[:5])
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"{kind}: {len(missing)} keys missing, e.g. {missing[:5]}")
    load_tower(module, {k: v for k, v in sd.items() if k in own}, kind)


def import_sd_checkpoint(model_dir: str, model):
    """Fill the unet, vae and text_encoder of a `DiFashion` bundle from a local
    diffusers directory, in place (their device and dtype kept). The
    fashion_encoder keeps its initialisation. Returns the model."""
    for tower in SD_TOWERS:
        import_tower(getattr(model, tower), load_state_dict(find_weights_file(model_dir, tower)),
                     tower)
    return model

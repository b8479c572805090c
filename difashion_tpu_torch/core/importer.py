"""Stable Diffusion weights from and to a local diffusers directory.
Counterpart of `difashion_tpu/core/importer.py` (`load_state_dict`,
`find_weights_file`, `import_sd_checkpoint`) and of `tools/export_hf.py`'s
export (`export_checkpoint`).

    <model_dir>/unet/diffusion_pytorch_model.safetensors
    <model_dir>/vae/diffusion_pytorch_model.safetensors
    <model_dir>/text_encoder/model.safetensors

(or the `.bin` / fp16 / sharded variants that `find_weights_file` lists).
The port's parameter names are the diffusers / transformers keys, so the
towers load through `weights.py::load_tower`, which also widens the UNet's
conv_in from 4 to 8 input channels with zeros. The MutualEncoder
(`fashion_encoder`) is new in DiFashion and keeps its initialisation.

safetensors files are read and written by this module's own code (no
package): an 8-byte little-endian header length, a JSON header of {name:
{dtype, shape, data_offsets}} (and `__metadata__`, string to string) with
offsets counted from the end of the header, then the raw little-endian bytes.
The writer pads the header with spaces to a multiple of 8 bytes, lays the
tensors out in the order of their names, and writes under a temporary name
that it renames into place: a killed write leaves no file that looks whole.

`export_checkpoint` writes a checkpoint of the port's store (or of the JAX
package's) as the files `tools/export_hf.py` writes:

    <out>/unet/diffusion_pytorch_model.safetensors
    <out>/fashion_encoder/diffusion_pytorch_model.safetensors
    <out>/vae/diffusion_pytorch_model.safetensors     (include_frozen)
    <out>/text_encoder/model.safetensors              (include_frozen)

the trainable towers' fp32 weights (or their EMA) and the frozen towers as
the store holds them, under the port's parameter names, which are the
diffusers / transformers keys (the UNet's conv_in at its trained 8 input
channels).
"""
from __future__ import annotations

import glob
import json
import logging
import math
import os
import struct
import sys
import time
from typing import Dict, Optional

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

_SAFETENSORS_NAMES = {
    torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16", torch.int64: "I64",
    torch.int32: "I32", torch.uint8: "U8", torch.bool: "BOOL",
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


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write {name: tensor} (any device; F32, F16, BF16, I64, I32, U8 or
    BOOL) to a .safetensors file at `path`, each tensor in its logical
    (contiguous) order, one host copy at a time. Returns the file's bytes."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors stores little-endian bytes; this host is big-endian")
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = tensors[name]
        dtype = _SAFETENSORS_NAMES.get(t.dtype)
        if dtype is None:
            raise TypeError(f"{name}: dtype {t.dtype} is not one of "
                            f"{sorted(_SAFETENSORS_NAMES.values())}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": dtype, "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for name in names:
                t = tensors[name].detach().to("cpu").contiguous()
                if t.numel():
                    f.write(t.reshape(-1).view(torch.uint8).numpy())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return 8 + len(raw) + offset


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


# ---- export ------------------------------------------------------------------------

# (tower, file name) as tools/export_hf.py writes them
EXPORT_FILES = (("unet", "diffusion_pytorch_model.safetensors"),
                ("fashion_encoder", "diffusion_pytorch_model.safetensors"),
                ("vae", "diffusion_pytorch_model.safetensors"),
                ("text_encoder", "model.safetensors"))


def checkpoint_state_dicts(cfg, ckpt_dir: str, step: Optional[int] = None, ema: bool = False,
                           include_frozen: bool = False, device="cuda"):
    """({tower: state dict}, step) of a checkpoint: the trainable towers'
    weights (their EMA with `ema`, where the checkpoint has one; else the
    weights) restored on `device` in fp32, the dtype the store keeps them
    in, and with `include_frozen` the frozen towers as the store holds them
    (the model's seeded ones where it holds none). Nothing goes through a
    bf16 model: the JAX tool exports the stored fp32 trees too."""
    from difashion_tpu_torch.checkpoint import CheckpointStore
    from difashion_tpu_torch.engine.train import EMAState, TrainState
    from difashion_tpu_torch.models.difashion import FROZEN, create_difashion

    model = create_difashion(cfg.model, seed=cfg.train.seed, device=device,
                             dtype=torch.float32)
    named = model.trainable_parameters()
    names, params = [n for n, _ in named], [p for _, p in named]
    template = TrainState(names=names, params=params, opt_state=None, ema=EMAState(
        params=[torch.empty_like(p) for p in params], step=0) if ema else None)
    store = CheckpointStore(ckpt_dir)
    state = store.load(template, step, mutual_dims=(
        cfg.model.mutual.latent_channels, cfg.model.mutual.latent_size))
    tensors = state.ema.params if ema else state.params
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in zip(names, tensors):
        tower, key = name.split(".", 1)
        out.setdefault(tower, {})[key] = t.detach()
    if include_frozen:
        frozen = store.load_frozen() if store.has_frozen() else {
            tower: getattr(model, tower).state_dict() for tower in FROZEN}
        out.update({tower: frozen[tower] for tower in FROZEN})
    return out, int(state.step)


def export_checkpoint(cfg, ckpt_dir: str, out: str, step: Optional[int] = None,
                      ema: bool = False, include_frozen: bool = False, device="cuda") -> dict:
    """Write a checkpoint as `tools/export_hf.py` does (module docstring):
    each tower copied to the host once, tensor by tensor, into its file.
    Returns {"step", "files": {path: {"tensors", "bytes", "seconds"}}}."""
    sds, step = checkpoint_state_dicts(cfg, ckpt_dir, step, ema, include_frozen, device)
    files = {}
    for tower, fname in EXPORT_FILES:
        if tower not in sds:
            continue
        d = os.path.join(out, tower)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, fname)
        sd = sds.pop(tower)
        t0 = time.perf_counter()
        nbytes = write_safetensors(path, sd, metadata={"format": "pt"})
        files[path] = {"tensors": len(sd), "bytes": nbytes,
                       "seconds": time.perf_counter() - t0}
        log.info("wrote %s: %d bytes -> %s", tower, nbytes, path)
    return {"step": step, "files": files}

"""The JAX package's flax parameter paths and layouts, and the port's names.
A copy of the translation in `difashion_tpu/core/importer.py`
(`flax_path_to_hf_key`, `_to_hf`, the MutualEncoder's NCHW flatten,
`export_params`), with its inverse.

The port's parameter names are the diffusers / transformers keys that
`flax_path_to_hf_key` gives (`('down_0_resnet_1', 'conv1', 'Conv_0',
'kernel')` -> `down_blocks.0.resnets.1.conv1.weight`), and its layouts are
torch's: a conv kernel HWIO -> OIHW, a dense kernel [in, out] -> [out, in],
norms' `scale` -> `weight`. The MutualEncoder's two Linear layers reorder
their flattened latent axis from flax's NHWC flatten to the reference's NCHW
one, which needs the latent (channels, size): `mutual_dims`.

`hf_key_to_flax_path` goes back: it needs to know whether the key's module
is a convolution (its weight is 4-D), because flax wraps every conv and
GroupNorm in a `Conv_0` / `GroupNorm_0` module (except the sd15 spatial
transformer's conv `proj_in` / `proj_out`).
"""
from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

import torch

# the SD towers' kinds, as the JAX importer names them
KINDS = {"unet": "unet", "vae": "vae", "text_encoder": "text", "fashion_encoder": "mutual"}

_BLOCK_RES = re.compile(r"^(down|up)_(\d+)_resnet_(\d+)$")
_BLOCK_ATTN = re.compile(r"^(down|up)_(\d+)_attn_(\d+)$")
_BLOCK_DOWN = re.compile(r"^down_(\d+)_downsample$")
_BLOCK_UP = re.compile(r"^up_(\d+)_upsample$")
_MID_RES = re.compile(r"^mid_resnet_(\d+)$")
_TFB = re.compile(r"^transformer_blocks_(\d+)$")
_LAYERS = re.compile(r"^layers_(\d+)$")
_LAYER_NORM = re.compile(r"^(norm\d|layer_norm\d|final_layer_norm)$")


def _translate_segment(seg: str, kind: str) -> str:
    m = _BLOCK_RES.match(seg)
    if m:
        return f"{m.group(1)}_blocks.{m.group(2)}.resnets.{m.group(3)}"
    m = _BLOCK_ATTN.match(seg)
    if m:
        return f"{m.group(1)}_blocks.{m.group(2)}.attentions.{m.group(3)}"
    m = _BLOCK_DOWN.match(seg)
    if m:
        return f"down_blocks.{m.group(1)}.downsamplers.0"
    m = _BLOCK_UP.match(seg)
    if m:
        return f"up_blocks.{m.group(1)}.upsamplers.0"
    m = _MID_RES.match(seg)
    if m:
        return f"mid_block.resnets.{m.group(1)}"
    if seg == "mid_attn":
        return "mid_block.attentions.0"
    m = _TFB.match(seg)
    if m:
        return f"transformer_blocks.{m.group(1)}"
    m = _LAYERS.match(seg)
    if m:
        return f"encoder.layers.{m.group(1)}"
    if seg in ("to_out_0", "net_0", "net_2"):
        return seg[:-2] + "." + seg[-1]
    if seg in ("Conv_0", "GroupNorm_0"):
        return ""  # wrapper modules are transparent in HF naming
    if kind == "text" and seg in ("token_embedding", "position_embedding"):
        return "embeddings." + seg
    if kind == "text" and seg in ("fc1", "fc2"):
        return "mlp." + seg
    if kind == "mutual" and seg in ("mlp_0", "mlp_3"):
        return seg[:-2] + "." + seg[-1]
    return seg


def flax_path_to_hf_key(path: Tuple[str, ...], kind: str) -> str:
    """('down_0_resnet_1', 'conv1', 'Conv_0', 'kernel') ->
    'down_blocks.0.resnets.1.conv1.weight' (the MutualEncoder's unused
    `category_embedding` -> 'category_embedding.weight')."""
    if kind == "mutual" and path == ("category_embedding",):
        return "category_embedding.weight"
    *mods, leaf = path
    segs = [s for s in (_translate_segment(m, kind) for m in mods) if s]
    if leaf in ("kernel", "scale", "embedding"):
        hf_leaf = "weight"
    elif leaf == "bias":
        hf_leaf = "bias"
    else:
        raise KeyError(f"unknown leaf {leaf!r} at {path}")
    return ("text_model." if kind == "text" else "") + ".".join(segs + [hf_leaf])


def hf_key_to_flax_path(key: str, kind: str, conv: bool) -> Tuple[str, ...]:
    """The inverse of `flax_path_to_hf_key`; `conv`: the key's module is a
    convolution (its weight is 4-D)."""
    if kind == "mutual" and key == "category_embedding.weight":
        return ("category_embedding",)
    toks = key.split(".")
    if kind == "text":
        if toks[0] != "text_model":
            raise KeyError(key)
        toks = toks[1:]
    *toks, hf_leaf = toks
    segs, i = [], 0
    while i < len(toks):
        t, nxt = toks[i], toks[i + 1:]
        if t in ("down_blocks", "up_blocks") and len(nxt) >= 3:
            side, blk, what, j = t[:-len("_blocks")], nxt[0], nxt[1], nxt[2]
            segs.append({"resnets": f"{side}_{blk}_resnet_{j}",
                         "attentions": f"{side}_{blk}_attn_{j}",
                         "downsamplers": f"down_{blk}_downsample",
                         "upsamplers": f"up_{blk}_upsample"}[what])
            i += 4
        elif t == "mid_block":
            segs.append(f"mid_resnet_{nxt[1]}" if nxt[0] == "resnets" else "mid_attn")
            i += 3
        elif t == "transformer_blocks":
            segs.append(f"transformer_blocks_{nxt[0]}")
            i += 2
        elif kind == "text" and t == "encoder" and nxt[:1] == ["layers"]:
            segs.append(f"layers_{nxt[1]}")
            i += 3
        elif kind == "text" and t in ("embeddings", "mlp"):
            i += 1
        elif t in ("to_out", "net") or (kind == "mutual" and t == "mlp"):
            segs.append(f"{t}_{nxt[0]}")
            i += 2
        else:
            segs.append(t)
            i += 1
    module, parent = segs[-1], (segs[-2] if len(segs) > 1 else "")
    group_norm = (module in ("conv_norm_out", "group_norm")
                  or (module in ("norm1", "norm2") and "_resnet_" in parent)
                  or (module == "norm" and "attn" in parent))
    if conv and module not in ("proj_in", "proj_out"):
        segs.append("Conv_0")
        leaf = "kernel"
    elif group_norm:
        segs.append("GroupNorm_0")
        leaf = "scale"
    elif _LAYER_NORM.match(module) or module == "norm":
        leaf = "scale"
    elif module in ("token_embedding", "position_embedding"):
        leaf = "embedding"
    else:
        leaf = "kernel"
    return tuple(segs) + ("bias" if hf_leaf == "bias" else leaf,)


def mutual_latent_dims(flat_dim: int, dims: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """(C, S) for a MutualEncoder flat latent dim C*S*S: `dims` from the
    model config, which must be given (4*64*64 == 16*32*32: the flat size
    does not decide them)."""
    if dims is None:
        raise ValueError(f"the MutualEncoder's latent (channels, size) are needed to place "
                         f"its flat dim {flat_dim}: pass mutual_dims from the model config")
    c, s = dims
    if c * s * s != flat_dim:
        raise ValueError(f"mutual dims {dims} inconsistent with flat dim {flat_dim}")
    return c, s


def to_port(path: Tuple[str, ...], kind: str,
            mutual_dims: Optional[Tuple[int, int]] = None
            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The function taking a flax leaf at `path` to the port's layout (a
    view where it can be)."""
    leaf = path[-1]
    if kind == "mutual" and path[0] in ("mlp_0", "mlp_3") and leaf == "kernel":
        def mutual_kernel(v):
            if path[0] == "mlp_0":       # [S*S*C, hid] -> [hid, C*S*S]
                flat, hid = v.shape
                c, s = mutual_latent_dims(flat, mutual_dims)
                return v.T.reshape(hid, s, s, c).permute(0, 3, 1, 2).reshape(hid, flat)
            hid, flat = v.shape              # [hid, S*S*C] -> [C*S*S, hid]
            c, s = mutual_latent_dims(flat, mutual_dims)
            return v.T.reshape(s, s, c, hid).permute(2, 0, 1, 3).reshape(flat, hid)
        return mutual_kernel
    if kind == "mutual" and path[0] == "mlp_3" and leaf == "bias":
        def mutual_bias(v):
            c, s = mutual_latent_dims(v.shape[0], mutual_dims)
            return v.reshape(s, s, c).permute(2, 0, 1).reshape(-1)
        return mutual_bias
    if leaf == "kernel":
        return lambda v: v.permute(3, 2, 0, 1) if v.dim() == 4 else (v.T if v.dim() == 2 else v)
    return lambda v: v


def to_flax(path: Tuple[str, ...], kind: str,
            mutual_dims: Optional[Tuple[int, int]] = None
            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The inverse of `to_port`."""
    leaf = path[-1]
    if kind == "mutual" and path[0] in ("mlp_0", "mlp_3") and leaf == "kernel":
        def mutual_kernel(v):
            if path[0] == "mlp_0":       # [hid, C*S*S] -> [S*S*C, hid]
                hid, flat = v.shape
                c, s = mutual_latent_dims(flat, mutual_dims)
                return v.reshape(hid, c, s, s).permute(0, 2, 3, 1).reshape(hid, flat).T
            flat, hid = v.shape              # [C*S*S, hid] -> [hid, S*S*C]
            c, s = mutual_latent_dims(flat, mutual_dims)
            return v.reshape(c, s, s, hid).permute(1, 2, 0, 3).reshape(flat, hid).T
        return mutual_kernel
    if kind == "mutual" and path[0] == "mlp_3" and leaf == "bias":
        def mutual_bias(v):
            c, s = mutual_latent_dims(v.shape[0], mutual_dims)
            return v.reshape(c, s, s).permute(1, 2, 0).reshape(-1)
        return mutual_bias
    if leaf == "kernel":
        return lambda v: v.permute(2, 3, 1, 0) if v.dim() == 4 else (v.T if v.dim() == 2 else v)
    return lambda v: v

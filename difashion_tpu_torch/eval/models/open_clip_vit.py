"""OpenCLIP ViT-H/14 image and text towers. Counterpart of
`difashion_tpu/eval/models/open_clip_vit.py`, the tower of
`open_clip.create_model_and_transforms('ViT-H-14')` that the reference's
evaluation uses:

  * image: patch 14 (a conv without bias), width 1280, 32 layers, 16 heads
    (d = 80), a class token, 257 tokens, pre- and post-LayerNorm, a
    projection to 1024;
  * text: width 1024, 24 layers, 16 heads, 77 tokens, causal (masked with
    finfo(float32).min), pooled on the argmax token (the EOS has the largest
    id), a projection to 1024.

LayerNorm runs in fp32 and the MLP's GELU is exact (erf), as in the JAX
module. Attention is a plain matmul + softmax in fp32 (the JAX package runs
`einsum` and softmax here, no Pallas kernel).

The parameters carry open_clip's own state-dict names (`visual.conv1.weight`,
`visual.transformer.resblocks.{i}.attn.in_proj_weight`,
`token_embedding.weight`, `text_projection`, ...) in torch's layouts, so an
open_clip state dict loads with `load_state_dict(strict=True)` (its unused
`logit_scale` left out, `eval/extractors.py`).

`preprocess_clip_image` is open_clip's eval transform as the JAX package
runs it: a bicubic resize of the short side to 224 that antialiases when it
shrinks (`jax.image.resize`; `antialias=True` here), a center crop, then the
CLIP mean and std.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    embed_dim: int = 1024          # output projection dim

    @staticmethod
    def h14() -> "ViTConfig":
        return ViTConfig()

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(image_size=28, patch_size=14, width=32, layers=2,
                         heads=4, embed_dim=16)


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    width: int = 1024
    layers: int = 24
    heads: int = 16
    context_length: int = 77
    embed_dim: int = 1024

    @staticmethod
    def h14() -> "TextConfig":
        return TextConfig()

    @staticmethod
    def tiny() -> "TextConfig":
        return TextConfig(vocab_size=1000, width=32, layers=2, heads=4, embed_dim=16)


def layer_norm32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32, cast back to x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps).to(x.dtype)


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (`in_proj_weight` [3W, W],
    `in_proj_bias`, `out_proj`), batch-first, softmax in fp32."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S, W = x.shape
        hd = W // self.heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, S, self.heads, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        logits = torch.matmul(q, k.transpose(-1, -2)) / torch.sqrt(
            torch.tensor(hd, dtype=x.dtype, device=x.device))
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        o = torch.matmul(w, v).transpose(1, 2).reshape(B, S, W)
        return self.out_proj(o)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualBlock(nn.Module):
    """Pre-LN transformer block (open_clip's `ResidualAttentionBlock`)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MultiheadAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = MLP(width)

    def forward(self, x, mask=None):
        x = x + self.attn(layer_norm32(self.ln_1, x), mask)
        return x + self.mlp(layer_norm32(self.ln_2, x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualBlock(width, heads) for _ in range(layers))

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class CLIPImageEncoder(nn.Module):
    """open_clip's `VisionTransformer` (the `visual.*` keys without the
    prefix)."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        self.config = c = config
        self.conv1 = nn.Conv2d(3, c.width, c.patch_size, stride=c.patch_size, bias=False)
        tokens = (c.image_size // c.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.empty(c.width))
        self.positional_embedding = nn.Parameter(torch.empty(tokens, c.width))
        self.ln_pre = nn.LayerNorm(c.width, eps=1e-5)
        self.transformer = Transformer(c.width, c.layers, c.heads)
        self.ln_post = nn.LayerNorm(c.width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(c.width, c.embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, 3, 224, 224], CLIP-normalized -> [B, embed_dim]."""
        B = images.shape[0]
        x = self.conv1(images.to(self.conv1.weight.dtype))       # [B, W, g, g]
        x = x.flatten(2).transpose(1, 2)                         # row-major patches
        cls = self.class_embedding.to(x.dtype).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.transformer(layer_norm32(self.ln_pre, x))
        return layer_norm32(self.ln_post, x[:, 0]) @ self.proj.to(x.dtype)


class CLIPTextTower(nn.Module):
    """open_clip's text tower (the CLIP model's top-level text keys)."""

    def __init__(self, config: TextConfig):
        super().__init__()
        self.text_config = c = config
        self.token_embedding = nn.Embedding(c.vocab_size, c.width)
        self.positional_embedding = nn.Parameter(torch.empty(c.context_length, c.width))
        self.transformer = Transformer(c.width, c.layers, c.heads)
        self.ln_final = nn.LayerNorm(c.width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(c.width, c.embed_dim))

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: [B, 77] -> [B, embed_dim] (argmax-EOS pooled, projected)."""
        B, S = input_ids.shape
        x = self.token_embedding(input_ids) + self.positional_embedding[:S]
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()[None, None]
        x = layer_norm32(self.ln_final, self.transformer(x, causal))
        pooled = x[torch.arange(B, device=x.device), input_ids.argmax(dim=-1)]
        return pooled @ self.text_projection

    forward = encode_text


class OpenCLIP(CLIPTextTower):
    """Both towers under open_clip's CLIP key names: the text tower's at the
    top level, the image tower under `visual.`."""

    def __init__(self, vision: ViTConfig, text: TextConfig):
        super().__init__(text)
        self.visual = CLIPImageEncoder(vision)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)


def init_open_clip(model: OpenCLIP, generator: torch.Generator) -> OpenCLIP:
    """Seeded random weights (normal(0.02) for embeddings, projections and
    linear weights, ones / zeros for LayerNorm, zero biases): a stand-in for
    real weights in tests and throughput runs."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in name or name.startswith("ln_"):
                p.fill_(1.0)
            else:
                std = 0.02 if p.dim() < 4 else (1.0 / np.sqrt(p[0].numel()))
                p.copy_(torch.randn(p.shape, generator=generator) * std)
    return model


def _device_images(images01, device) -> torch.Tensor:
    """[N, H, W, 3] in [0, 1] (numpy or tensor) -> [N, 3, H, W] fp32 on device."""
    x = torch.as_tensor(np.asarray(images01) if not torch.is_tensor(images01) else images01)
    return x.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2)


def preprocess_clip_image(images01, size: int = 224, device="cpu") -> torch.Tensor:
    """[N, H, W, 3] in [0, 1] -> CLIP-normalized [N, 3, size, size] fp32 on
    `device`: bicubic resize of the short side to `size` (antialiased when
    shrinking, as `jax.image.resize`), center crop, mean / std."""
    x = _device_images(images01, device)
    n, _, h, w = x.shape
    scale = size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    x = F.interpolate(x, size=(nh, nw), mode="bicubic", align_corners=False, antialias=True)
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, :, top:top + size, left:left + size]
    mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std

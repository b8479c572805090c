"""NCHW neural-net primitives shared by the UNet, the VAE and the text tower.

Counterparts of `difashion_tpu/nn/layers.py`. Module and parameter names are
the diffusers ones, so the HF-layout state dicts that the JAX package exports
load 1:1. Weights live in the module's dtype; GroupNorm statistics are fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding in fp32 (period 10000), [B] ->
    [B, embedding_dim]."""
    half_dim = embedding_dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    if flip_sin_to_cos:
        emb = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    else:
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Linear -> SiLU -> Linear."""

    def __init__(self, in_features: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_features, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class GroupNorm(nn.GroupNorm):
    """GroupNorm with fp32 statistics (biased variance) and affine, the result
    cast to the input dtype before the optional SiLU, as
    `difashion_tpu/nn/pallas/groupnorm.py::_gn_silu_ref` computes it."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__(num_groups, num_channels, eps=eps)
        if act not in (None, "silu"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps).to(x.dtype)
        return F.silu(y) if self.act == "silu" else y


def conv2d(in_channels: int, out_channels: int, kernel_size: int = 3,
           stride: int = 1) -> nn.Conv2d:
    """Conv with torch's symmetric (k-1)//2 padding."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                     padding=(kernel_size - 1) // 2)


class ResnetBlock2D(nn.Module):
    """GN-SiLU-conv, + time embedding, GN-SiLU-conv, + (1x1-projected) input.
    The UNet's up path calls it on torch.cat([h, skip], 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps, act="silu")
        self.conv1 = conv2d(in_channels, out_channels)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = GroupNorm(groups, out_channels, eps, act="silu")
        self.conv2 = conv2d(out_channels, out_channels)
        self.conv_shortcut = (conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv after an asymmetric (0,1,0,1) pad."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """Nearest 2x upsample + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv2d(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class GEGLU(nn.Module):
    """Linear to 2*dim_out, split, h * gelu(gate) with the exact gelu."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU(d -> 4d) -> Dropout -> Linear(4d -> d) (keys net.0 / net.2)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net = nn.ModuleList([
            GEGLU(dim, dim * mult), nn.Dropout(dropout), nn.Linear(dim * mult, dim),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x

"""Neural-net primitives shared by the UNet, the VAE and the text tower.

Counterparts of `difashion_tpu/nn/layers.py`. Module and parameter names are
the diffusers ones, so the HF-layout state dicts that the JAX package exports
load 1:1. Tensors are [B, C, H, W] by shape; the UNet and the VAE keep every
4-D activation and conv weight channels-last in memory (`to_channels_last`),
the layout of the JAX package's NHWC, of cuDNN's fast convolutions and of the
GroupNorm kernel. Weights live in the module's dtype; GroupNorm statistics are
fp32. Every linear layer of the port's models is a `Dense`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from difashion_tpu_torch.nn import kernels
from difashion_tpu_torch.nn.kernels.geglu_matmul import (
    geglu_matmul,
    geglu_matmul_ref,
    geglu_route,
)
from difashion_tpu_torch.nn.kernels.groupnorm import (
    ACTS,
    GroupNormSiLU,
    channels_last,
    group_norm_silu,
    group_norm_silu_ref,
)
from difashion_tpu_torch.nn.kernels.skinny_matmul import (
    SkinnyMatmul,
    aligned,
    compute_dtypes,
    dense_route,
    skinny_matmul,
    skinny_matmul_ref,
)


def to_channels_last(module: nn.Module) -> nn.Module:
    """Every 4-D parameter and buffer of `module` (the conv weights) in
    `torch.channels_last`, in place; what they hold is unchanged. A
    convolution with a channels-last weight gives a channels-last output, so
    the activations follow the weights; a module that is moved or cast later
    (`.to`, `load_state_dict`, `copy.deepcopy`) keeps the layout."""
    return module.to(memory_format=torch.channels_last)


class Dense(nn.Linear):
    """`nn.Linear` (same parameters, same keys) whose product goes through
    the skinny-N matmul kernel where `dense_route` takes it: the JAX
    package's `pallas_dense_dot` gate, on CUDA. There x and the weight are
    cast to the compute dtype (autocast's, where it is on; the gradient flows
    back through the cast to an fp32 master weight), and the kernel (through
    `SkinnyMatmul` while autograd records) multiplies them and adds the bias,
    cast to the same dtype, to the rounded product in its epilogue, as flax's
    Dense adds it after the product. Outside the gate, where the kernels
    cannot read the cast and reshaped x as it lies (`aligned`: K, the row
    stride and the base in 16-byte pieces), and always on the CPU,
    `F.linear`. While `kernels.plain_versions()` is open the gated products
    take the kernel's plain version."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not dense_route(x, self.weight):
            return F.linear(x, self.weight, self.bias)
        x_dtype, w_dtype = compute_dtypes(x, self.weight)
        # the reshape of a strided view may copy: the rule holds on what is passed
        x2 = x.to(x_dtype).reshape(-1, x.shape[-1])
        if not aligned(x2):
            return F.linear(x, self.weight, self.bias)
        w = self.weight.to(w_dtype)
        b = None if self.bias is None else self.bias.to(x_dtype)
        plain = kernels.plain_active()
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad
                                        or (b is not None and b.requires_grad)):
            y = SkinnyMatmul.apply(x2, w, plain, b)
        else:
            y = (skinny_matmul_ref if plain else skinny_matmul)(x2, w, b)
        return y.reshape(x.shape[:-1] + (w.shape[0],))


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
        self.linear_1 = Dense(in_features, time_embed_dim)
        self.linear_2 = Dense(time_embed_dim, time_embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class GroupNorm(nn.GroupNorm):
    """GroupNorm with fp32 statistics (biased variance) and affine, the result
    cast to the input dtype before the optional SiLU, as
    `difashion_tpu/nn/pallas/groupnorm.py::_gn_silu_ref` computes it.

    On CUDA every call goes through the hand-written kernel (through
    `GroupNormSiLU` while autograd records), on the CPU through its plain
    version, and through the plain version on any device while
    `kernels.plain_versions()` is open."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__(num_groups, num_channels, eps=eps)
        if act not in ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        args = (self.weight, self.bias, self.num_groups, self.eps, self.act)
        if kernels.plain_active():
            return group_norm_silu_ref(x, *args)
        # the kernel reads channels-last; a no-op for the models' activations
        x = channels_last(x)
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad
                                        or self.bias.requires_grad):
            return GroupNormSiLU.apply(x, *args)
        return group_norm_silu(x, *args)


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
        self.time_emb_proj = (Dense(temb_channels, out_channels)
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
        # interpolate keeps channels-last but for a 1x1 input, whose layout
        # is ambiguous (the tiny config's deepest level)
        up = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(up.contiguous(memory_format=torch.channels_last))


class GEGLU(nn.Module):
    """Linear to 2*dim_out, split, h * gelu(gate) with the exact gelu.

    Where `geglu_route` takes the call (CUDA, one 16-bit compute dtype,
    dim_out a multiple of the kernel's tile, autograd not recording) and the
    kernel reads the cast and reshaped x as it lies (`aligned`), the three
    steps are one launch of the fused kernel (`geglu_matmul`), which rounds
    as the JAX GEGLU does; while `kernels.plain_versions()` is open, its
    plain version. Otherwise, training and fp32 and the CPU among them, the
    projection (a `Dense`), the split, the gelu and the product."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Dense(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.proj.weight, self.proj.bias
        if geglu_route(x, w, b):
            x_dtype, w_dtype = compute_dtypes(x, w)
            x2 = x.to(x_dtype).reshape(-1, x.shape[-1])
            if aligned(x2):
                fused = geglu_matmul_ref if kernels.plain_active() else geglu_matmul
                y = fused(x2, w.to(w_dtype), None if b is None else b.to(x_dtype))
                return y.reshape(x.shape[:-1] + (w.shape[0] // 2,))
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU(d -> 4d) -> Dropout -> Linear(4d -> d) (keys net.0 / net.2)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net = nn.ModuleList([
            GEGLU(dim, dim * mult), nn.Dropout(dropout), Dense(dim * mult, dim),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x

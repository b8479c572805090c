"""AutoencoderKL (the SD VAE), diffusers key layout. Counterpart of
`difashion_tpu/models/vae.py`. Generation decodes; the catalog precompute
(`data/precompute.py`) and a training step on image batches encode. The
caller applies the scaling factor (0.18215). Tensors are [B, C, H, W] by
shape and channels-last in memory, as in the UNet: the conv weights from the
build, the input on entry (a view of NHWC images or latents), so every
activation inside, as cuDNN's fast convolutions and the GroupNorm kernel read
it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from difashion_tpu_torch.config import VAEConfig
from difashion_tpu_torch.nn.attention import VAEAttention
from difashion_tpu_torch.nn.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    conv2d,
    to_channels_last,
)


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise: `noise` given, or drawn from `generator`."""
        std = torch.exp(0.5 * self.logvar.clamp(-30.0, 20.0))
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + std * noise

    def mode(self) -> torch.Tensor:
        return self.mean


class _Blocks(nn.Module):
    """A level of the encoder or decoder: resnets, then an optional resampler
    (keys `resnets.i`, `downsamplers.0` / `upsamplers.0`)."""

    def __init__(self, resnets, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        for s in getattr(self, "downsamplers", ()):
            x = s(x)
        for s in getattr(self, "upsamplers", ()):
            x = s(x)
        return x


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, groups=groups, eps=1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g, boc = cfg.norm_num_groups, cfg.block_out_channels
        self.conv_in = conv2d(cfg.in_channels, boc[0])
        blocks, ch = [], boc[0]
        for bi, out_ch in enumerate(boc):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, groups=g, eps=1e-6))
                ch = out_ch
            last = bi == len(boc) - 1
            blocks.append(_Blocks(resnets, downsample=None if last else Downsample2D(ch)))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(ch, g)
        self.conv_norm_out = GroupNorm(g, ch, eps=1e-6, act="silu")
        self.conv_out = conv2d(ch, 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = conv2d(cfg.latent_channels, rev[0])
        self.mid_block = _MidBlock(rev[0], g)
        blocks, ch = [], rev[0]
        for bi, out_ch in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch, out_ch, groups=g, eps=1e-6))
                ch = out_ch
            last = bi == len(rev) - 1
            blocks.append(_Blocks(resnets, upsample=None if last else Upsample2D(ch)))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, ch, eps=1e-6, act="silu")
        self.conv_out = conv2d(ch, cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        lat = config.latent_channels
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        to_channels_last(self)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """x [B, 3, H, W] in [-1, 1] -> DiagonalGaussian over [B, C_lat, H/8, W/8]
        (channels-last)."""
        moments = self.quant_conv(self.encoder(
            x.to(self.dtype).contiguous(memory_format=torch.channels_last)))
        mean, logvar = moments.chunk(2, dim=1)
        return DiagonalGaussian(mean, logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, C_lat, h, w] (already divided by the scaling factor) -> [B, 3, H, W]
        (channels-last)."""
        return self.decoder(self.post_quant_conv(
            z.to(self.dtype).contiguous(memory_format=torch.channels_last)))


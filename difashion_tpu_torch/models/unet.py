"""SD UNet2DCondition, diffusers key layout, with DiFashion's 8-channel
conv_in. Counterpart of `difashion_tpu/models/unet.py`. Tensors are
[B, C, H, W] by shape and channels-last in memory: the conv weights are made
channels-last where the model is built, and the sample on entry, so every
activation inside is too (the JAX package's NHWC), as cuDNN's fast
convolutions and the GroupNorm kernel read it.

conv_in -> time MLP -> 3 cross-attention down blocks + 1 plain down block ->
mid (resnet, transformer, resnet) -> 1 plain up block + 3 cross-attention up
blocks -> GN/SiLU/conv_out. Skips are pushed after every down resnet and
downsample and popped in reverse by the up resnets, each of which runs on
torch.cat([h, skip], 1).

Gradient checkpointing (the JAX package's `remat`) wraps every ResnetBlock2D
and Transformer2D call in `torch.utils.checkpoint` (non-reentrant) while
autograd records. `remat_policy` picks what a checkpointed block keeps, as
close to JAX's policies as torch's selective checkpointing allows: None saves
nothing (everything is recomputed); "dots" saves the outputs of matrix
products and convolutions (`jax.checkpoint_policies.checkpoint_dots`);
"dots_no_batch" saves the outputs of matrix products without batch dims, that
is of the linear layers, and no convolutions
(`dots_with_no_batch_dims_saveable`). The attention kernels are recomputed
under every policy, as the Pallas calls are in JAX. The gradients are the same
under every policy.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from difashion_tpu_torch.config import UNetConfig
from difashion_tpu_torch.core import tracing
from difashion_tpu_torch.nn.attention import Transformer2D
from difashion_tpu_torch.nn.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    conv2d,
    get_timestep_embedding,
    to_channels_last,
)


_aten = torch.ops.aten
REMAT_POLICIES = {
    None: None,
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default, _aten.convolution.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}
SPANS = {ResnetBlock2D: "unet.resnet", Transformer2D: "unet.transformer"}


class _Block(nn.Module):
    """One UNet level: `resnets.i`, `attentions.i` (maybe none) and
    `downsamplers.0` / `upsamplers.0` (maybe none)."""

    def __init__(self, resnets: List[nn.Module], attentions: List[nn.Module],
                 downsample: Optional[nn.Module] = None,
                 upsample: Optional[nn.Module] = None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        boc, g = cfg.block_out_channels, cfg.norm_num_groups
        temb_ch = boc[0] * 4

        def spatial(ch: int) -> Transformer2D:
            heads = cfg.fixed_num_heads or ch // cfg.attention_head_dim
            return Transformer2D(heads, ch // heads, ch, 1, cfg.cross_attention_dim,
                                 cfg.use_linear_projection, g)

        self.conv_in = conv2d(cfg.in_channels, boc[0])
        self.time_embedding = TimestepEmbedding(boc[0], temb_ch)

        # the skip channels, pushed as the forward pass pushes the skips
        ch, skips = boc[0], [boc[0]]
        down = []
        for bi, block_type in enumerate(cfg.down_block_types):
            out_ch = boc[bi]
            last = bi == len(cfg.down_block_types) - 1
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, temb_ch, g))
                ch = out_ch
                if block_type == "CrossAttnDownBlock2D":
                    attns.append(spatial(ch))
                skips.append(ch)
            down.append(_Block(resnets, attns,
                               downsample=None if last else Downsample2D(ch)))
            if not last:
                skips.append(ch)
        self.down_blocks = nn.ModuleList(down)

        self.mid_block = _Block(
            [ResnetBlock2D(ch, ch, temb_ch, g), ResnetBlock2D(ch, ch, temb_ch, g)],
            [spatial(ch)])

        up = []
        for bi, block_type in enumerate(cfg.up_block_types):
            out_ch = list(reversed(boc))[bi]
            last = bi == len(cfg.up_block_types) - 1
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skips.pop(), out_ch, temb_ch, g))
                ch = out_ch
                if block_type == "CrossAttnUpBlock2D":
                    attns.append(spatial(ch))
            up.append(_Block(resnets, attns,
                             upsample=None if last else Upsample2D(ch)))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = GroupNorm(g, ch, act="silu")
        self.conv_out = conv2d(ch, cfg.out_channels)
        self.gradient_checkpointing = False
        self.remat_policy: Optional[str] = None
        to_channels_last(self)

    def set_gradient_checkpointing(self, enabled: bool,
                                   policy: Optional[str] = None) -> None:
        if policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {policy!r}, expected one of "
                             f"{list(REMAT_POLICIES)}")
        self.gradient_checkpointing, self.remat_policy = enabled, policy

    def _call(self, block: nn.Module, *args, **kwargs):
        """block(*args) under the span of its type (`SPANS`), checkpointed
        when gradient checkpointing is on and autograd records."""
        with tracing.span(SPANS[type(block)]):
            if not (self.gradient_checkpointing and torch.is_grad_enabled()):
                return block(*args, **kwargs)
            saved = REMAT_POLICIES[self.remat_policy]
            if saved is not None:
                kwargs["context_fn"] = functools.partial(
                    create_selective_checkpoint_contexts, list(saved))
            return checkpoint(block, *args, use_reentrant=False, **kwargs)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """sample [B, C_in, H, W]; timesteps [B] (or a scalar); context
        [B, S, context_dim]. Returns [B, C_out, H, W], channels-last, in the
        compute dtype. The sample is made channels-last first (a view of an
        NHWC sample: no copy)."""
        cfg, dtype = self.config, self.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0],
                                       cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(t_emb.to(dtype))
        ctx = encoder_hidden_states.to(dtype)

        h = self.conv_in(sample.to(dtype).contiguous(memory_format=torch.channels_last))
        skips = [h]
        for block in self.down_blocks:
            for i, resnet in enumerate(block.resnets):
                h = self._call(resnet, h, temb)
                if len(block.attentions):
                    h = self._call(block.attentions[i], h, ctx)
                skips.append(h)
            for down in getattr(block, "downsamplers", ()):
                h = down(h)
                skips.append(h)

        mid = self.mid_block
        h = self._call(mid.resnets[0], h, temb)
        h = self._call(mid.attentions[0], h, ctx)
        h = self._call(mid.resnets[1], h, temb)

        for block in self.up_blocks:
            for i, resnet in enumerate(block.resnets):
                h = self._call(resnet, torch.cat([h, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    h = self._call(block.attentions[i], h, ctx)
            for upsample in getattr(block, "upsamplers", ()):
                h = upsample(h)

        return self.conv_out(self.conv_norm_out(h))

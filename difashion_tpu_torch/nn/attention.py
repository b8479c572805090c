"""Attention: the `sdpa` router over the flash-attention kernel, and the SD
transformer modules around it. Counterparts of `difashion_tpu/nn/attention.py`.

Routing of `sdpa` on CUDA:
  * head dim <= 128, bf16, fp16 or fp32: the hand-written kernels (every
    UNet self- and cross-attention, sd2's d = 64 and sd15's 40 and 80 alike;
    fp32 through the fp32 kernels), as the JAX package's gate sends every
    d <= 128 of any dtype to its Pallas kernel. While autograd records (q, k
    or v requires grad), through `FlashAttention`: the forward kernel, then
    the dQ and dK/dV kernels in the backward. Under `no_grad` /
    `inference_mode` the forward kernel alone, which saves nothing;
  * head dim > 128 (the VAE mid-attention, d = 512, once per decode; sd15's
    d = 160): plain matmul + softmax, as the JAX package computes it outside
    Pallas.
A kernel that does not build or launch raises; nothing gives way to a plain
version. On the CPU the kernels' plain versions stand in for them (the
wrappers decide that from the tensor's device). While
`kernels.plain_versions()` is open a call goes, forward and backward, through
the plain versions on any device; it exists so a run can hold the kernel path
against it.

The UNet's and the VAE's activations are channels-last, so the
[B, C, H, W] <-> [B, S, C] turns around the projections are views: no copy on
either side. The residual adds put the residual first (`x + h`): an add takes
the memory layout of its first operand, which is channels-last throughout.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from difashion_tpu_torch.nn import kernels
from difashion_tpu_torch.nn.kernels.flash_attention import (
    MAX_HEAD_DIM,
    FlashAttention,
    flash_attention,
    flash_attention_ref,
)
from difashion_tpu_torch.nn.layers import Dense, FeedForward, GroupNorm


def _plain_sdpa(q, k, v, scale):
    """Logits in the input dtype, softmax in fp32, weights back in the input
    dtype (the JAX package's non-kernel path)."""
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal scaled dot-product attention over [B, H, S, D] tensors."""
    plain = kernels.plain_active()
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if d > MAX_HEAD_DIM:
        return _plain_sdpa(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale, plain)
    if plain:
        return flash_attention_ref(q, k, v, scale)[0]
    return flash_attention(q, k, v, scale)[0]


class CrossAttention(nn.Module):
    """Multi-head attention with an optional context: no-bias q/k/v, biased out
    projection (key `to_out.0`)."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        context_dim = context_dim or query_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Dense(inner, query_dim), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        context = x if context is None else context
        b, sq, _ = x.shape
        skv = context.shape[1]
        # [B, S, H, D] views read in place by the kernel, seen as [B, H, S, D]
        q = self.to_q(x).view(b, sq, self.heads, self.head_dim).transpose(1, 2)
        k = self.to_k(context).view(b, skv, self.heads, self.head_dim).transpose(1, 2)
        v = self.to_v(context).view(b, skv, self.heads, self.head_dim).transpose(1, 2)
        out = sdpa(q, k, v)
        out = out.transpose(1, 2).reshape(b, sq, self.heads * self.head_dim)
        return self.to_out[0](out)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> GEGLU FF, all residual."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN -> proj_in -> transformer blocks -> proj_out -> + residual. Linear
    projections (sd2, SDXL) or 1x1 convs (sd15)."""

    def __init__(self, heads: int, head_dim: int, in_channels: int, depth: int,
                 context_dim: int, use_linear_projection: bool = True,
                 norm_num_groups: int = 32):
        super().__init__()
        inner = heads * head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = Dense(in_channels, inner)
            self.proj_out = Dense(inner, in_channels)
        else:
            self.proj_in = nn.Conv2d(in_channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, in_channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, head_dim, context_dim)
            for _ in range(depth)
        ])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wid = x.shape
        # channels-last [B, C, H, W] <-> [B, S, C]: views
        h = self.norm(x)
        if self.use_linear_projection:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(b, hgt * wid, c))
        else:
            h = self.proj_in(h)
            h = h.permute(0, 2, 3, 1).reshape(b, hgt * wid, h.shape[1])
        for block in self.transformer_blocks:
            h = block(h, context)
        if self.use_linear_projection:
            h = self.proj_out(h)
            h = h.reshape(b, hgt, wid, c).permute(0, 3, 1, 2)
        else:
            h = h.reshape(b, hgt, wid, h.shape[-1]).permute(0, 3, 1, 2)
            h = self.proj_out(h)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid-block (d = C)."""

    def __init__(self, channels: int, norm_num_groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(norm_num_groups, channels, eps=1e-6)
        self.to_q = Dense(channels, channels)
        self.to_k = Dense(channels, channels)
        self.to_v = Dense(channels, channels)
        self.to_out = nn.ModuleList([Dense(channels, channels), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wid = x.shape
        # channels-last [B, C, H, W] <-> [B, HW, C]: views (the skinny-N
        # kernel reads rows with unit stride along C)
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hgt * wid, c)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        out = sdpa(q[:, None], k[:, None], v[:, None])[:, 0]
        out = self.to_out[0](out)
        return x + out.reshape(b, hgt, wid, c).permute(0, 3, 1, 2)

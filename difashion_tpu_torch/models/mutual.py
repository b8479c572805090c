"""MutualEncoder: the MLP that turns the co-item latent sum into the mutual
condition. Counterpart of `difashion_tpu/models/mutual.py`.

It flattens NCHW latents as the reference does, so the HF-layout state dict
that `export_params(..., "mutual")` writes loads unchanged. The reference's
unused `category_embedding` is kept as a parameter for strict loading and never
touched in compute.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from difashion_tpu_torch.config import MutualEncoderConfig
from difashion_tpu_torch.nn.layers import Dense


class MutualEncoder(nn.Module):
    def __init__(self, config: MutualEncoderConfig):
        super().__init__()
        self.config = config
        flat = config.latent_channels * config.latent_size * config.latent_size
        if config.keep_unused_category_embedding:
            self.category_embedding = nn.Embedding(config.cate_num,
                                                   config.cate_emb_size)
        self.mlp = nn.Sequential(
            Dense(flat, config.hid_dim),
            nn.LeakyReLU(0.01),
            nn.Dropout(config.dropout),
            Dense(config.hid_dim, flat),
            nn.Tanh(),
        )

    def dropout_active(self, deterministic: Optional[bool] = None) -> bool:
        """Whether the dropout acts: unless `deterministic` (default: not
        in training mode), and only at a rate above 0."""
        if deterministic is None:
            deterministic = not self.training
        return not deterministic and self.mlp[2].p > 0

    def forward(self, mutual_emb: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None,
                dropout_u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mutual_emb [B, C, h, w] -> [B, C, h, w] in [-1, 1]. Dropout acts
        as `dropout_active` says; a unit is kept where its uniform draw is at
        least the rate: `dropout_u` [B, hid_dim], or drawn from `generator`
        (torch's default generator when None)."""
        lin0, act, drop, lin1, tanh = self.mlp
        b = mutual_emb.shape[0]
        x = act(lin0(mutual_emb.to(lin0.weight.dtype).reshape(b, -1)))
        if self.dropout_active(deterministic):
            # flax's Dropout: keep with probability 1 - p, scale kept values by 1/(1-p)
            if dropout_u is None:
                dropout_u = torch.rand(x.shape, generator=generator, device=x.device)
            keep = dropout_u >= drop.p
            x = torch.where(keep, x / (1.0 - drop.p), torch.zeros_like(x))
        return tanh(lin1(x)).reshape(mutual_emb.shape)

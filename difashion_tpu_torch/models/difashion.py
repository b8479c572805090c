"""The DiFashion bundle: UNet + VAE + CLIP text + MutualEncoder, with the noise
schedule. Counterpart of `difashion_tpu/models/difashion.py`.

The JAX package passes parameters beside its modules; here the towers are
`nn.Module`s that hold their own. The split stays the same: trainable
{unet, fashion_encoder}, frozen {vae, text_encoder}, and with SDXL's second
text tower (`ModelConfig.text_2`, the port's own) a frozen `text_encoder_2`
(None otherwise). Image and latent tensors are [B, C, H, W] by shape inside
the bundle, channels-last in memory in the UNet and the VAE.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from difashion_tpu_torch.config import ModelConfig
from difashion_tpu_torch.core import tracing
from difashion_tpu_torch.diffusion.schedule import DiffusionSchedule
from difashion_tpu_torch.models.clip_text import CLIPEncoderLayer, CLIPTextEncoder
from difashion_tpu_torch.models.mutual import MutualEncoder
from difashion_tpu_torch.models.unet import UNet2DCondition
from difashion_tpu_torch.models.vae import AutoencoderKL
from difashion_tpu_torch.nn.attention import CrossAttention, Transformer2D, VAEAttention
from difashion_tpu_torch.nn.layers import FeedForward, ResnetBlock2D

Device = Union[str, torch.device]

TRAINABLE = ("unet", "fashion_encoder")
FROZEN = ("vae", "text_encoder")


class DiFashion(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.unet = UNet2DCondition(config.unet)
        self.vae = AutoencoderKL(config.vae)
        self.text_encoder = CLIPTextEncoder(config.text)
        self.text_encoder_2 = (CLIPTextEncoder(config.text_2) if config.text_2 is not None
                               else None)
        self.fashion_encoder = MutualEncoder(config.mutual)
        self.schedule = DiffusionSchedule.create(config.scheduler)

    def prepare_for_training(self) -> "DiFashion":
        """The trainable/frozen split of the JAX package's
        `engine/train.py::split_params`: {unet, fashion_encoder} require grad
        and are in training mode (the MutualEncoder's dropout acts);
        {vae, text_encoder} (and text_encoder_2, where there is one) are
        frozen and stay in eval mode."""
        for name in TRAINABLE:
            getattr(self, name).train().requires_grad_(True)
        for name in FROZEN + ("text_encoder_2",):
            if getattr(self, name) is not None:
                getattr(self, name).eval().requires_grad_(False)
        return self

    def trainable_parameters(self) -> List[Tuple[str, nn.Parameter]]:
        """(name, parameter) of the trainable towers, names prefixed with the
        tower ("unet.conv_in.weight", "fashion_encoder.mlp.0.weight")."""
        return [(f"{tower}.{name}", p) for tower in TRAINABLE
                for name, p in getattr(self, tower).named_parameters()]

    def apply_unet(self, sample: torch.Tensor, timesteps: torch.Tensor,
                   encoder_hidden_states: torch.Tensor,
                   text_embeds: Optional[torch.Tensor] = None,
                   time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample [B, C_in, h, w] -> epsilon [B, C_out, h, w] in the UNet's
        dtype; SDXL's added conditioning: the pooled text embedding [B, P]
        and the time ids [B, 6]."""
        return self.unet(sample, timesteps, encoder_hidden_states, text_embeds, time_ids)

    def encode_images(self, images: torch.Tensor, sample: bool = False,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images [B, 3, H, W] in [-1, 1] -> scaled latents [B, C, h, w].
        `sample=True` draws from the posterior (its standard normal `eps`
        [B, C, h, w], or drawn from `generator`), otherwise its mode."""
        dist = self.vae.encode(images)
        z = dist.sample(generator, eps) if sample else dist.mode()
        return z * self.config.vae.scaling_factor

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """scaled latents [B, C, h, w] -> images [B, 3, H, W] in [-1, 1]."""
        return self.vae.decode(latents / self.config.vae.scaling_factor)

    def encode_text(self, input_ids: torch.Tensor, pooled: bool = False):
        """input_ids [B, 77] -> the UNet's context [B, 77, D]; with
        `pooled=True`, (context, pooled [B, P] or None). With a second text
        tower (SDXL) the context is both towers' contexts concatenated and
        the pooled embedding the second's."""
        with tracing.span("text.encode"):
            if self.text_encoder_2 is None:
                ctx, pool = self.text_encoder(input_ids), None
            else:
                ctx_2, pool = self.text_encoder_2(input_ids, pooled=True)
                ctx = torch.cat([self.text_encoder(input_ids), ctx_2], dim=-1)
        return (ctx, pool) if pooled else ctx

    def apply_mutual(self, mutual_emb: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     deterministic: Optional[bool] = None,
                     dropout_u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The MutualEncoder; its dropout acts in training mode unless
        `deterministic`, with its mask from `dropout_u` or drawn from
        `generator`."""
        return self.fashion_encoder(mutual_emb, generator, deterministic, dropout_u)


def _residual_branch_outputs(tower: nn.Module):
    """The layers whose output is added to a residual stream."""
    for m in tower.modules():
        if isinstance(m, ResnetBlock2D):
            yield m.conv2
        elif isinstance(m, (CrossAttention, VAEAttention)):
            yield m.to_out[0]
        elif isinstance(m, FeedForward):
            yield m.net[2]
        elif isinstance(m, Transformer2D):
            yield m.proj_out
        elif isinstance(m, CLIPEncoderLayer):
            yield m.self_attn.out_proj
            yield m.mlp.fc2


@torch.no_grad()
def _init_(model: DiFashion, generator: torch.Generator) -> None:
    """Seeded init: lecun-normal linears and convs with zero biases (flax's
    defaults), xavier-normal MutualEncoder linears, unit norms, N(0, 1)
    embeddings. In each tower the residual branches' output layers are scaled
    by 1/sqrt(their number), as GPT-2 scales its residual projections: at
    full depth an unscaled random network amplifies any bf16 rounding
    difference to a few percent of its output, which would drown the
    attention kernel's own error in the kernel-vs-plain comparison."""
    mutual_ids = {id(m) for m in model.fashion_encoder.modules()}
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            w = m.weight
            fan_in = w[0].numel()
            if id(m) in mutual_ids:
                std = math.sqrt(2.0 / (fan_in + w.shape[0]))
            else:
                std = 1.0 / math.sqrt(fan_in)
            # drawn in the logical order, so a channels-last weight holds the
            # same values as a contiguous one from the same seed
            w.copy_(torch.empty(w.shape, device=w.device, dtype=w.dtype).normal_(
                0.0, std, generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
    for tower in (model.unet, model.vae, model.text_encoder, model.text_encoder_2):
        if tower is None:
            continue
        outs = list(_residual_branch_outputs(tower))
        for m in outs:
            m.weight.mul_(1.0 / math.sqrt(len(outs)))


def create_difashion(config: ModelConfig, seed: int = 0, device: Device = "cuda",
                     dtype: torch.dtype = torch.float32) -> DiFashion:
    """All four towers with seeded random weights, built on `device` in
    `dtype`, in eval mode (dropout off). The weights are the port's own (a torch.Generator
    on `device` seeded with `seed`); load real ones with
    `weights.load_difashion`."""
    device = torch.device(device)
    with torch.device("meta"):
        model = DiFashion(config)
    model.to_empty(device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    _init_(model, generator)
    return model.to(dtype).eval()

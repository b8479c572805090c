"""The DiFashion bundle: UNet + VAE + CLIP text + MutualEncoder, with the noise
schedule. Counterpart of `difashion_tpu/models/difashion.py`.

The JAX package passes parameters beside its modules; here the towers are
`nn.Module`s that hold their own. The split stays the same: trainable
{unet, fashion_encoder}, frozen {vae, text_encoder}. Tensors are NCHW inside
the bundle.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from difashion_tpu_torch.config import ModelConfig
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
        self.fashion_encoder = MutualEncoder(config.mutual)
        self.schedule = DiffusionSchedule.create(config.scheduler)

    def prepare_for_training(self) -> "DiFashion":
        """The trainable/frozen split of the JAX package's
        `engine/train.py::split_params`: {unet, fashion_encoder} require grad
        and are in training mode (the MutualEncoder's dropout acts);
        {vae, text_encoder} are frozen and stay in eval mode."""
        for name in TRAINABLE:
            getattr(self, name).train().requires_grad_(True)
        for name in FROZEN:
            getattr(self, name).eval().requires_grad_(False)
        return self

    def trainable_parameters(self) -> List[Tuple[str, nn.Parameter]]:
        """(name, parameter) of the trainable towers, names prefixed with the
        tower ("unet.conv_in.weight", "fashion_encoder.mlp.0.weight")."""
        return [(f"{tower}.{name}", p) for tower in TRAINABLE
                for name, p in getattr(self, tower).named_parameters()]

    def apply_unet(self, sample: torch.Tensor, timesteps: torch.Tensor,
                   encoder_hidden_states: torch.Tensor,
                   plain_attention: bool = False) -> torch.Tensor:
        """sample [B, C_in, h, w] -> epsilon [B, C_out, h, w] in the UNet's dtype."""
        return self.unet(sample, timesteps, encoder_hidden_states,
                         plain_attention=plain_attention)

    def encode_images(self, images: torch.Tensor, sample: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images [B, 3, H, W] in [-1, 1] -> scaled latents [B, C, h, w].
        `sample=True` draws from the posterior, otherwise its mode."""
        dist = self.vae.encode(images)
        z = dist.sample(generator) if sample else dist.mode()
        return z * self.config.vae.scaling_factor

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """scaled latents [B, C, h, w] -> images [B, 3, H, W] in [-1, 1]."""
        return self.vae.decode(latents / self.config.vae.scaling_factor)

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(input_ids)

    def apply_mutual(self, mutual_emb: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     deterministic: Optional[bool] = None) -> torch.Tensor:
        """The MutualEncoder; its dropout acts in training mode unless
        `deterministic`, with its mask drawn from `generator`."""
        return self.fashion_encoder(mutual_emb, generator, deterministic)


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
            w.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
    for tower in (model.unet, model.vae, model.text_encoder):
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

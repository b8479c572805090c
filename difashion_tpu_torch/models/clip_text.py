"""CLIP text encoder (HF CLIPTextModel layout). Counterpart of
`difashion_tpu/models/clip_text.py`: token + position embeddings, pre-LN
layers with causal attention (plain torch, q scaled before the product),
LayerNorms in fp32, a final LayerNorm; returns the last hidden state.

SDXL's towers (the port's own): the context is the hidden state that
`CLIPTextConfig.context_hidden_state` names (-2: the penultimate layer's
output, before the final LayerNorm; the layers after it are not run unless
the pooled embedding is asked for), and with `projection_dim` the tower is
transformers' CLIPTextModelWithProjection: the pooled embedding is the
final-LayerNorm state at the EOS position (the largest id, as transformers
finds it for CLIP's original vocabulary), times `text_projection` (no
bias).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from difashion_tpu_torch.config import CLIPTextConfig
from difashion_tpu_torch.nn.layers import Dense


def _act(name: str):
    if name == "gelu":
        return F.gelu
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unknown activation {name!r}")


def _layer_norm_fp32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


class CLIPAttention(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        d = config.hidden_size
        self.q_proj = Dense(d, d)
        self.k_proj = Dense(d, d)
        self.v_proj = Dense(d, d)
        self.out_proj = Dense(d, d)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        split = lambda t: t.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)
        q = split(self.q_proj(x) * self.head_dim ** -0.5)
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        logits = torch.matmul(q, k.transpose(-1, -2))
        logits = logits.masked_fill(~causal_mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, s, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.fc1 = Dense(config.hidden_size, config.intermediate_size)
        self.fc2 = Dense(config.intermediate_size, config.hidden_size)
        self.act = _act(config.hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.self_attn = CLIPAttention(config)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.mlp = CLIPMLP(config)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        h = _layer_norm_fp32(self.layer_norm1, x).to(x.dtype)
        x = x + self.self_attn(h, causal_mask)
        h = _layer_norm_fp32(self.layer_norm2, x).to(x.dtype)
        return x + self.mlp(h)


class CLIPEmbeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position_embedding = nn.Embedding(config.max_position_embeddings,
                                               config.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(config) for _ in range(config.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(config)
        self.encoder = CLIPEncoder(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size,
                                             eps=config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, context_hidden_state: Optional[int] = None,
                pooled: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(context, the final-LayerNorm state at the EOS position or
        None): the context is the last hidden state after the final
        LayerNorm, or `hidden_states[context_hidden_state]` (0: the
        embeddings, i: the i-th layer's output)."""
        x = self.embeddings(input_ids)
        s = input_ids.shape[1]
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        n = len(self.encoder.layers)
        at = None if context_hidden_state is None else context_hidden_state % (n + 1)
        states = [x]
        for layer in self.encoder.layers[:n if pooled or at is None else at]:
            states.append(layer(states[-1], causal))
        ctx = None if at is None else states[at]
        if ctx is not None and not pooled:
            return ctx, None
        last = _layer_norm_fp32(self.final_layer_norm, states[-1]).to(x.dtype)
        eos = (last[torch.arange(last.shape[0], device=last.device), input_ids.argmax(-1)]
               if pooled else None)
        return (last if ctx is None else ctx), eos


class CLIPTextEncoder(nn.Module):
    """input_ids [B, S] int -> the context [B, S, hidden] (the last hidden
    state after the final LayerNorm, or the one `context_hidden_state`
    names); with `pooled=True`, (context, pooled [B, projection_dim or
    hidden])."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)
        if config.projection_dim is not None:
            self.text_projection = Dense(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor, pooled: bool = False):
        ctx, eos = self.text_model(input_ids, self.config.context_hidden_state, pooled)
        if not pooled:
            return ctx
        if self.config.projection_dim is not None:
            eos = self.text_projection(eos)
        return ctx, eos

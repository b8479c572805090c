"""The plain reference of DiFashion's four towers: the SD UNet with its
8-channel conv_in, the SD VAE, the CLIP text tower and the MutualEncoder.

Plain PyTorch in fp32, written from the published architectures (diffusers'
UNet2DConditionModel and AutoencoderKL, transformers' CLIPTextModel) and
DiFashion's MutualEncoder, with the diffusers / transformers parameter names,
so an HF-layout state dict loads with `load_state_dict(strict=True)`. No
kernel, no cache, no batching trick: convolutions, linear layers, GroupNorm,
LayerNorm and attention as matmul + softmax. It imports nothing of the
program under test.

Every matrix product (linear, convolution, the two products of attention)
reads its operands through `Precision.cast`: the identity in fp32, a round
trip through a lower precision for the control (`precision.py`).

A configuration is a plain dict (the `model` group of a configuration file
under `benchmark/configs/`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import FP32, Precision

# queries per attention block when no gradient is recorded: bounds the
# [B, H, q, Skv] logits of a 4096-token attention
_Q_BLOCK = 1024


class Linear(nn.Linear):
    def __init__(self, fan_in: int, fan_out: int, bias: bool = True,
                 prec: Precision = FP32):
        super().__init__(fan_in, fan_out, bias=bias)
        self.prec = prec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.prec.cast(x), self.prec.cast(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 padding: Optional[int] = None, prec: Precision = FP32):
        super().__init__(cin, cout, k, stride=stride,
                         padding=(k - 1) // 2 if padding is None else padding)
        self.prec = prec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(self.prec.cast(x), self.prec.cast(self.weight), self.bias)


def attention(q, k, v, prec: Precision):
    """softmax(q k^T / sqrt(d)) v over [B, H, S, D], in fp32; the queries in
    blocks when no gradient is recorded."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    k_t = prec.cast(k).transpose(-1, -2)
    v = prec.cast(v)
    step = q.shape[2] if torch.is_grad_enabled() else _Q_BLOCK
    outs = []
    for s in range(0, q.shape[2], step):
        logits = torch.matmul(prec.cast(q[:, :, s:s + step]), k_t) * scale
        outs.append(torch.matmul(prec.cast(torch.softmax(logits, dim=-1)), v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       shift: float = 0.0) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=t.device) / (half - shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    parts = [torch.cos(emb), torch.sin(emb)] if flip_sin_to_cos else [torch.sin(emb),
                                                                     torch.cos(emb)]
    emb = torch.cat(parts, dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


class GroupNorm(nn.GroupNorm):
    """GroupNorm (biased variance, affine), then SiLU when `silu`."""

    def __init__(self, groups: int, ch: int, eps: float, silu: bool = False):
        super().__init__(groups, ch, eps=eps)
        self.silu = silu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
        return F.silu(y) if self.silu else y


# ---------------------------------------------------------------- blocks --

class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb_ch, groups, eps, prec):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps, silu=True)
        self.conv1 = Conv2d(cin, cout, prec=prec)
        self.time_emb_proj = Linear(temb_ch, cout, prec=prec) if temb_ch else None
        self.norm2 = GroupNorm(groups, cout, eps, silu=True)
        self.conv2 = Conv2d(cout, cout, prec=prec)
        self.conv_shortcut = Conv2d(cin, cout, 1, prec=prec) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Downsample2D(nn.Module):
    def __init__(self, ch, prec):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=0, prec=prec)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, ch, prec):
        super().__init__()
        self.conv = Conv2d(ch, ch, prec=prec)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class CrossAttention(nn.Module):
    def __init__(self, dim, heads, head_dim, context_dim, prec):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.prec = heads, head_dim, prec
        self.to_q = Linear(dim, inner, bias=False, prec=prec)
        self.to_k = Linear(context_dim or dim, inner, bias=False, prec=prec)
        self.to_v = Linear(context_dim or dim, inner, bias=False, prec=prec)
        self.to_out = nn.ModuleList([Linear(inner, dim, prec=prec)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b = x.shape[0]
        split = lambda t: t.view(b, t.shape[1], self.heads, self.head_dim).transpose(1, 2)
        out = attention(split(self.to_q(x)), split(self.to_k(context)),
                        split(self.to_v(context)), self.prec)
        return self.to_out[0](out.transpose(1, 2).reshape(b, x.shape[1], -1))


class FeedForward(nn.Module):
    """GEGLU(d -> 4d, exact gelu) -> Linear(4d -> d); keys net.0.proj, net.2."""

    def __init__(self, dim, prec):
        super().__init__()
        self.net = nn.ModuleDict({"0": nn.Module(), "2": Linear(dim * 4, dim, prec=prec)})
        self.net["0"].proj = Linear(dim, dim * 8, prec=prec)

    def forward(self, x):
        h, gate = self.net["0"].proj(x).chunk(2, dim=-1)
        return self.net["2"](h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, head_dim, context_dim, prec):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, head_dim, None, prec)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim, prec)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, prec)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, heads, head_dim, ch, context_dim, linear_proj, groups, prec):
        super().__init__()
        inner = heads * head_dim
        self.linear_proj = linear_proj
        self.norm = GroupNorm(groups, ch, 1e-6)
        if linear_proj:
            self.proj_in = Linear(ch, inner, prec=prec)
            self.proj_out = Linear(inner, ch, prec=prec)
        else:
            self.proj_in = Conv2d(ch, inner, 1, prec=prec)
            self.proj_out = Conv2d(inner, ch, 1, prec=prec)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, head_dim, context_dim, prec)])

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if not self.linear_proj:
            h = self.proj_in(h)
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, h.shape[1])
        if self.linear_proj:
            h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, context)
        if self.linear_proj:
            h = self.proj_out(h)
        h = h.reshape(b, hh, ww, h.shape[-1]).permute(0, 3, 1, 2)
        if not self.linear_proj:
            h = self.proj_out(h)
        return x + h


class _Level(nn.Module):
    def __init__(self, resnets, attentions=(), down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])


# ------------------------------------------------------------------ UNet --

class UNet(nn.Module):
    """sample [B, 8, h, w], timesteps [B], context [B, 77, D] -> epsilon
    [B, 4, h, w]."""

    def __init__(self, cfg: dict, prec: Precision = FP32):
        super().__init__()
        self.cfg = cfg
        boc, g = list(cfg["block_out_channels"]), cfg["norm_num_groups"]
        temb = boc[0] * 4
        nlay = cfg["layers_per_block"]

        def spatial(ch):
            heads = cfg["fixed_num_heads"] or ch // cfg["attention_head_dim"]
            return Transformer2D(heads, ch // heads, ch, cfg["cross_attention_dim"],
                                 cfg["use_linear_projection"], g, prec)

        self.conv_in = Conv2d(cfg["in_channels"], boc[0], prec=prec)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Linear(boc[0], temb, prec=prec)
        self.time_embedding.linear_2 = Linear(temb, temb, prec=prec)
        ch, skips, down = boc[0], [boc[0]], []
        for bi, kind in enumerate(cfg["down_block_types"]):
            last = bi == len(boc) - 1
            res, att = [], []
            for _ in range(nlay):
                res.append(ResnetBlock2D(ch, boc[bi], temb, g, 1e-5, prec))
                ch = boc[bi]
                if kind == "CrossAttnDownBlock2D":
                    att.append(spatial(ch))
                skips.append(ch)
            down.append(_Level(res, att, down=None if last else Downsample2D(ch, prec)))
            if not last:
                skips.append(ch)
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Level([ResnetBlock2D(ch, ch, temb, g, 1e-5, prec) for _ in range(2)],
                                [spatial(ch)])
        up = []
        for bi, kind in enumerate(cfg["up_block_types"]):
            out = boc[::-1][bi]
            last = bi == len(boc) - 1
            res, att = [], []
            for _ in range(nlay + 1):
                res.append(ResnetBlock2D(ch + skips.pop(), out, temb, g, 1e-5, prec))
                ch = out
                if kind == "CrossAttnUpBlock2D":
                    att.append(spatial(ch))
            up.append(_Level(res, att, up=None if last else Upsample2D(ch, prec)))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(g, ch, 1e-5, silu=True)
        self.conv_out = Conv2d(ch, cfg["out_channels"], prec=prec)

    def forward(self, sample, timesteps, context):
        cfg = self.cfg
        t = timestep_embedding(timesteps, cfg["block_out_channels"][0],
                               cfg["flip_sin_to_cos"], cfg["freq_shift"])
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(t)))
        h = self.conv_in(sample)
        skips = [h]
        for block in self.down_blocks:
            for i, resnet in enumerate(block.resnets):
                h = resnet(h, temb)
                if len(block.attentions):
                    h = block.attentions[i](h, context)
                skips.append(h)
            for d in getattr(block, "downsamplers", ()):
                h = d(h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb), context), temb)
        for block in self.up_blocks:
            for i, resnet in enumerate(block.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    h = block.attentions[i](h, context)
            for u in getattr(block, "upsamplers", ()):
                h = u(h)
        return self.conv_out(self.conv_norm_out(h))


# ------------------------------------------------------------------- VAE --

class VAEAttention(nn.Module):
    def __init__(self, ch, groups, prec):
        super().__init__()
        self.prec = prec
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q = Linear(ch, ch, prec=prec)
        self.to_k = Linear(ch, ch, prec=prec)
        self.to_v = Linear(ch, ch, prec=prec)
        self.to_out = nn.ModuleList([Linear(ch, ch, prec=prec)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        out = attention(self.to_q(h)[:, None], self.to_k(h)[:, None],
                        self.to_v(h)[:, None], self.prec)[:, 0]
        return x + self.to_out[0](out).reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class _VAEMid(nn.Module):
    def __init__(self, ch, g, prec):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, None, g, 1e-6, prec)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, g, prec)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg, prec):
        super().__init__()
        g, boc = cfg["norm_num_groups"], list(cfg["block_out_channels"])
        self.conv_in = Conv2d(cfg["in_channels"], boc[0], prec=prec)
        ch, levels = boc[0], []
        for bi, out in enumerate(boc):
            res = []
            for _ in range(cfg["layers_per_block"]):
                res.append(ResnetBlock2D(ch, out, None, g, 1e-6, prec))
                ch = out
            levels.append(_Level(res, down=None if bi == len(boc) - 1
                                 else Downsample2D(ch, prec)))
        self.down_blocks = nn.ModuleList(levels)
        self.mid_block = _VAEMid(ch, g, prec)
        self.conv_norm_out = GroupNorm(g, ch, 1e-6, silu=True)
        self.conv_out = Conv2d(ch, 2 * cfg["latent_channels"], prec=prec)


class Decoder(nn.Module):
    def __init__(self, cfg, prec):
        super().__init__()
        g = cfg["norm_num_groups"]
        rev = list(cfg["block_out_channels"])[::-1]
        self.conv_in = Conv2d(cfg["latent_channels"], rev[0], prec=prec)
        self.mid_block = _VAEMid(rev[0], g, prec)
        ch, levels = rev[0], []
        for bi, out in enumerate(rev):
            res = []
            for _ in range(cfg["layers_per_block"] + 1):
                res.append(ResnetBlock2D(ch, out, None, g, 1e-6, prec))
                ch = out
            levels.append(_Level(res, up=None if bi == len(rev) - 1 else Upsample2D(ch, prec)))
        self.up_blocks = nn.ModuleList(levels)
        self.conv_norm_out = GroupNorm(g, ch, 1e-6, silu=True)
        self.conv_out = Conv2d(ch, cfg["out_channels"], prec=prec)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for level in self.up_blocks:
            for r in level.resnets:
                h = r(h)
            for u in getattr(level, "upsamplers", ()):
                h = u(h)
        return self.conv_out(self.conv_norm_out(h))


class VAE(nn.Module):
    """The decoder's forward; the encoder is held for its weights only (the
    benchmark's cells feed latents)."""

    def __init__(self, cfg: dict, prec: Precision = FP32):
        super().__init__()
        self.cfg = cfg
        lat = cfg["latent_channels"]
        self.encoder = Encoder(cfg, prec)
        self.decoder = Decoder(cfg, prec)
        self.quant_conv = Conv2d(2 * lat, 2 * lat, 1, prec=prec)
        self.post_quant_conv = Conv2d(lat, lat, 1, prec=prec)

    def decode(self, latents_scaled: torch.Tensor) -> torch.Tensor:
        """scaled latents [B, C, h, w] -> images [B, 3, H, W] in about [-1, 1]."""
        return self.decoder(self.post_quant_conv(latents_scaled / self.cfg["scaling_factor"]))


# ------------------------------------------------------------------ text --

class CLIPLayer(nn.Module):
    def __init__(self, cfg, prec):
        super().__init__()
        d = cfg["hidden_size"]
        self.heads, self.prec, self.act = cfg["num_heads"], prec, cfg["hidden_act"]
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg["layer_norm_eps"])
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg["layer_norm_eps"])
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, Linear(d, d, prec=prec))
        self.mlp = nn.Module()
        self.mlp.fc1 = Linear(d, cfg["intermediate_size"], prec=prec)
        self.mlp.fc2 = Linear(cfg["intermediate_size"], d, prec=prec)

    def forward(self, x, causal):
        b, s, d = x.shape
        a, hd = self.self_attn, d // self.heads
        split = lambda t: t.view(b, s, self.heads, hd).transpose(1, 2)
        h = self.layer_norm1(x)
        q, k, v = split(a.q_proj(h)), split(a.k_proj(h)), split(a.v_proj(h))
        logits = torch.matmul(self.prec.cast(q), self.prec.cast(k).transpose(-1, -2)) * hd ** -0.5
        w = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
        out = torch.matmul(self.prec.cast(w), self.prec.cast(v)).transpose(1, 2).reshape(b, s, d)
        x = x + a.out_proj(out)
        h = self.mlp.fc1(self.layer_norm2(x))
        h = F.gelu(h) if self.act == "gelu" else h * torch.sigmoid(1.702 * h)
        return x + self.mlp.fc2(h)


class CLIPText(nn.Module):
    """input_ids [B, S] -> last hidden state [B, S, D] after the final LayerNorm."""

    def __init__(self, cfg: dict, prec: Precision = FP32):
        super().__init__()
        d = cfg["hidden_size"]
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([CLIPLayer(cfg, prec)
                                           for _ in range(cfg["num_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=cfg["layer_norm_eps"])

    def forward(self, ids):
        tm, s = self.text_model, ids.shape[1]
        pos = torch.arange(s, device=ids.device)
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(pos)[None]
        causal = torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x)


# ---------------------------------------------------------------- mutual --

class Mutual(nn.Module):
    """Linear(C*h*w -> hid) -> LeakyReLU(0.01) -> dropout -> Linear -> tanh,
    over NCHW-flattened latents; `category_embedding` is held, never used."""

    def __init__(self, cfg: dict, prec: Precision = FP32):
        super().__init__()
        flat = cfg["latent_channels"] * cfg["latent_size"] ** 2
        self.rate = cfg["dropout"]
        self.category_embedding = nn.Embedding(cfg["cate_num"], cfg["cate_emb_size"])
        self.mlp = nn.ModuleDict({"0": Linear(flat, cfg["hid_dim"], prec=prec),
                                  "3": Linear(cfg["hid_dim"], flat, prec=prec)})

    def forward(self, x, dropout_u=None):
        """x [B, C, h, w]; dropout acts where `dropout_u` [B, hid] is given:
        a unit is kept where its draw is at least the rate, scaled by
        1 / (1 - rate)."""
        h = F.leaky_relu(self.mlp["0"](x.reshape(x.shape[0], -1)), 0.01)
        if dropout_u is not None:
            h = torch.where(dropout_u >= self.rate, h / (1.0 - self.rate), torch.zeros_like(h))
        return torch.tanh(self.mlp["3"](h)).reshape(x.shape)


TOWERS = {"unet": (UNet, "unet"), "vae": (VAE, "vae"), "text_encoder": (CLIPText, "text"),
          "fashion_encoder": (Mutual, "mutual")}


def build_tower(name: str, model_cfg: dict, prec: Precision = FP32,
                device="meta") -> nn.Module:
    """One tower (a key of TOWERS) of the configuration's `model` group,
    with uninitialised parameters on `device`."""
    cls, key = TOWERS[name]
    with torch.device(device):
        return cls(model_cfg[key], prec)


def residual_outputs(tower: nn.Module):
    """The names of the layers whose output is added to a residual stream."""
    for name, m in tower.named_modules():
        if isinstance(m, ResnetBlock2D):
            yield f"{name}.conv2"
        elif isinstance(m, (CrossAttention, VAEAttention)):
            yield f"{name}.to_out.0"
        elif isinstance(m, FeedForward):
            yield f"{name}.net.2"
        elif isinstance(m, Transformer2D):
            yield f"{name}.proj_out"
        elif isinstance(m, CLIPLayer):
            yield f"{name}.self_attn.out_proj"
            yield f"{name}.mlp.fc2"

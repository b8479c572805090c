"""The plain reference of DiFashion on the SDXL base architecture: the SDXL
UNet (three levels, per-level transformer depth, the added time / text
conditioning) with DiFashion's 8-channel conv_in, the two text towers, and
GOR generation through them.

Plain PyTorch in fp32, written from the published description
(stabilityai/stable-diffusion-xl-base-1.0: diffusers' UNet2DConditionModel
at `unet/config.json`, transformers' CLIPTextModel at
`text_encoder/config.json` and CLIPTextModelWithProjection at
`text_encoder_2/config.json`, AutoencoderKL at `vae/config.json`) with the
diffusers / transformers parameter names, so an HF-layout state dict loads
with `load_state_dict(strict=True)`. The building blocks that SD and SDXL
share (ResNet blocks, BasicTransformerBlock, the VAE, the CLIP layer, the
MutualEncoder, PLMS, the uint8 decode) are `models.py`'s and `sampling.py`'s.
It imports nothing of the program under test.

The layer equations:
  * UNet: conv_in; the time embedding (the 320-wide sinusoid of the
    timestep, Linear, SiLU, Linear to 1280) plus the added embedding: each
    of the six time ids through a 256-wide sinusoid (cos first, shift 0),
    concatenated after the pooled text embedding (1280 + 6 x 256 = 2816),
    Linear, SiLU, Linear to 1280. Levels (320, 640, 1280): DownBlock2D, then
    two CrossAttnDownBlock2D whose Transformer2D hold 2 and 10
    BasicTransformerBlocks; the mid block's Transformer2D holds 10; the up
    blocks mirror the levels (10, 10, 10 blocks at 1280; 2, 2, 2 at 640;
    none at 320): 70 blocks a forward. Heads: channels // attention_head_dim
    (5, 10, 20 per level), d = 64. Linear projections in and out of every Transformer2D.
  * Text: each tower's context is `hidden_states[-2]`, the penultimate
    layer's output before the final LayerNorm; the UNet's context is the two
    concatenated (768 + 1280 = 2048). The pooled embedding is tower 2's
    final-LayerNorm output at the EOS position (the largest token id),
    times `text_projection` (no bias).
  * Generation: `sampling.generate_outfits`' GOR with the added
    conditioning: every row's time ids (height, width, 0, 0, height,
    width), and the pooled embedding selected per CFG branch as the context
    is.

Departures from the published description, each DiFashion's or the
benchmark's:
  * conv_in takes 8 channels (the noisy latent and the history latent);
  * the null branch's context and pooled embedding are the encoded empty
    prompt (DiFashion's null condition), not the SDXL pipeline's zeros;
  * PLMS (PNDM with skip_prk_steps) over the published betas, in place of
    the published Euler scheduler;
  * one hash tokenizer's ids feed both towers (no tokenizer files); tower
    2's padding is 0 as the published tokenizer_2's, tower 1's too;
  * the stride-2 downsampling convolutions pad (0, 1, 0, 1), as
    `models.Downsample2D` does for the SD cells.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import models as ref
from benchmark.reference.precision import FP32, Precision
from benchmark.reference.sampling import decode_uint8, guidance_weights, plms_plan


class Transformer2D(ref.Transformer2D):
    """`models.Transformer2D` with `depth` BasicTransformerBlocks and linear
    projections."""

    def __init__(self, heads, head_dim, ch, depth, context_dim, groups, prec):
        super().__init__(heads, head_dim, ch, context_dim, True, groups, prec)
        self.transformer_blocks = nn.ModuleList(
            [ref.BasicTransformerBlock(heads * head_dim, heads, head_dim, context_dim, prec)
             for _ in range(depth)])


def level_depth(cfg: dict, level: int) -> int:
    d = cfg.get("transformer_layers_per_block", 1)
    return d if isinstance(d, int) else d[level]


def transformer_blocks_per_forward(cfg: dict) -> int:
    """BasicTransformerBlocks a forward of the UNet of `cfg` (a
    configuration's `unet` group, SD or SDXL) runs."""
    n, lay = len(cfg["block_out_channels"]), cfg["layers_per_block"]
    down = sum(lay * level_depth(cfg, i) for i, k in enumerate(cfg["down_block_types"])
               if k.startswith("CrossAttn"))
    up = sum((lay + 1) * level_depth(cfg, n - 1 - i) for i, k in enumerate(cfg["up_block_types"])
             if k.startswith("CrossAttn"))
    return down + level_depth(cfg, n - 1) + up


class UNet(nn.Module):
    """sample [B, 8, h, w], timesteps [B], context [B, 77, 2048], pooled
    text [B, 1280], time ids [B, 6] -> epsilon [B, 4, h, w]."""

    def __init__(self, cfg: dict, prec: Precision = FP32):
        super().__init__()
        if cfg["addition_embed_type"] != "text_time":
            raise ValueError("the SDXL reference holds the text_time added conditioning only")
        self.cfg = cfg
        boc, g, nlay = list(cfg["block_out_channels"]), cfg["norm_num_groups"], \
            cfg["layers_per_block"]
        temb = boc[0] * 4

        def spatial(ch, level):
            heads = ch // cfg["attention_head_dim"]
            return Transformer2D(heads, ch // heads, ch, level_depth(cfg, level),
                                 cfg["cross_attention_dim"], g, prec)

        self.conv_in = ref.Conv2d(cfg["in_channels"], boc[0], prec=prec)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = ref.Linear(boc[0], temb, prec=prec)
        self.time_embedding.linear_2 = ref.Linear(temb, temb, prec=prec)
        self.add_embedding = nn.Module()
        self.add_embedding.linear_1 = ref.Linear(cfg["projection_class_embeddings_input_dim"],
                                                 temb, prec=prec)
        self.add_embedding.linear_2 = ref.Linear(temb, temb, prec=prec)
        ch, skips, down = boc[0], [boc[0]], []
        for bi, kind in enumerate(cfg["down_block_types"]):
            last = bi == len(boc) - 1
            res, att = [], []
            for _ in range(nlay):
                res.append(ref.ResnetBlock2D(ch, boc[bi], temb, g, 1e-5, prec))
                ch = boc[bi]
                if kind == "CrossAttnDownBlock2D":
                    att.append(spatial(ch, bi))
                skips.append(ch)
            down.append(ref._Level(res, att, down=None if last else ref.Downsample2D(ch, prec)))
            if not last:
                skips.append(ch)
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = ref._Level(
            [ref.ResnetBlock2D(ch, ch, temb, g, 1e-5, prec) for _ in range(2)],
            [spatial(ch, len(boc) - 1)])
        up = []
        for bi, kind in enumerate(cfg["up_block_types"]):
            level = len(boc) - 1 - bi
            res, att = [], []
            for _ in range(nlay + 1):
                res.append(ref.ResnetBlock2D(ch + skips.pop(), boc[level], temb, g, 1e-5, prec))
                ch = boc[level]
                if kind == "CrossAttnUpBlock2D":
                    att.append(spatial(ch, level))
            up.append(ref._Level(res, att, up=None if level == 0 else ref.Upsample2D(ch, prec)))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = ref.GroupNorm(g, ch, 1e-5, silu=True)
        self.conv_out = ref.Conv2d(ch, cfg["out_channels"], prec=prec)

    def forward(self, sample, timesteps, context, text_embeds, time_ids):
        cfg = self.cfg
        flip, shift = cfg["flip_sin_to_cos"], cfg["freq_shift"]
        t = ref.timestep_embedding(timesteps, cfg["block_out_channels"][0], flip, shift)
        te, ae = self.time_embedding, self.add_embedding
        temb = te.linear_2(F.silu(te.linear_1(t)))
        ids = ref.timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"],
                                     flip, shift).reshape(time_ids.shape[0], -1)
        temb = temb + ae.linear_2(F.silu(ae.linear_1(torch.cat([text_embeds, ids], dim=-1))))
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


class CLIPText(ref.CLIPText):
    """input_ids [B, S] -> (hidden_states[context_hidden_state] [B, S, D],
    pooled [B, projection_dim]): every layer is run; the pooled output is
    the final LayerNorm's state at the EOS position (the largest id), times
    `text_projection` where the tower has one (else that state)."""

    def __init__(self, cfg: dict, prec: Precision = FP32):
        super().__init__(cfg, prec)
        self.cfg = cfg
        if cfg.get("projection_dim") is not None:
            self.text_projection = ref.Linear(cfg["hidden_size"], cfg["projection_dim"],
                                              bias=False, prec=prec)

    def forward(self, ids):
        tm, s = self.text_model, ids.shape[1]
        pos = torch.arange(s, device=ids.device)
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(pos)[None]
        causal = torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()
        states = [x]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
            states.append(x)
        last = tm.final_layer_norm(x)
        pooled = last[torch.arange(ids.shape[0], device=ids.device), ids.argmax(-1)]
        if hasattr(self, "text_projection"):
            pooled = self.text_projection(pooled)
        return states[self.cfg["context_hidden_state"]], pooled


TOWERS = {"unet": (UNet, "unet"), "vae": (ref.VAE, "vae"), "text_encoder": (CLIPText, "text"),
          "text_encoder_2": (CLIPText, "text_2"), "fashion_encoder": (ref.Mutual, "mutual")}


def build_tower(name: str, model_cfg: dict, prec: Precision = FP32,
                device="meta") -> nn.Module:
    """One tower (a key of TOWERS) of the configuration's `model` group,
    with uninitialised parameters on `device`."""
    cls, key = TOWERS[name]
    with torch.device(device):
        return cls(model_cfg[key], prec)


residual_outputs = ref.residual_outputs


def encode_text(towers: Dict[str, nn.Module], ids: torch.Tensor):
    """(context [B, 77, 2048], pooled [B, 1280]) of token ids [B, 77]."""
    ctx_1, _ = towers["text_encoder"](ids)
    ctx_2, pooled = towers["text_encoder_2"](ids)
    return torch.cat([ctx_1, ctx_2], dim=-1), pooled


@torch.no_grad()
def generate_outfits(towers: Dict[str, nn.Module], model_cfg: dict, gen: dict,
                     cate_ids: np.ndarray, null_ids: np.ndarray, hist: np.ndarray,
                     init: np.ndarray, outfits: List[List[int]], null_latent: np.ndarray,
                     device) -> np.ndarray:
    """GOR: every fill of each outfit (lists of fill indices) generated
    jointly, as `sampling.generate_outfits` with the added conditioning.
    cate_ids [F, 77] the fills' prompts; null_ids [77] the empty prompt;
    hist and init [F, h, w, C] (NHWC); null_latent [h, w, C]. Returns uint8
    images [F, H, W, 3]."""
    unet, mutual = towers["unet"], towers["fashion_encoder"]
    f32 = torch.float32
    dev = lambda a, dt=f32: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)
    nchw = lambda a: dev(a).permute(0, 3, 1, 2)
    F_ = len(init)
    cate, cate_pool = encode_text(towers, dev(cate_ids, torch.long))    # [F, 77, D], [F, P]
    null_t, null_pool = encode_text(towers, dev(null_ids[None], torch.long))
    null_l = dev(null_latent).permute(2, 0, 1)[None]                      # [1, C, h, w]
    hist_t = nchw(hist)
    lat = nchw(init)
    w = guidance_weights(gen["category_guidance_scale"], gen["hist_guidance_scale"],
                         gen["mutual_guidance_scale"])
    eta = gen["eta"]
    # branches: hist real only in 0; mutual real in 0, 1; text real in 0, 1, 2
    hist_b = torch.cat([hist_t] + [null_l.expand_as(hist_t)] * 3)
    text_b = torch.cat([cate, cate, cate, null_t.expand_as(cate)])
    pool_b = torch.cat([cate_pool, cate_pool, cate_pool, null_pool.expand_as(cate_pool)])
    size = [gen["height"], gen["width"], 0, 0, gen["height"], gen["width"]]
    time_ids = torch.tensor([size] * (4 * F_), dtype=f32, device=lat.device)
    rows = plms_plan(model_cfg["scheduler"], gen["num_inference_steps"])
    ets, cur = [], None
    for i, r in enumerate(rows):
        total = torch.zeros_like(lat)
        for members in outfits:
            total[members] = lat[members].sum(0, keepdim=True)
        m = mutual(total - lat)
        null_e = null_l.expand_as(lat)
        x = torch.cat([(1 - eta) * lat + eta * mb for mb in (m, m, null_e, null_e)])
        t = torch.full((4 * F_,), r["t"], dtype=torch.long, device=lat.device)
        eps = unet(torch.cat([x, hist_b], dim=1), t, text_b, pool_b, time_ids)
        eps = sum(wi * e for wi, e in zip(w, eps.reshape((4, F_) + lat.shape[1:])))
        # PLMS: iteration 0 stores e0 and the sample; 1 is the corrector
        if i != 1:
            ets = [eps] + ets[:3]
        if i == 0:
            cur = lat
        sample = cur if i == 1 else lat
        combo = r["cm"] * eps + sum(c * e for c, e in zip(r["coeffs"], ets))
        a_t, a_p = r["a_t"], r["a_prev"]
        denom = a_t * (1 - a_p) ** 0.5 + (a_t * (1 - a_t) * a_p) ** 0.5
        lat = (a_p / a_t) ** 0.5 * sample - ((a_p - a_t) / denom) * combo
    return decode_uint8(towers["vae"], lat)

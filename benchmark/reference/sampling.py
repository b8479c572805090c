"""The plain reference of DiFashion's generation: the category prompts and
their token ids, the initial noise of each fill, the SD noise schedule, PLMS
(PNDM with skip_prk_steps) under the 4-branch guidance with the mutual
condition, and the VAE decode to uint8 images.

Written from the published algorithms (diffusers' PNDMScheduler with
"leading" spacing, DiFashion's guidance and mutual condition) in plain
PyTorch and NumPy. The rules by which the program derives its inputs from
the benchmark's data (the prompt of a category, its token ids under the hash
tokenizer stand-in, the noise of a fill) are worked out again here; nothing
is taken from the program's run.
"""
from __future__ import annotations

import hashlib
import re
import struct
from typing import Dict, List, Sequence

import numpy as np
import torch

MAX_LEN = 77
TRAIN_SPECIAL = ("pants", "earrings")


def train_prompt(category: str) -> str:
    pair = "a pair of " if any(s in category for s in TRAIN_SPECIAL) else "a "
    return "A photo of " + pair + category + ", on white background, high quality"


def hash_token_ids(texts: Sequence[str], vocab_size: int = 49408, pad_id: int = 0
                   ) -> np.ndarray:
    """[len(texts), 77] int32: BOS, an FNV-1a id per lowercased word, EOS,
    padding: the CLIP sequence contract of the hash tokenizer stand-in."""
    bos, eos = vocab_size - 2, vocab_size - 1
    out = np.full((len(texts), MAX_LEN), pad_id, np.int32)
    for i, text in enumerate(texts):
        ids = [bos]
        for word in re.sub(r"\s+", " ", text).strip().lower().split(" "):
            if not word:
                continue
            h = 2166136261
            for ch in word.encode("utf-8"):
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(h % (vocab_size - 3) + 1)
        ids.append(eos)
        if len(ids) > MAX_LEN:
            ids = ids[:MAX_LEN - 1] + [eos]
        out[i, :len(ids)] = ids
    return out


def fill_noise(seed: int, ident: Sequence[int], shape) -> np.ndarray:
    """N(0, 1) [*shape] float32 of one fill (uid, oid, slot): a CPU
    generator seeded by the 63-bit blake2b hash of (seed, uid, oid, slot)."""
    key = struct.pack("<4q", seed, *(int(i) for i in ident))
    digest = hashlib.blake2b(key, digest_size=8).digest()
    g = torch.Generator().manual_seed(int.from_bytes(digest, "little") >> 1)
    return torch.randn(tuple(shape), generator=g).numpy()


def alphas_cumprod(sched: dict) -> np.ndarray:
    """The "scaled_linear" schedule's cumulative alphas, float32."""
    if sched["beta_schedule"] != "scaled_linear":
        raise ValueError("the reference holds the scaled_linear schedule only")
    betas = (np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5,
                         sched["num_train_timesteps"], dtype=np.float64) ** 2).astype(np.float32)
    return np.cumprod(1.0 - betas).astype(np.float32)


def plms_plan(sched: dict, steps: int) -> List[dict]:
    """Per iteration (steps + 1 of them): the UNet's timestep, the cumulative
    alphas of the current and previous timestep, the multistep coefficients
    (newest first) and the corrector's rules."""
    T = sched["num_train_timesteps"]
    ratio = T // steps
    acp = alphas_cumprod(sched)
    final = 1.0 if sched["set_alpha_to_one"] else float(acp[0])
    base = (np.arange(steps) * ratio).round().astype(np.int64) + sched["steps_offset"]
    seq = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
    ab = {2: [1.5, -0.5], 3: [23 / 12, -16 / 12, 5 / 12],
          4: [55 / 24, -59 / 24, 37 / 24, -9 / 24]}
    rows = []
    for i, t in enumerate(int(s) for s in seq):
        prev = t - ratio
        if i == 1:
            t, prev = t + ratio, t
        coeffs = [1.0] if i == 0 else [0.5] if i == 1 else ab[min(i, 4)]
        rows.append({"t": int(seq[i]),
                     "a_t": float(np.float32(acp[t] if t >= 0 else final)),
                     "a_prev": float(np.float32(acp[prev] if prev >= 0 else final)),
                     "coeffs": [float(np.float32(c)) for c in coeffs],
                     "cm": 0.5 if i == 1 else 0.0})
    return rows


def guidance_weights(category: float, hist: float, mutual: float) -> List[float]:
    """Combine weights of the 4 branches [all conditions, category + mutual,
    category, none]."""
    return [float(np.float32(w)) for w in (hist, mutual - hist, category - mutual,
                                           1.0 - category)]


@torch.no_grad()
def generate_outfits(towers: Dict[str, torch.nn.Module], model_cfg: dict, gen: dict,
                     cate_ids: np.ndarray, null_ids: np.ndarray, hist: np.ndarray,
                     init: np.ndarray, outfits: List[List[int]], null_latent: np.ndarray,
                     device) -> np.ndarray:
    """GOR: every fill of each outfit (lists of fill indices) generated
    jointly. cate_ids [F, 77] the fills' prompts; null_ids [77] the empty
    prompt; hist and init [F, h, w, C] (NHWC); null_latent [h, w, C].
    Returns uint8 images [F, H, W, 3]."""
    unet, mutual, text = towers["unet"], towers["fashion_encoder"], towers["text_encoder"]
    f32 = torch.float32
    dev = lambda a, dt=f32: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)
    nchw = lambda a: dev(a).permute(0, 3, 1, 2)
    F_ = len(init)
    cate = text(dev(cate_ids, torch.long))                            # [F, 77, D]
    null_t = text(dev(null_ids[None], torch.long))[0]
    null_l = dev(null_latent).permute(2, 0, 1)[None]                  # [1, C, h, w]
    hist_t = nchw(hist)
    lat = nchw(init)
    w = guidance_weights(gen["category_guidance_scale"], gen["hist_guidance_scale"],
                         gen["mutual_guidance_scale"])
    eta = gen["eta"]
    # branches: hist real only in 0; mutual real in 0, 1; text real in 0, 1, 2
    hist_b = torch.cat([hist_t] + [null_l.expand_as(hist_t)] * 3)
    text_b = torch.cat([cate, cate, cate, null_t[None].expand_as(cate)])
    rows = plms_plan(model_cfg["scheduler"], gen["num_inference_steps"])
    ets, cur = [], None
    for i, r in enumerate(rows):
        total = torch.zeros_like(lat)
        for members in outfits:
            s = lat[members].sum(0, keepdim=True)
            total[members] = s
        m = mutual(total - lat)
        null_e = null_l.expand_as(lat)
        x = torch.cat([(1 - eta) * lat + eta * mb for mb in (m, m, null_e, null_e)])
        t = torch.full((4 * F_,), r["t"], dtype=torch.long, device=lat.device)
        eps = unet(torch.cat([x, hist_b], dim=1), t, text_b).reshape((4, F_) + lat.shape[1:])
        eps = sum(wi * e for wi, e in zip(w, eps))
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


@torch.no_grad()
def decode_uint8(vae, latents_nchw: torch.Tensor) -> np.ndarray:
    """scaled latents -> uint8 [F, H, W, 3]: [-1, 1] to [0, 1], clip, scale
    by 255, + 0.5, clip, truncate."""
    out = []
    for i in range(latents_nchw.shape[0]):   # an image at a time bounds memory
        img = vae.decode(latents_nchw[i:i + 1]).permute(0, 2, 3, 1)
        img = (img / 2.0 + 0.5).clamp(0.0, 1.0)
        out.append((img * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8).cpu().numpy())
    return np.concatenate(out)

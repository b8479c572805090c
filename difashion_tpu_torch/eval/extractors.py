"""The evaluation towers behind batched extract functions. Counterpart of
`difashion_tpu/eval/extractors.py`: OpenCLIP ViT-H/14 (image and text),
the FID Inception, the finetuned 50-class Inception, LPIPS-VGG16 and the
compatibility net, built once per run on one device, in fp32.

Weights come from `weights_dir`, under the JAX package's file names:

    open_clip_vit_h14.(safetensors|pth|bin|pt)   open_clip's CLIP state dict
    fid_inception.*                               pytorch_fid's InceptionV3
    finetuned_inception.*                         torchvision InceptionV3, 50-class fc
    vgg16.*                                       torchvision vgg16
    lpips_vgg.*                                   lpips' linear heads
    {ifashion|polyvore|compat}_evaluator.*        the compatibility net
    tokenizer/{vocab.json,merges.txt}             the CLIP BPE

Each tower's parameters carry its source checkpoint's names and layouts, so
a file loads with `load_state_dict(strict=True)` after the entries no tower
has are left out: open_clip's `logit_scale`, torchvision Inception's
`AuxLogits.*` (and a `model.` prefix), the FID tower's `fc.*`, vgg16's
`classifier.*`. A tower without a file keeps seeded random weights and is
named in `random_towers`; `allow_random=False` refuses instead.

The wrappers take host numpy in [0, 1] ([N, H, W, 3], the JAX package's
layout) and return numpy; the resize, the normalization and the towers run
on the device, batch by batch, under `torch.inference_mode()`. The resizes
antialias when they shrink, as `jax.image.resize` does.
"""
from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from difashion_tpu_torch.eval.models.compat import FashionEvaluator, init_fashion_evaluator
from difashion_tpu_torch.eval.models.inception import InceptionV3, init_inception
from difashion_tpu_torch.eval.models.lpips import LPIPS, init_lpips
from difashion_tpu_torch.eval.models.open_clip_vit import (
    OpenCLIP,
    TextConfig,
    ViTConfig,
    _device_images,
    init_open_clip,
    preprocess_clip_image,
)

log = logging.getLogger("difashion_tpu_torch")

WEIGHT_EXTS = (".safetensors", ".pth", ".bin", ".pt")
COMPAT_FILES = ("ifashion_evaluator", "polyvore_evaluator", "compat_evaluator")


def _resize_bilinear(images01, size: int, device="cpu") -> torch.Tensor:
    """[N, H, W, 3] in [0, 1] -> [N, 3, size, size] fp32 on `device`: a
    bilinear resize (align_corners=False, antialiased when shrinking, as
    `jax.image.resize`); unchanged when already size x size."""
    x = _device_images(images01, device)
    if x.shape[2] == size and x.shape[3] == size:
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


@dataclass
class Extractors:
    """Every evaluation tower; built once per evaluation run."""

    clip: OpenCLIP                   # image [N,3,224,224] / ids [N,77] -> [N,1024]
    fid_inception: InceptionV3       # [N,3,299,299] in [-1,1] -> [N,2048]
    inception: InceptionV3           # [N,3,299,299] in [-1,1] -> [N,50] softmax
    lpips_net: LPIPS                 # two [N,3,H,W] in [-1,1] -> [N]
    compat: FashionEvaluator         # [N,4,1024] -> [N] logits
    clip_tokenizer: object           # texts -> [N,77] ids
    device: torch.device
    batch_size: int = 32
    clip_size: int = 224
    random_towers: tuple = ()        # towers left at random init (no weights found)
    # the reference's resolutions (299 for both Inceptions, LPIPS at the
    # images' own); tiny mode shrinks them to 75 / 64, as the JAX package does
    fid_size: int = 299
    lpips_size: Optional[int] = None

    def _batches(self, n: int):
        for s in range(0, n, self.batch_size):
            yield slice(s, min(s + self.batch_size, n))

    @torch.inference_mode()
    def clip_image_embs(self, images01: np.ndarray) -> np.ndarray:
        """[N,H,W,3] in [0,1] -> [N,1024] (open_clip's preprocessing applied)."""
        return np.concatenate([
            self.clip.encode_image(preprocess_clip_image(
                images01[sl], self.clip_size, self.device)).cpu().numpy()
            for sl in self._batches(len(images01))])

    @torch.inference_mode()
    def clip_text_embs(self, texts: Sequence[str]) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(self.clip_tokenizer(list(texts))), dtype=torch.long)
        return np.concatenate([self.clip.encode_text(ids[sl].to(self.device)).cpu().numpy()
                               for sl in self._batches(len(ids))])

    def _inception(self, tower, images01):
        with torch.inference_mode():
            return np.concatenate([
                tower(_resize_bilinear(images01[sl], self.fid_size, self.device) * 2.0 - 1.0)
                .cpu().numpy() for sl in self._batches(len(images01))])

    def fid_features(self, images01: np.ndarray) -> np.ndarray:
        return self._inception(self.fid_inception, images01)

    def inception_probs(self, images01: np.ndarray) -> np.ndarray:
        return self._inception(self.inception, images01)

    @torch.inference_mode()
    def lpips(self, imgs0_01: np.ndarray, imgs1_01: np.ndarray) -> np.ndarray:
        out = []
        for sl in self._batches(len(imgs0_01)):
            # each input resized on its own shape, so that mixed resolutions
            # cannot skip one leg
            a, b = ((_resize_bilinear(x[sl], self.lpips_size, self.device) if self.lpips_size
                     else _device_images(x[sl], self.device)) for x in (imgs0_01, imgs1_01))
            out.append(self.lpips_net(a * 2.0 - 1.0, b * 2.0 - 1.0).cpu().numpy())
        return np.concatenate(out)

    @torch.inference_mode()
    def compat_scores(self, outfit_feats: np.ndarray) -> np.ndarray:
        """[N,4,1024] -> sigmoid scores [N]."""
        x = torch.as_tensor(np.asarray(outfit_feats, np.float32))
        logits = np.concatenate([self.compat(x[sl].to(self.device)).cpu().numpy()
                                 for sl in self._batches(len(x))])
        return 1.0 / (1.0 + np.exp(-logits))


# ---- weights -----------------------------------------------------------------

def _find(weights_dir: Optional[str], name: str) -> Optional[str]:
    if weights_dir is None:
        return None
    for ext in WEIGHT_EXTS:
        p = os.path.join(weights_dir, name + ext)
        if os.path.exists(p):
            return p
    return None


def open_clip_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in sd.items() if k != "logit_scale"}


def inception_state(sd: Dict[str, torch.Tensor], head: bool) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        k = k[len("model."):] if k.startswith("model.") else k
        if k.startswith("AuxLogits.") or (not head and k.startswith("fc.")):
            continue
        out[k] = v
    return out


def vgg16_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in sd.items() if k.startswith("features.")}


def lpips_heads_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """lpips' `lin{i}.model.1.weight` (or `lins.{i}.`), the heads only."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^lins\.(\d+)\.", r"lin\1.", k)
        if re.match(r"^lin\d\.model\.1\.weight$", k):
            out[k] = v
    return out


def build_towers(tiny: bool = False, seed: int = 0, num_classes: int = 50, device="cuda"):
    """(OpenCLIP, FID Inception, finetuned Inception, LPIPS, compat net):
    every tower with seeded random weights on `device` in fp32 (the ViT-H/14
    widths, or the tiny ones)."""
    vcfg = ViTConfig.tiny() if tiny else ViTConfig.h14()
    tcfg = TextConfig.tiny() if tiny else TextConfig.h14()
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        return (init_open_clip(OpenCLIP(vcfg, tcfg), gen).eval(),
                init_inception(InceptionV3(fid=True), gen),
                init_inception(InceptionV3(num_classes=num_classes, transform_input=True), gen),
                init_lpips(LPIPS(), gen),
                init_fashion_evaluator(FashionEvaluator(vcfg.embed_dim), gen))


def build_extractors(weights_dir: Optional[str] = None, num_classes: int = 50,
                     batch_size: int = 32, tiny: bool = False, seed: int = 0,
                     allow_random: bool = True, device="cuda") -> Extractors:
    """Build every tower on `device` in fp32 and load what `weights_dir`
    holds (the module docstring lists the files). Missing files leave that
    tower at seeded random weights, which are fine for tests and throughput
    and meaningless for quality numbers: `allow_random=False` (the
    quality-facing commands) refuses instead, and `random_towers` records
    them either way."""
    from difashion_tpu_torch.core.importer import load_state_dict
    from difashion_tpu_torch.data.tokenizer import load_tokenizer

    device = torch.device(device)
    vcfg = ViTConfig.tiny() if tiny else ViTConfig.h14()
    tcfg = TextConfig.tiny() if tiny else TextConfig.h14()
    clip, fid, cls, lp, compat = build_towers(tiny, seed, num_classes, device)

    def load(tower, name, prepare):
        path = _find(weights_dir, name)
        if path is None:
            return False
        tower.load_state_dict(prepare(load_state_dict(path)), strict=True)
        log.info("eval tower %s: loaded %s", name, path)
        return True

    random_towers = [name for tower, name, prepare in (
        (clip, "open_clip_vit_h14", open_clip_state),
        (fid, "fid_inception", lambda sd: inception_state(sd, head=False)),
        (cls, "finetuned_inception", lambda sd: inception_state(sd, head=True)),
        (lp.vgg, "vgg16", vgg16_state),
        (lp.heads, "lpips_vgg", lpips_heads_state),
    ) if not load(tower, name, prepare)]
    if not any(load(compat, name, dict) for name in COMPAT_FILES):
        random_towers.append("compat_evaluator")

    if random_towers:
        msg = (f"eval backbones WITHOUT real weights (random init): {random_towers} "
               f"(weights_dir={weights_dir!r}). Metric numbers from these towers are "
               "meaningless.")
        if not allow_random:
            raise FileNotFoundError(msg + " Refusing; pass --allow_random_weights to override.")
        log.warning("%s", msg)

    return Extractors(
        clip=clip, fid_inception=fid, inception=cls, lpips_net=lp, compat=compat,
        clip_tokenizer=load_tokenizer(weights_dir and os.path.join(weights_dir, "tokenizer"),
                                      vocab_size=tcfg.vocab_size),
        device=device, batch_size=batch_size, clip_size=vcfg.image_size,
        random_towers=tuple(random_towers), fid_size=75 if tiny else 299,
        lpips_size=64 if tiny else None)

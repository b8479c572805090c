"""Generation engine: the denoising loop of DiFashion's GOR / PFITB generation.
Counterpart of `difashion_tpu/engine/generate.py`.

Each iteration of the loop:
  * assembles the mutual condition as a dense gather (`mutual_condition_input`:
    the unnormalized sum of the outfit's other items, the current latent for a
    generated slot, the clean catalog latent for a known one) and runs the
    MutualEncoder on it;
  * runs ONE UNet forward over all CFG branches x fill slots
    ([n_branches * F, 8, h, w]: the eta-mixed latent and the history latent);
  * combines the branches with the `GuidanceSpec` weights;
  * takes the PNDM (PLMS) update.

The public layout is the JAX package's: `GenerationInputs` latents are NHWC
[F, h, w, C] and `decode_to_uint8` returns [F, H, W, 3] uint8. The sampler
moves to NCHW once on the way in and back once on the way out. Latents, the
scheduler and the guidance combine stay in fp32; the UNet, the MutualEncoder
and the VAE run in their own dtype.

Only the PNDM scheduler is here; DDIM and DPM-Solver++ come with a later
slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from difashion_tpu_torch.diffusion.pndm import make_pndm_plan, pndm_init_state, pndm_step
from difashion_tpu_torch.models.difashion import DiFashion


@dataclass(frozen=True)
class GuidanceSpec:
    """Per-branch condition selectors and combine weights (1.0 = the real
    condition, 0.0 = the null one). Branch order is the reference's chunk
    order, e.g. full CFG: [allcond, cate_mutual, cate, uncond]."""

    hist_sel: np.ndarray    # [nb]
    mutual_sel: np.ndarray  # [nb]
    text_sel: np.ndarray    # [nb]
    weights: np.ndarray     # [nb] combine coefficients (sum to 1)

    @property
    def num_branches(self) -> int:
        return int(self.hist_sel.shape[0])


def make_guidance_spec(category_scale: float, hist_scale: float,
                       mutual_scale: float, use_history: bool = True,
                       use_mutual: bool = True) -> GuidanceSpec:
    """The reference's CFG mode selection. A condition gets its own branch only
    when its feature is on AND its scale > 1; a feature that is on but not
    guided feeds its real value to every branch, one that is off its null
    value."""
    H = use_history and hist_scale > 1.0
    M = use_mutual and mutual_scale > 1.0
    C = category_scale > 1.0
    h = 1.0 if use_history else 0.0
    m = 1.0 if use_mutual else 0.0
    cs, hs, ms = category_scale, hist_scale, mutual_scale

    if C and H and M:           # full 4-branch
        hist, mut, txt = [h, 0, 0, 0], [m, m, 0, 0], [1, 1, 1, 0]
        w = [hs, ms - hs, cs - ms, 1 - cs]
    elif C and H:
        hist, mut, txt = [h, 0, 0], [m, m, m], [1, 1, 0]
        w = [hs, cs - hs, 1 - cs]
    elif C and M:
        hist, mut, txt = [h, h, h], [m, 0, 0], [1, 1, 0]
        w = [ms, cs - ms, 1 - cs]
    elif C:                     # category only
        hist, mut, txt = [h, h], [m, m], [1, 0]
        w = [cs, 1 - cs]
    elif H:                     # the history branch leads, with or without M
        hist, mut, txt = [h, 0], ([m, 0] if M else [m, m]), [1, 1]
        w = [hs, 1 - hs]
    elif M:
        hist, mut, txt = [h, h], [m, 0], [1, 1]
        w = [ms, 1 - ms]
    else:                       # no guidance at all
        hist, mut, txt, w = [h], [m], [1], [1.0]

    return GuidanceSpec(
        hist_sel=np.asarray(hist, np.float32),
        mutual_sel=np.asarray(mut, np.float32),
        text_sel=np.asarray(txt, np.float32),
        weights=np.asarray(w, np.float32),
    )


def mutual_condition_input(latents: torch.Tensor, outfit_idx: torch.Tensor,
                           known_latents: torch.Tensor, gen_mask: torch.Tensor,
                           gen_index: torch.Tensor) -> torch.Tensor:
    """For each fill slot k, the sum over the other slots j of its outfit of
    source[outfit_k, j], where source is the current latent of a generated
    slot and the clean catalog latent of a known one (generation uses the
    unnormalized sum). latents [F, ...], known_latents [B, olen, ...]; any
    trailing layout."""
    cur = latents[gen_index]                                   # [B, olen, ...]
    mask = gen_mask.reshape(gen_mask.shape + (1,) * (latents.dim() - 1))
    totals = torch.where(mask, cur, known_latents).sum(dim=1)  # [B, ...]
    return totals[outfit_idx] - latents                        # drop own slot


class GenerationInputs(NamedTuple):
    """Dense inputs on one device. F = slots to generate, B = outfits,
    olen = 4. Latents are NHWC."""

    init_latents: torch.Tensor   # [F, h, w, C]       N(0, 1) * init_noise_sigma
    outfit_idx: torch.Tensor     # [F] int            the outfit of each fill slot
    known_latents: torch.Tensor  # [B, olen, h, w, C] clean catalog latents
    gen_mask: torch.Tensor       # [B, olen] bool     True where the slot is generated
    gen_index: torch.Tensor      # [B, olen] int      index into F of a generated slot
    hist_latents: torch.Tensor   # [F, h, w, C]       per-fill history latent (or null)
    cate_text: torch.Tensor      # [F, 77, D]         encoded category prompts
    null_text: torch.Tensor      # [77, D]            encoded empty prompt
    null_latent: torch.Tensor    # [h, w, C]          VAE latent of the white null image


def build_sampler(model: DiFashion, *, num_inference_steps: int,
                  spec: GuidanceSpec, eta: float, scheduler: str = "pndm",
                  return_trajectory: bool = False) -> Callable:
    """A function inputs -> final latents [F, h, w, C] (fp32, NHWC). With
    `return_trajectory=True` it returns (final latents, trajectory
    [L, F, h, w, C]), the latents after every scheduler iteration."""
    if scheduler in ("ddim", "dpmpp"):
        raise NotImplementedError(f"scheduler {scheduler!r} comes with a later slice")
    if scheduler != "pndm":
        raise ValueError(f"unknown scheduler {scheduler!r}")
    plan = make_pndm_plan(model.schedule, num_inference_steps)
    rows = [plan.row(i) for i in range(len(plan))]
    nb = spec.num_branches
    pred_type = model.schedule.prediction_type

    @torch.inference_mode()
    def sample(inputs: GenerationInputs):
        dev = inputs.init_latents.device
        f32 = torch.float32

        def sel(a, ndim):
            return torch.as_tensor(a, dtype=f32, device=dev).view((-1,) + (1,) * ndim)

        hist_sel, mut_sel = sel(spec.hist_sel, 4), sel(spec.mutual_sel, 4)
        text_sel, weights = sel(spec.text_sel, 3), sel(spec.weights, 4)

        latents = inputs.init_latents.to(f32).permute(0, 3, 1, 2).contiguous()
        F, C, h, w = latents.shape
        known = inputs.known_latents.to(f32).permute(0, 1, 4, 2, 3)
        null_lat = inputs.null_latent.to(f32).permute(2, 0, 1)[None, None]
        hist = inputs.hist_latents.to(f32).permute(0, 3, 1, 2)

        # branch-constant inputs, built once
        hist_flat = (hist_sel * hist[None] + (1.0 - hist_sel) * null_lat
                     ).reshape(nb * F, C, h, w)
        text_b = (text_sel * inputs.cate_text.to(f32)[None]
                  + (1.0 - text_sel) * inputs.null_text.to(f32)[None, None])
        text_flat = text_b.reshape((nb * F,) + text_b.shape[2:])

        state = pndm_init_state(latents)
        traj = []
        for row in rows:
            mutual = model.apply_mutual(mutual_condition_input(
                latents, inputs.outfit_idx, known, inputs.gen_mask,
                inputs.gen_index)).to(f32)
            mut_b = mut_sel * mutual[None] + (1.0 - mut_sel) * null_lat
            x = (1.0 - eta) * latents[None] + eta * mut_b      # [nb, F, C, h, w]
            x = torch.cat([x.reshape(nb * F, C, h, w), hist_flat], dim=1)
            t = torch.full((nb * F,), row["t_unet"], dtype=torch.long, device=dev)
            eps = model.apply_unet(x, t, text_flat).to(f32).reshape(nb, F, C, h, w)
            eps = (weights * eps).sum(dim=0)                   # guidance combine
            state, latents = pndm_step(state, row, eps, latents, pred_type)
            if return_trajectory:
                traj.append(latents)

        out = latents.permute(0, 2, 3, 1)
        if return_trajectory:
            return out, torch.stack(traj).permute(0, 1, 3, 4, 2)
        return out

    return sample


@torch.inference_mode()
def decode_and_postprocess(model: DiFashion, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents [F, h, w, C] -> images [F, H, W, 3] fp32 in [0, 1]."""
    imgs = model.decode_latents(latents.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return (imgs.float() / 2.0 + 0.5).clamp(0.0, 1.0)


@torch.inference_mode()
def decode_to_uint8(model: DiFashion, latents: torch.Tensor) -> torch.Tensor:
    """`decode_and_postprocess` quantized on the device: scale, + 0.5, clip,
    truncate. [F, H, W, 3] uint8."""
    imgs = decode_and_postprocess(model, latents)
    return (imgs * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)

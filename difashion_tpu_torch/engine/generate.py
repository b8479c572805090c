"""Generation engine: the denoising loop of DiFashion's GOR / PFITB generation.
Counterpart of `difashion_tpu/engine/generate.py`.

Each iteration of the loop:
  * assembles the mutual condition as a dense gather (`mutual_condition_input`:
    the unnormalized sum of the outfit's other items, the current latent for a
    generated slot, the clean catalog latent for a known one) and runs the
    MutualEncoder on it;
  * runs ONE UNet forward over all CFG branches x fill slots
    ([n_branches * F, 8, h, w]: the eta-mixed latent and the history latent;
    with SDXL's added conditioning also each row's pooled text embedding,
    blended per branch as the context is, and the time ids);
  * combines the branches with the `GuidanceSpec` weights;
  * takes the scheduler's update: PNDM (PLMS, the reference's), DDIM, or
    DPM-Solver++(2M) (the fast-serving scheduler).

The public layout is the JAX package's: `GenerationInputs` latents are NHWC
[F, h, w, C] and `decode_to_uint8` returns [F, H, W, 3] uint8. The sampler
moves to NCHW once on the way in and back once on the way out. Latents, the
scheduler and the guidance combine stay in fp32; the UNet, the MutualEncoder
and the VAE run in their own dtype. Every scheduler's plan rows are host
numbers, so the loop never waits on the device.

Sharded generation (the counterpart of `shard_generation_inputs` on a
mesh): each rank samples its contiguous share of the fills and outfits
(`shard_generation_inputs`, after `pad_generation_inputs`), and the sampler
(`sample(..., dp=...)`) all-gathers the latents at every step to form the
mutual condition, which reads an outfit's other slots wherever they live,
then keeps this rank's rows: the collective that XLA inserts in the JAX
package. The caller gathers the rows (`core/distributed.py::gather_rows`)
and slices off the padding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from difashion_tpu_torch.core import tracing
from difashion_tpu_torch.core.distributed import DistInfo, gather_rows
from difashion_tpu_torch.diffusion.ddim import ddim_step, make_ddim_plan
from difashion_tpu_torch.diffusion.dpmpp import dpmpp_init_state, dpmpp_step, make_dpmpp_plan
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
    trailing layout. The sum over the slots is written out as elementwise
    adds in slot order, so a fill's result does not depend on how many
    outfits share its batch (a reduction kernel's order may)."""
    cur = latents[gen_index]                                   # [B, olen, ...]
    mask = gen_mask.reshape(gen_mask.shape + (1,) * (latents.dim() - 1))
    source = torch.where(mask, cur, known_latents)
    totals = source[:, 0]
    for j in range(1, source.shape[1]):
        totals = totals + source[:, j]                         # [B, ...]
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
    # SDXL's added conditioning (None without it)
    cate_pooled: Optional[torch.Tensor] = None   # [F, P]  pooled category prompts
    null_pooled: Optional[torch.Tensor] = None   # [P]     pooled empty prompt
    time_ids: Optional[torch.Tensor] = None      # [6]     every row's time ids


def build_sampler(model: DiFashion, *, num_inference_steps: int,
                  spec: GuidanceSpec, eta: float, scheduler: str = "pndm",
                  ddim_eta: float = 0.0, return_trajectory: bool = False) -> Callable:
    """A function (inputs, generator=None, step_noise=None, dp=None) ->
    final latents [F, h, w, C] (fp32, NHWC). With `return_trajectory=True`
    it returns (final latents, trajectory [L, F, h, w, C]), the latents
    after every scheduler iteration.

    `scheduler`: "pndm", "ddim" (with `ddim_eta`) or "dpmpp". DDIM with
    ddim_eta > 0 adds noise at every step: pass `step_noise` [L, F, h, w, C]
    (NHWC, as the JAX sampler draws it from its rng) or a `torch.Generator`
    on the latents' device to draw it from; without either it raises.

    `dp` (a group of several ranks): `inputs` is this rank's share from
    `shard_generation_inputs` and the result its rows. The step noise is
    the global batch's ([L, F * world, ...], given or drawn alike on every
    rank), of which each rank keeps its rows."""
    sched = model.schedule
    if scheduler == "pndm":
        plan = make_pndm_plan(sched, num_inference_steps)
    elif scheduler == "ddim":
        plan = make_ddim_plan(sched, num_inference_steps, eta=ddim_eta)
    elif scheduler == "dpmpp":
        plan = make_dpmpp_plan(sched, num_inference_steps)
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")
    rows = [plan.row(i) for i in range(len(plan))]
    nb = spec.num_branches
    pred_type = sched.prediction_type
    noisy_ddim = scheduler == "ddim" and ddim_eta > 0.0

    @torch.inference_mode()
    @tracing.traced("gen.sample")
    def sample(inputs: GenerationInputs, generator: Optional[torch.Generator] = None,
               step_noise: Optional[torch.Tensor] = None, dp: Optional[DistInfo] = None):
        dev = inputs.init_latents.device
        f32 = torch.float32
        world = dp.world if dp is not None else 1
        F = int(inputs.init_latents.shape[0])
        mine = slice(dp.rank * F, (dp.rank + 1) * F) if world > 1 else slice(None)
        # the mutual gather's per-outfit arrays and fill -> outfit map, whole
        outfit_idx = gather_rows(inputs.outfit_idx, world)
        gen_index = gather_rows(inputs.gen_index, world)
        gen_mask = gather_rows(inputs.gen_mask.to(torch.uint8), world).bool()  # gloo: no bool

        def sel(a, ndim):
            return torch.as_tensor(a, dtype=f32, device=dev).view((-1,) + (1,) * ndim)

        hist_sel, mut_sel = sel(spec.hist_sel, 4), sel(spec.mutual_sel, 4)
        text_sel, weights = sel(spec.text_sel, 3), sel(spec.weights, 4)

        # [F, C, h, w] channels-last views of the NHWC inputs, the UNet's layout
        latents = inputs.init_latents.to(f32).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        F, C, h, w = latents.shape
        known = gather_rows(inputs.known_latents.to(f32), world).permute(0, 1, 4, 2, 3)
        null_lat = inputs.null_latent.to(f32).permute(2, 0, 1)[None, None]
        hist = inputs.hist_latents.to(f32).permute(0, 3, 1, 2)

        if noisy_ddim:
            if step_noise is None:
                if generator is None:
                    raise ValueError("ddim_eta > 0 requires a generator or the step noise")
                step_noise = torch.randn((len(rows), F * world) + tuple(
                    inputs.init_latents.shape[1:]), generator=generator, device=dev)
            step_noise = step_noise[:, mine].to(device=dev, dtype=f32).permute(0, 1, 4, 2, 3)

        # branch-constant inputs, built once
        hist_flat = (hist_sel * hist[None] + (1.0 - hist_sel) * null_lat
                     ).reshape(nb * F, C, h, w)
        text_b = (text_sel * inputs.cate_text.to(f32)[None]
                  + (1.0 - text_sel) * inputs.null_text.to(f32)[None, None])
        text_flat = text_b.reshape((nb * F,) + text_b.shape[2:])
        added = {}
        if inputs.cate_pooled is not None:
            pooled_sel = sel(spec.text_sel, 2)
            pooled_b = (pooled_sel * inputs.cate_pooled.to(f32)[None]
                        + (1.0 - pooled_sel) * inputs.null_pooled.to(f32)[None, None])
            added = {"text_embeds": pooled_b.reshape(nb * F, -1),
                     "time_ids": inputs.time_ids.to(f32)[None].expand(nb * F, -1)}

        state = (dpmpp_init_state(latents) if scheduler == "dpmpp"
                 else pndm_init_state(latents))
        traj = []
        for i, row in enumerate(rows):
            with tracing.span("gen.mutual"):
                mutual = model.apply_mutual(mutual_condition_input(
                    gather_rows(latents, world), outfit_idx, known, gen_mask,
                    gen_index)[mine]).to(f32)
                mut_b = mut_sel * mutual[None] + (1.0 - mut_sel) * null_lat
                x = (1.0 - eta) * latents[None] + eta * mut_b      # [nb, F, C, h, w]
                x = torch.cat([x.reshape(nb * F, C, h, w), hist_flat], dim=1)
            t = torch.full((nb * F,), row["t_unet"], dtype=torch.long, device=dev)
            with tracing.span("gen.unet"):
                eps = model.apply_unet(x, t, text_flat, **added)
            tracing.count("gen.unet_forwards")
            with tracing.span("gen.scheduler"):
                eps = eps.to(f32).reshape(nb, F, C, h, w)
                eps = (weights * eps).sum(dim=0)               # guidance combine
                if scheduler == "pndm":
                    state, latents = pndm_step(state, row, eps, latents, pred_type)
                elif scheduler == "dpmpp":
                    state, latents = dpmpp_step(state, row, eps, latents, pred_type)
                else:
                    latents = ddim_step(row, eps, latents, eta=ddim_eta,
                                        noise=step_noise[i] if noisy_ddim else None,
                                        prediction_type=pred_type)
            if return_trajectory:
                traj.append(latents)

        out = latents.permute(0, 2, 3, 1)
        if return_trajectory:
            return out, torch.stack(traj).permute(0, 1, 3, 4, 2)
        return out

    return sample


def pad_generation_inputs(inputs: GenerationInputs, n: int) -> GenerationInputs:
    """Pad the fill (F) and outfit (B) leading axes up to multiples of `n`
    with inert rows (zero latents and text, outfit_idx 0, gen_mask False).
    Inert rows never feed back into real slots: the mutual gather reads only
    the slots that the real outfits' gen_mask and gen_index address, and a
    padded outfit generates nothing. Rows of the sampler's output at or past
    the original F are padding: slice them off (`latents[:F]`). The pooled
    category prompts (SDXL) are padded as the fills are."""
    F = int(inputs.init_latents.shape[0])
    B = int(inputs.gen_mask.shape[0])
    Fp = -(-F // n) * n
    Bp = -(-B // n) * n
    if Fp == F and Bp == B:
        return inputs

    def pad(x, new):
        return torch.cat([x, x.new_zeros((new - x.shape[0],) + tuple(x.shape[1:]))])

    return inputs._replace(
        init_latents=pad(inputs.init_latents, Fp),
        outfit_idx=pad(inputs.outfit_idx, Fp),
        hist_latents=pad(inputs.hist_latents, Fp),
        cate_text=pad(inputs.cate_text, Fp),
        cate_pooled=None if inputs.cate_pooled is None else pad(inputs.cate_pooled, Fp),
        known_latents=pad(inputs.known_latents, Bp),
        gen_mask=pad(inputs.gen_mask, Bp),
        gen_index=pad(inputs.gen_index, Bp),
    )


def shard_generation_inputs(inputs: GenerationInputs, rank: int,
                            world: int) -> GenerationInputs:
    """This rank's share of the generation inputs for `sample(..., dp=...)`:
    the fills and the outfits padded to multiples of `world`
    (`pad_generation_inputs`), then the rank's contiguous slice of each
    (outfits are contiguous in the fill list, so a GOR outfit's slots stay
    on one rank; a mixed FITB batch's may not, which the sampler's gather
    covers). The conditions shared by every fill stay whole. The gathered
    output's rows past the original F are padding."""
    inputs = pad_generation_inputs(inputs, world)
    nf = int(inputs.init_latents.shape[0]) // world
    nb = int(inputs.gen_mask.shape[0]) // world
    fill = lambda x: x[rank * nf:(rank + 1) * nf]
    outfit = lambda x: x[rank * nb:(rank + 1) * nb]
    return inputs._replace(
        init_latents=fill(inputs.init_latents), outfit_idx=fill(inputs.outfit_idx),
        hist_latents=fill(inputs.hist_latents), cate_text=fill(inputs.cate_text),
        cate_pooled=None if inputs.cate_pooled is None else fill(inputs.cate_pooled),
        known_latents=outfit(inputs.known_latents), gen_mask=outfit(inputs.gen_mask),
        gen_index=outfit(inputs.gen_index))


@torch.inference_mode()
def decode_and_postprocess(model: DiFashion, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents [F, h, w, C] -> images [F, H, W, 3] fp32 in [0, 1]. The
    permutes are views: the VAE reads and writes channels-last."""
    imgs = model.decode_latents(latents.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return (imgs.float() / 2.0 + 0.5).clamp(0.0, 1.0)


@torch.inference_mode()
@tracing.traced("gen.decode")
def decode_to_uint8(model: DiFashion, latents: torch.Tensor) -> torch.Tensor:
    """`decode_and_postprocess` quantized on the device: scale, + 0.5, clip,
    truncate. [F, H, W, 3] uint8."""
    imgs = decode_and_postprocess(model, latents)
    return (imgs * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)

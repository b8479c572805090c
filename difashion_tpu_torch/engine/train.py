"""Training engine: the DiFashion loss and the train step. Counterpart of
`difashion_tpu/engine/train.py` (the loss, the optimizer chain, EMA, gradient
accumulation and the skip of non-finite updates; meshes, sharding and ZeRO-1
come with the multi-GPU slice).

One step: the loss of each microbatch under bf16 autocast (fp32 master
weights, as the JAX package keeps fp32 params under a bf16 compute dtype),
its backward (every UNet attention through the flash forward and backward
kernels), the mean gradient, then clip-by-global-norm -> AdamW (or 8-bit
AdamW) -> EMA with the warmup decay min(0.9999, (1+s)/(10+s)). Only
{unet, fashion_encoder} train; {vae, text_encoder} are frozen.

torch updates in place where JAX returns new pytrees: the parameters live in
the model, and `train_step` updates them, the optimizer state and the EMA in
the `TrainState` it is given. Skipping a non-finite update costs one host
sync per step, after the backward (the decision is `isfinite(grad_norm)`).

The batch keeps the JAX package's layout (NHWC latents); the loss moves to
NCHW once. Randomness comes from an explicit `torch.Generator` on the step's
device, drawn in a fixed order; the tests hold the algorithm against the JAX
package with injected draws (`injected`), since the two generators cannot
give the same numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from difashion_tpu_torch.config import TrainConfig
from difashion_tpu_torch.engine.optim8bit import AdamW8bit
from difashion_tpu_torch.models.difashion import DiFashion

_CHUNK_ELEMENTS = 1 << 26   # optimizer temporaries per foreach call (256 MB fp32)


class TrainBatch(NamedTuple):
    """One batch of B outfits x olen items (tensors on the step's device)."""

    images: Optional[torch.Tensor]         # [B, olen, H, W, 3] in [-1, 1], or None
    latent_mean: Optional[torch.Tensor]    # [B, olen, h, w, C] VAE mean (unscaled), or None
    latent_logvar: Optional[torch.Tensor]  # [B, olen, h, w, C]
    input_ids: torch.Tensor                # [B, olen, 77] int
    hist_latents: torch.Tensor             # [B, olen, h, w, C] scaled history latents


@dataclass
class EMAState:
    params: List[torch.Tensor]   # EMA copies of the trainable parameters
    step: int                    # EMA updates applied (skipped steps do not count)


@dataclass
class AdamState:
    count: int                   # updates applied (skipped steps do not count)
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclass
class TrainState:
    names: List[str]             # "unet.<key>" / "fashion_encoder.<key>"
    params: List[torch.nn.Parameter]
    opt_state: object            # AdamState or Adam8bitState
    ema: Optional[EMAState]
    step: int = 0                # train steps taken, skipped or not


def ema_decay_schedule(step: int, max_decay: float) -> float:
    """diffusers EMAModel's warmup decay min(max_decay, (1+s)/(10+s)), in fp32."""
    s = np.float32(step)
    return float(np.minimum(np.float32(max_decay), (np.float32(1) + s) / (np.float32(10) + s)))


def _linear_schedule(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over `steps` updates, then end; a
    constant `init` when steps <= 0 (optax's rule)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = np.float32(1) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))
    return schedule


def _warmup_cosine_schedule(peak: float, warmup: int, total: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, total): linear
    warmup, then cosine decay to 0 over the remaining total - warmup updates."""
    decay_steps = total - warmup
    if decay_steps <= 0:
        raise ValueError(f"cosine schedule needs max_train_steps > lr_warmup_steps, "
                         f"got {total} and {warmup}")
    warm = _linear_schedule(0.0, peak, warmup)

    def schedule(count: int) -> float:
        if count < warmup:
            return warm(count)
        c = np.float32(min(count - warmup, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * c
                                                            / np.float32(decay_steps)))
        return float(np.float32(peak) * cosine)
    return schedule


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate for the count of updates applied so far, per
    `cfg.lr_scheduler`; with `scale_lr`, times accumulation x batch x world
    size (the reference's rule; the world is cfg.dp_size when set, else the
    one device of this slice)."""
    if cfg.lr_scheduler == "constant":
        base = lambda count: cfg.learning_rate
    elif cfg.lr_scheduler == "constant_with_warmup":
        base = _linear_schedule(0.0, cfg.learning_rate, cfg.lr_warmup_steps)
    elif cfg.lr_scheduler == "cosine":
        base = _warmup_cosine_schedule(cfg.learning_rate, cfg.lr_warmup_steps,
                                       cfg.max_train_steps)
    else:
        raise ValueError(f"unknown lr scheduler {cfg.lr_scheduler!r}")
    if not cfg.scale_lr:
        return base
    world = cfg.dp_size if cfg.dp_size > 0 else 1
    factor = cfg.gradient_accumulation_steps * cfg.train_batch_size * world
    return lambda count: base(count) * factor


def _chunks(tensors: Sequence[torch.Tensor]) -> List[slice]:
    """Consecutive slices of `tensors` of at most _CHUNK_ELEMENTS elements
    (one tensor at least), to bound the optimizer's temporaries."""
    out, start, size = [], 0, 0
    for i, t in enumerate(tensors):
        if size and size + t.numel() > _CHUNK_ELEMENTS:
            out.append(slice(start, i))
            start, size = i, 0
        size += t.numel()
    out.append(slice(start, len(tensors)))
    return out


class AdamW:
    """optax.adamw (b1, b2, eps, decoupled weight decay; bias-corrected
    moments), applied to the parameters in place; `learning_rate(count)`
    gives the step size for the count of updates applied so far."""

    def __init__(self, learning_rate: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-2):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(count=0, mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                state: AdamState) -> None:
        """One update of `params` in place from `grads` (already clipped)."""
        b1, b2 = self.b1, self.b2
        lr = self.learning_rate(state.count)
        state.count += 1
        c = np.float32(state.count)
        bc1 = float(np.float32(1) - np.float32(b1) ** c)
        bc2 = float(np.float32(1) - np.float32(b2) ** c)
        for sl in _chunks(params):
            p, g, mu, nu = params[sl], grads[sl], state.mu[sl], state.nu[sl]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            del den
            torch._foreach_add_(u, p, alpha=self.weight_decay)
            torch._foreach_add_(p, u, alpha=-lr)


def make_optimizer(cfg: TrainConfig):
    """AdamW(0.9, 0.999, eps 1e-8, wd 1e-2) at the recipe's learning rate, or
    its 8-bit form with `use_8bit_adam`. The clip by global norm runs before
    it, in `apply_gradients`."""
    cls = AdamW8bit if cfg.use_8bit_adam else AdamW
    return cls(lr_schedule(cfg), b1=cfg.adam_beta1, b2=cfg.adam_beta2,
               eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm unless
    norm < max_norm. Unlike torch.nn.utils.clip_grad_norm_, no epsilon."""
    keep = norm < max_norm
    torch._foreach_div_(list(grads), torch.where(keep, torch.ones_like(norm), norm))
    torch._foreach_mul_(list(grads), torch.where(keep, 1.0, max_norm).to(norm))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[N, h, w, C] -> [N, C, h, w]: a channels-last view, the towers' layout."""
    return x.permute(0, 3, 1, 2)


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, olen, h, w, C] -> [B*olen, C, h, w] in fp32, channels-last."""
    return _nchw(x.reshape((n,) + tuple(x.shape[2:]))).float()


def difashion_loss(model: DiFashion, batch: TrainBatch, null_latent: torch.Tensor,
                   null_text: torch.Tensor, generator: Optional[torch.Generator],
                   cfg: TrainConfig,
                   injected: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The DiFashion training loss. null_latent [h, w, C] is the scaled latent
    of the white null image, null_text [77, D] the encoded empty prompt.

    `injected` (tests) overrides the stochastic draws so the JAX package can be
    driven with the same randomness: `enc_eps` [n, h, w, C], `noise`
    [n, h, w, C], `t_outfit` [B], `p_mask` [n], `p_cate` [n]. When set, the
    MutualEncoder's dropout is off (its draw has no counterpart in JAX)."""
    injected = injected or None
    inj = injected or {}
    sched = model.schedule
    dev = null_latent.device
    normal = lambda shape: torch.randn(shape, generator=generator, device=dev)
    uniform = lambda n: torch.rand(n, generator=generator, device=dev)

    # ---- latents ----------------------------------------------------------
    if batch.latent_mean is not None:
        B, olen = batch.latent_mean.shape[:2]
        n = B * olen
        mean = _rows(batch.latent_mean, n)
        std = torch.exp(0.5 * torch.clamp(_rows(batch.latent_logvar, n), -30.0, 20.0))
        enc_eps = inj.get("enc_eps")
        enc_eps = normal(mean.shape) if enc_eps is None else _nchw(enc_eps).float()
        latents = (mean + std * enc_eps) * model.config.vae.scaling_factor
    else:
        if inj:
            raise ValueError("injected draws need the latent-moments batch")
        B, olen = batch.images.shape[:2]
        n = B * olen
        with torch.no_grad():
            latents = model.encode_images(_rows(batch.images, n), sample=True,
                                          generator=generator)
    latents = latents.float()

    # ---- noise and one timestep per outfit ---------------------------------
    noise = inj.get("noise")
    if noise is None:
        noise = normal(latents.shape)
        if cfg.noise_offset:
            noise = noise + cfg.noise_offset * normal((n, latents.shape[1], 1, 1))
    else:
        noise = _nchw(noise).float()
    t_outfit = inj.get("t_outfit")
    if t_outfit is None:
        t_outfit = torch.randint(0, sched.num_train_timesteps, (B,), generator=generator,
                                 device=dev)
    timesteps = t_outfit.long().repeat_interleave(olen)
    noisy = sched.add_noise(latents, noise, timesteps)

    # ---- mutual condition: the mean over each item's co-items --------------
    null_b = _nchw(null_latent[None]).float().expand_as(noisy)
    if cfg.use_mutual_guidance:
        grp = noisy.reshape((B, olen) + tuple(noisy.shape[1:]))
        mutual_in = ((grp.sum(1, keepdim=True) - grp) / (olen - 1)).reshape(noisy.shape)
        mutual = model.apply_mutual(mutual_in, generator=generator,
                                    deterministic=injected is not None).float()
    else:
        mutual = null_b
    hist = _rows(batch.hist_latents, n) if cfg.use_history else null_b

    # ---- joint condition-dropout windows -----------------------------------
    p = inj.get("p_mask")
    p = uniform(n) if p is None else p.float()
    rows = lambda m: m.reshape(n, 1, 1, 1)
    if cfg.use_history and cfg.use_mutual_guidance:
        hist_mask = p < (cfg.mask_ratio + cfg.coupling_mask_ratio)
        mut_mask = (p >= cfg.mask_ratio) & (p < 2 * cfg.mask_ratio + cfg.coupling_mask_ratio)
        hist = torch.where(rows(hist_mask), null_b, hist)
        mutual = torch.where(rows(mut_mask), null_b, mutual)
    elif cfg.use_history:
        hist = torch.where(rows(p < cfg.mask_ratio), null_b, hist)
    elif cfg.use_mutual_guidance:
        mutual = torch.where(rows(p < cfg.mask_ratio), null_b, mutual)
    unet_in = torch.cat([(1.0 - cfg.eta) * noisy + cfg.eta * mutual, hist], dim=1)

    # ---- text with prompt dropout -------------------------------------------
    text = model.encode_text(batch.input_ids.reshape(n, -1).long()).float()
    p2 = inj.get("p_cate")
    p2 = uniform(n) if p2 is None else p2.float()
    text = torch.where((p2 < cfg.cate_mask_ratio).reshape(n, 1, 1),
                       null_text[None].float(), text)

    # ---- target, UNet, min-SNR loss ------------------------------------------
    pred_type = cfg.prediction_type or sched.prediction_type
    if pred_type == "epsilon":
        target = noise
    elif pred_type == "v_prediction":
        target = sched.get_velocity(latents, noise, timesteps)
    else:
        raise ValueError(f"unknown prediction type {pred_type!r}")
    pred = model.apply_unet(unet_in, timesteps, text).float()
    if cfg.snr_gamma is None:
        loss = torch.mean((pred - target) ** 2)
    else:
        per = torch.mean((pred - target) ** 2, dim=(1, 2, 3))
        loss = torch.mean(per * sched.min_snr_weights(timesteps, cfg.snr_gamma, pred_type))
    return loss, {"loss": loss.detach(), "t_mean": timesteps.float().mean()}


def autocast(model: DiFashion, cfg: TrainConfig):
    """bf16 autocast on the model's device when cfg.mixed_precision is bf16;
    fp32 otherwise."""
    device_type = model.unet.conv_in.weight.device.type
    return torch.autocast(device_type, dtype=torch.bfloat16,
                          enabled=cfg.mixed_precision == "bf16")


def apply_gradients(state: TrainState, grads: List[torch.Tensor], optimizer,
                    cfg: TrainConfig) -> Dict[str, object]:
    """Clip, optimizer update and EMA, given the step's gradients (one per
    parameter of `state.params`). A non-finite gradient norm skips the update
    (parameters and optimizer state hold) when cfg.skip_nonfinite_updates;
    EMA moves towards the (held) parameters either way and counts applied
    updates only. Returns grad_norm (before clipping) and update_skipped."""
    grad_norm = global_norm(grads)
    ok = True
    if cfg.skip_nonfinite_updates:
        ok = bool(torch.isfinite(grad_norm))         # the step's one host sync
    if ok:
        clip_by_global_norm_(grads, grad_norm, cfg.max_grad_norm)
        optimizer.update_(state.params, grads, state.opt_state)
    if state.ema is not None:
        with torch.no_grad():
            d = ema_decay_schedule(state.ema.step, cfg.ema_decay)
            torch._foreach_mul_(state.ema.params, d)
            torch._foreach_add_(state.ema.params, list(state.params),
                                alpha=float(np.float32(1) - np.float32(d)))
        state.ema.step += int(ok)
    state.step += 1
    return {"grad_norm": grad_norm, "update_skipped": 0.0 if ok else 1.0}


def _split(batch: TrainBatch, k: int) -> List[TrainBatch]:
    """k microbatches along the outfit dimension."""
    parts = [x.chunk(k) if x is not None else (None,) * k for x in batch]
    return [TrainBatch(*fields) for fields in zip(*parts)]


def accumulate_gradients(model: DiFashion, params: Sequence[torch.Tensor],
                         batch: TrainBatch, null_latent: torch.Tensor,
                         null_text: torch.Tensor, generator: Optional[torch.Generator],
                         cfg: TrainConfig
                         ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The step's gradient of `params` and the loss of each microbatch. With
    k = gradient_accumulation_steps > 1 the batch is split into k
    microbatches along its outfits, each drawing fresh randomness from
    `generator`, and the gradient is the mean of theirs. Gradients go through
    `.grad` (cleared first); a parameter the loss does not reach gets zeros."""
    k = cfg.gradient_accumulation_steps
    for p in params:
        p.grad = None
    losses = []
    for mb in _split(batch, k) if k > 1 else [batch]:
        with autocast(model, cfg):
            loss, _ = difashion_loss(model, mb, null_latent, null_text, generator, cfg)
        loss.backward()
        losses.append(loss.detach())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    if k > 1:
        torch._foreach_div_(grads, float(k))
    return grads, losses


def build_train_step(model: DiFashion, cfg: TrainConfig):
    """Returns (train_step, init_state).

    init_state() splits the model into trainable and frozen towers, sets the
    UNet's gradient checkpointing from cfg, and returns a fresh TrainState
    (optimizer state and, with use_ema or use_ema_fashion, an EMA copy of the
    trainable parameters).

    train_step(state, batch, null_latent, null_text, generator) takes one
    step in place (`accumulate_gradients`, then `apply_gradients`) and
    returns (state, metrics): loss (mean over the microbatches), grad_norm
    and update_skipped."""
    optimizer = make_optimizer(cfg)

    def init_state() -> TrainState:
        model.prepare_for_training()
        model.unet.set_gradient_checkpointing(cfg.gradient_checkpointing, cfg.remat_policy)
        named = model.trainable_parameters()
        params = [p for _, p in named]
        ema = None
        if cfg.use_ema or cfg.use_ema_fashion:
            ema = EMAState(params=[p.detach().clone() for p in params], step=0)
        return TrainState(names=[name for name, _ in named], params=params,
                          opt_state=optimizer.init(params), ema=ema)

    def train_step(state: TrainState, batch: TrainBatch, null_latent: torch.Tensor,
                   null_text: torch.Tensor, generator: Optional[torch.Generator]):
        grads, losses = accumulate_gradients(model, state.params, batch, null_latent,
                                             null_text, generator, cfg)
        metrics = apply_gradients(state, grads, optimizer, cfg)
        metrics["loss"] = torch.stack(losses).mean()
        return state, metrics

    return train_step, init_state

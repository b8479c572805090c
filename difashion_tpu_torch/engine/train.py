"""Training engine: the DiFashion loss and the train step. Counterpart of
`difashion_tpu/engine/train.py` (the loss, the optimizer chain, EMA, gradient
accumulation, the skip of non-finite updates, data parallelism and ZeRO-1).

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
device, drawn in a fixed order (`loss_draws`); the tests hold the algorithm
against the JAX package with injected draws (`injected`, the same draws in
its layout), since the two generators cannot give the same numbers.

Data parallelism (`build_train_step(..., dp=...)`, the counterpart of
`shard_train_step`): each rank holds its contiguous shard of the global
batch. Every rank seeds the same generator and draws the step's randomness
for the *global* batch, keeping its own rows, so a row's draws depend on its
place in the global batch only: a step over W ranks computes the function
of the one-process step over the global batch. The gradients are averaged
across ranks once per step, after the last microbatch's backward
(`core/distributed.py::all_reduce_mean_`), so the clip, the non-finite skip,
AdamW and EMA see the global gradient and every rank decides alike.

ZeRO-1 (`zero1=True`, the counterpart of `place_state_zero1`): AdamW's
moments and the EMA of each parameter hold only this rank's slice along
`zero1_shard_axis`; each rank updates its slice of the parameter and of the
EMA, and the slices are all-gathered back into the full parameters.
`gather_zero1_state` rebuilds the whole state on one rank for checkpoints.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from difashion_tpu_torch.config import TrainConfig
from difashion_tpu_torch.core import distributed
from difashion_tpu_torch.core.distributed import DistInfo
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


def zero1_shard_axis(shape: Sequence[int], ndev: int) -> Optional[int]:
    """The ZeRO-1 sharding rule (`Zero1` and `engine/memory.py`'s accounting
    share it): the largest dimension divisible by the number of devices, or
    None when the tensor stays whole on every device (a scalar, an empty
    tensor, no divisible dimension)."""
    if not shape or 0 in shape:
        return None
    divisible = [(d, ax) for ax, d in enumerate(shape) if d % ndev == 0]
    if not divisible:
        return None
    return max(divisible)[1]


class Zero1(NamedTuple):
    """Which slice of each trainable parameter this rank's moments and EMA
    hold: `axes[i]` is parameter i's `zero1_shard_axis` (None: held whole by
    every rank), the slice the rank-th of `world` equal parts along it."""

    rank: int
    world: int
    axes: List[Optional[int]]

    @staticmethod
    def plan(params: Sequence[torch.Tensor], rank: int, world: int) -> "Zero1":
        return Zero1(rank, world, [zero1_shard_axis(tuple(p.shape), world) for p in params])

    def part(self, t: torch.Tensor, i: int, rank: Optional[int] = None) -> torch.Tensor:
        """The view of `t` (parameter i's shape) that rank `rank` (this one
        by default) holds."""
        ax = self.axes[i]
        if ax is None:
            return t
        n = t.shape[ax] // self.world
        return t.narrow(ax, (self.rank if rank is None else rank) * n, n)

    def parts(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [self.part(t, i) for i, t in enumerate(tensors)]

    def sharded(self) -> List[int]:
        return [i for i, ax in enumerate(self.axes) if ax is not None]

    @torch.no_grad()
    def collect_(self, full: Optional[Sequence[torch.Tensor]],
                 local: Optional[Sequence[torch.Tensor]] = None,
                 dst: Optional[int] = None) -> None:
        """Fill each rank's slice of every sharded tensor of `full` from the
        rank that holds it. This rank's slices are `local[i]`, or its own
        slices of `full` (then kept in place). Flat buckets are exchanged
        and copied into place (the sharded axis is often not axis 0: conv
        kernels are OIHW): on every rank (all-gather) when `dst` is None,
        else on rank `dst` only (gather; `full` may be None elsewhere)."""
        idx = self.sharded()
        mine = list(local) if local is not None else self.parts(full)
        for bucket in distributed.buckets([mine[i] for i in idx]):
            ids = [idx[b] for b in bucket]
            flat = torch.cat([mine[i].reshape(-1) for i in ids])
            got = None
            if dst is None or self.rank == dst:
                got = [torch.empty_like(flat) for _ in range(self.world)]
            if dst is None:
                dist.all_gather(got, flat)
            else:
                dist.gather(flat, got, dst=dst)
            if got is None:
                continue
            for q in range(self.world):
                if local is None and q == self.rank:
                    continue
                off = 0
                for i in ids:
                    part = self.part(full[i], i, q)
                    part.copy_(got[q][off:off + part.numel()].view(part.shape))
                    off += part.numel()


@dataclass
class TrainState:
    names: List[str]             # "unet.<key>" / "fashion_encoder.<key>"
    params: List[torch.nn.Parameter]
    opt_state: object            # AdamState or Adam8bitState
    ema: Optional[EMAState]
    step: int = 0                # train steps taken, skipped or not
    zero1: Optional[Zero1] = None   # set: the moments and EMA hold this rank's slices


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
    process group's size: `jax.device_count()` in the JAX package, which
    is the same under one process per device)."""
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
    world = cfg.dp_size if cfg.dp_size > 0 else distributed.world_size()
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


def latent_shape(model: DiFashion, batch: TrainBatch) -> Tuple[int, int, int]:
    """(C, h, w) of the batch's latents: the moments' own, or the VAE's
    encoding of its images."""
    if batch.latent_mean is not None:
        h, w, c = batch.latent_mean.shape[2:]
        return c, h, w
    H, W = batch.images.shape[2:4]
    vae = model.config.vae
    return vae.latent_channels, H // vae.scale_factor, W // vae.scale_factor


def batch_shape(batch: TrainBatch) -> Tuple[int, int]:
    """(B outfits, olen items)."""
    x = batch.latent_mean if batch.latent_mean is not None else batch.images
    return int(x.shape[0]), int(x.shape[1])


def loss_draws(model: DiFashion, cfg: TrainConfig, generator: Optional[torch.Generator],
               n_outfits: int, olen: int, shape: Tuple[int, int, int],
               device) -> Dict[str, torch.Tensor]:
    """The stochastic draws of one loss over n_outfits x olen items, in the
    loss's order: the VAE posterior's eps and the noise ([n, C, h, w], the
    noise with its offset term), one timestep per outfit, the
    MutualEncoder's dropout uniforms ([n, hid], where its dropout acts), the
    condition- and prompt-dropout uniforms ([n]). Each tensor's leading axis
    is the batch position (items; outfits for `t_outfit`), so `draws_rows`
    gives any rows' draws."""
    n = n_outfits * olen
    normal = lambda s: torch.randn(s, generator=generator, device=device)
    uniform = lambda s: torch.rand(s, generator=generator, device=device)
    c = shape[0]
    d = {"enc_eps": normal((n,) + tuple(shape)), "noise": normal((n,) + tuple(shape))}
    if cfg.noise_offset:
        d["noise"] = d["noise"] + cfg.noise_offset * normal((n, c, 1, 1))
    d["t_outfit"] = torch.randint(0, model.schedule.num_train_timesteps, (n_outfits,),
                                  generator=generator, device=device)
    if cfg.use_mutual_guidance and model.fashion_encoder.dropout_active():
        d["dropout_u"] = uniform((n, model.config.mutual.hid_dim))
    d["p_mask"] = uniform(n)
    d["p_cate"] = uniform(n)
    return d


def draws_rows(draws: Dict[str, torch.Tensor], start: int, stop: int,
               olen: int) -> Dict[str, torch.Tensor]:
    """The draws of outfits [start, stop)."""
    return {k: v[start:stop] if k == "t_outfit" else v[start * olen:stop * olen]
            for k, v in draws.items()}


def difashion_loss(model: DiFashion, batch: TrainBatch, null_latent: torch.Tensor,
                   null_text: torch.Tensor, generator: Optional[torch.Generator],
                   cfg: TrainConfig,
                   injected: Optional[Dict[str, torch.Tensor]] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The DiFashion training loss. null_latent [h, w, C] is the scaled latent
    of the white null image, null_text [77, D] the encoded empty prompt.

    Its randomness is `draws` (`loss_draws`' dict for this batch's rows), or
    drawn from `generator` by `loss_draws`. `injected` (tests) gives the
    draws in the JAX package's layout, so that package can be driven with
    the same randomness: `enc_eps` [n, h, w, C], `noise` [n, h, w, C],
    `t_outfit` [B], `p_mask` [n], `p_cate` [n]; it has no MutualEncoder
    dropout draw (none has a counterpart in JAX), and the MutualEncoder's
    dropout acts only where the draws hold `dropout_u`."""
    sched = model.schedule
    B, olen = batch_shape(batch)
    n = B * olen
    if injected:
        draws = {k: _nchw(v).float() if k in ("enc_eps", "noise") else v
                 for k, v in injected.items()}
    d = draws if draws is not None else loss_draws(
        model, cfg, generator, B, olen, latent_shape(model, batch), null_latent.device)

    # ---- latents ----------------------------------------------------------
    if batch.latent_mean is not None:
        mean = _rows(batch.latent_mean, n)
        std = torch.exp(0.5 * torch.clamp(_rows(batch.latent_logvar, n), -30.0, 20.0))
        latents = (mean + std * d["enc_eps"]) * model.config.vae.scaling_factor
    else:
        with torch.no_grad():
            latents = model.encode_images(_rows(batch.images, n), sample=True,
                                          eps=d["enc_eps"])
    latents = latents.float()

    # ---- noise and one timestep per outfit ---------------------------------
    noise = d["noise"]
    timesteps = d["t_outfit"].long().repeat_interleave(olen)
    noisy = sched.add_noise(latents, noise, timesteps)

    # ---- mutual condition: the mean over each item's co-items --------------
    null_b = _nchw(null_latent[None]).float().expand_as(noisy)
    if cfg.use_mutual_guidance:
        grp = noisy.reshape((B, olen) + tuple(noisy.shape[1:]))
        mutual_in = ((grp.sum(1, keepdim=True) - grp) / (olen - 1)).reshape(noisy.shape)
        mutual = model.apply_mutual(mutual_in, deterministic="dropout_u" not in d,
                                    dropout_u=d.get("dropout_u")).float()
    else:
        mutual = null_b
    hist = _rows(batch.hist_latents, n) if cfg.use_history else null_b

    # ---- joint condition-dropout windows -----------------------------------
    p = d["p_mask"].float()
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
    p2 = d["p_cate"].float()
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
    parameter of `state.params`; under data parallelism the global mean,
    the same on every rank). A non-finite gradient norm skips the update
    (parameters and optimizer state hold) when cfg.skip_nonfinite_updates;
    EMA moves towards the (held) parameters either way and counts applied
    updates only. With a ZeRO-1 state each rank updates its slices of the
    parameters and the EMA, then the parameters are all-gathered. Returns
    grad_norm (before clipping) and update_skipped."""
    z = state.zero1
    grad_norm = global_norm(grads)
    ok = True
    if cfg.skip_nonfinite_updates:
        ok = bool(torch.isfinite(grad_norm))         # the step's one host sync
    params = state.params if z is None else z.parts(state.params)
    if ok:
        clip_by_global_norm_(grads, grad_norm, cfg.max_grad_norm)
        optimizer.update_(params, grads if z is None else z.parts(grads), state.opt_state)
    if state.ema is not None:
        with torch.no_grad():
            d = ema_decay_schedule(state.ema.step, cfg.ema_decay)
            torch._foreach_mul_(state.ema.params, d)
            torch._foreach_add_(state.ema.params, list(params),
                                alpha=float(np.float32(1) - np.float32(d)))
        state.ema.step += int(ok)
    if ok and z is not None:
        z.collect_(state.params)
    state.step += 1
    return {"grad_norm": grad_norm, "update_skipped": 0.0 if ok else 1.0}


def _split(batch: TrainBatch, k: int) -> List[TrainBatch]:
    """k microbatches along the outfit dimension."""
    parts = [x.chunk(k) if x is not None else (None,) * k for x in batch]
    return [TrainBatch(*fields) for fields in zip(*parts)]


def accumulate_gradients(model: DiFashion, params: Sequence[torch.Tensor],
                         batch: TrainBatch, null_latent: torch.Tensor,
                         null_text: torch.Tensor, generator: Optional[torch.Generator],
                         cfg: TrainConfig, dp: Optional[DistInfo] = None
                         ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The step's gradient of `params` and the loss of each microbatch. With
    k = gradient_accumulation_steps > 1 the batch is split into k
    microbatches along its outfits, each with fresh draws, and the gradient
    is the mean of theirs. Gradients go through `.grad` (cleared first); a
    parameter the loss does not reach gets zeros.

    The draws are those of the one-process step over the global batch
    (`dp.world` ranks' batches in rank order): k microbatches of the global
    batch drawn in turn from `generator`, of which this rank keeps the rows
    of its batch (`dp.rank`-th). Under `dp` the gradient is then averaged
    across the ranks, once (the losses stay this rank's)."""
    k = cfg.gradient_accumulation_steps
    rank, world = (dp.rank, dp.world) if dp is not None else (0, 1)
    B, olen = batch_shape(batch)
    if B % k:
        raise ValueError(f"{B} outfits a rank do not split into {k} microbatches")
    shape, dev = latent_shape(model, batch), null_latent.device
    global_mb = B * world // k
    per_mb = [loss_draws(model, cfg, generator, global_mb, olen, shape, dev)
              for _ in range(k)]
    draws = draws_rows({key: torch.cat([d[key] for d in per_mb]) for key in per_mb[0]},
                       rank * B, (rank + 1) * B, olen)
    for p in params:
        p.grad = None
    losses = []
    for i, mb in enumerate(_split(batch, k) if k > 1 else [batch]):
        with autocast(model, cfg):
            loss, _ = difashion_loss(model, mb, null_latent, null_text, generator, cfg,
                                     draws=draws_rows(draws, i * B // k, (i + 1) * B // k,
                                                      olen))
        loss.backward()
        losses.append(loss.detach())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    if k > 1:
        torch._foreach_div_(grads, float(k))
    distributed.all_reduce_mean_(grads, world)
    return grads, losses


def build_train_step(model: DiFashion, cfg: TrainConfig, dp: Optional[DistInfo] = None,
                     zero1: bool = False):
    """Returns (train_step, init_state).

    init_state() splits the model into trainable and frozen towers, sets the
    UNet's gradient checkpointing from cfg, and returns a fresh TrainState
    (optimizer state and, with use_ema or use_ema_fashion, an EMA copy of the
    trainable parameters; with `zero1` over a group of several ranks, only
    this rank's slices of both).

    train_step(state, batch, null_latent, null_text, generator) takes one
    step in place (`accumulate_gradients`, then `apply_gradients`) and
    returns (state, metrics): loss (mean over the microbatches, and over the
    ranks under `dp`), grad_norm and update_skipped.

    `dp` (from `core/distributed.py::initialize_distributed`): the step is
    this rank's share of a data-parallel step over the group; `batch` is the
    rank's shard of the global batch and every rank passes a generator in
    the same state. 8-bit AdamW's blocks run over flattened parameters, not
    along an axis: it does not take `zero1`."""
    optimizer = make_optimizer(cfg)
    world = dp.world if dp is not None else 1
    if zero1 and cfg.use_8bit_adam:
        raise ValueError("ZeRO-1 shards AdamW's moments along a parameter axis; 8-bit "
                         "AdamW's int8 blocks run over the flattened parameter: train it "
                         "data-parallel without zero1")

    def init_state() -> TrainState:
        model.prepare_for_training()
        model.unet.set_gradient_checkpointing(cfg.gradient_checkpointing, cfg.remat_policy)
        named = model.trainable_parameters()
        params = [p for _, p in named]
        z = Zero1.plan(params, dp.rank, world) if zero1 and world > 1 else None
        held = [t.detach() for t in (z.parts(params) if z is not None else params)]
        ema = None
        if cfg.use_ema or cfg.use_ema_fashion:
            ema = EMAState(params=[t.clone() for t in held], step=0)
        return TrainState(names=[name for name, _ in named], params=params,
                          opt_state=optimizer.init(held), ema=ema, zero1=z)

    def train_step(state: TrainState, batch: TrainBatch, null_latent: torch.Tensor,
                   null_text: torch.Tensor, generator: Optional[torch.Generator]):
        grads, losses = accumulate_gradients(model, state.params, batch, null_latent,
                                             null_text, generator, cfg, dp)
        metrics = apply_gradients(state, grads, optimizer, cfg)
        loss = torch.stack(losses).mean()
        distributed.all_reduce_mean_([loss], world)
        metrics["loss"] = loss
        return state, metrics

    return train_step, init_state


def gather_zero1_state(state: TrainState) -> Optional[TrainState]:
    """A ZeRO-1 state made whole on rank 0, the rank that writes checkpoints
    (every rank calls it): the moments and the EMA gathered from their
    slices into full tensors beside the (already full) parameters, so that a
    checkpoint keeps the files of a data-parallel run. Returns the whole
    state on rank 0, None elsewhere; a state that is not sharded is returned
    as it is."""
    z = state.zero1
    if z is None:
        return state
    dst = 0

    def whole(local):
        full = [torch.empty_like(p.detach()) for p in state.params] if z.rank == dst else None
        z.collect_(full, local=local, dst=dst)
        if full is not None:
            for i, ax in enumerate(z.axes):
                if ax is None:
                    full[i] = local[i]
        return full

    opt = state.opt_state
    mu, nu = whole(opt.mu), whole(opt.nu)
    ema = whole(state.ema.params) if state.ema is not None else None
    if z.rank != dst:
        return None
    return TrainState(names=state.names, params=state.params,
                      opt_state=AdamState(count=opt.count, mu=mu, nu=nu),
                      ema=EMAState(ema, state.ema.step) if state.ema is not None else None,
                      step=state.step)

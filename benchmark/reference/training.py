"""The plain reference of DiFashion's training step: the recipe's loss (VAE
posterior sample, noise, one timestep per outfit, the mutual condition with
the MutualEncoder's dropout, the joint condition-dropout windows, prompt
dropout, epsilon target, min-SNR weights), its gradient, clipping by global
norm, AdamW and the EMA with its warmup decay.

Written from the published recipe (DiFashion's train.py, diffusers'
EMAModel, AdamW with decoupled weight decay and bias correction) in plain
PyTorch fp32. The step's randomness is drawn from a `torch.Generator` in the
order in which the recipe draws it, so a generator seeded alike on the same
device gives the program's draws; the draw rule is worked out again here.
The gradient is summed over blocks of whole outfits so that an fp32
backward at full width fits the card.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference.sampling import alphas_cumprod

# the run_eta0.1.sh recipe (the reference's train.py defaults); a cell's
# "recipe" overrides these as it does the program's TrainConfig
RECIPE = {"learning_rate": 1e-5, "adam_beta1": 0.9, "adam_beta2": 0.999,
          "adam_weight_decay": 1e-2, "adam_epsilon": 1e-8, "max_grad_norm": 1.0,
          "ema_decay": 0.9999, "snr_gamma": 5.0, "mask_ratio": 0.2,
          "coupling_mask_ratio": 0.3, "cate_mask_ratio": 0.2, "eta": 0.1}


def step_draws(gen: torch.Generator, n_outfits: int, olen: int, shape, hid: int,
               timesteps: int, device) -> Dict[str, torch.Tensor]:
    """One step's draws, in the recipe's order: the posterior's eps and the
    noise [n, C, h, w], a timestep per outfit, the MutualEncoder's dropout
    uniforms [n, hid], the condition- and prompt-dropout uniforms [n]."""
    n = n_outfits * olen
    return {"enc_eps": torch.randn((n,) + tuple(shape), generator=gen, device=device),
            "noise": torch.randn((n,) + tuple(shape), generator=gen, device=device),
            "t": torch.randint(0, timesteps, (n_outfits,), generator=gen, device=device),
            "dropout_u": torch.rand((n, hid), generator=gen, device=device),
            "p_mask": torch.rand(n, generator=gen, device=device),
            "p_cate": torch.rand(n, generator=gen, device=device)}


def loss_sum(towers, model_cfg: dict, recipe: dict, batch: Dict[str, torch.Tensor],
             draws: Dict[str, torch.Tensor], null_latent: torch.Tensor,
             null_text: torch.Tensor, n_total: int) -> torch.Tensor:
    """The batch's share of the step's loss: the sum over its rows of the
    min-SNR weighted squared error, over `n_total` (the step's rows). batch:
    latent_mean, latent_logvar, hist_latents [B, olen, h, w, C],
    input_ids [B, olen, 77]; draws: this batch's rows of `step_draws`."""
    B, olen = batch["input_ids"].shape[:2]
    n = B * olen
    rows = lambda x: x.reshape((n,) + tuple(x.shape[2:])).permute(0, 3, 1, 2).float()
    sf = model_cfg["vae"]["scaling_factor"]
    std = torch.exp(0.5 * rows(batch["latent_logvar"]).clamp(-30.0, 20.0))
    lat = (rows(batch["latent_mean"]) + std * draws["enc_eps"]) * sf
    t = draws["t"].repeat_interleave(olen)
    acp = torch.from_numpy(alphas_cumprod(model_cfg["scheduler"])).to(lat.device)[t]
    acp4 = acp.view(-1, 1, 1, 1)
    noisy = acp4.sqrt() * lat + (1 - acp4).sqrt() * draws["noise"]
    grp = noisy.reshape((B, olen) + tuple(noisy.shape[1:]))
    mutual_in = ((grp.sum(1, keepdim=True) - grp) / (olen - 1)).reshape(noisy.shape)
    mutual = towers["fashion_encoder"](mutual_in, draws["dropout_u"])
    null_b = null_latent.permute(2, 0, 1)[None].float().expand_as(noisy)
    hist = rows(batch["hist_latents"])
    p = draws["p_mask"].view(n, 1, 1, 1)
    r0, rc = recipe["mask_ratio"], recipe["coupling_mask_ratio"]
    hist = torch.where(p < r0 + rc, null_b, hist)
    mutual = torch.where((p >= r0) & (p < 2 * r0 + rc), null_b, mutual)
    eta = recipe["eta"]
    unet_in = torch.cat([(1 - eta) * noisy + eta * mutual, hist], dim=1)
    with torch.no_grad():
        text = towers["text_encoder"](batch["input_ids"].reshape(n, -1).long())
    text = torch.where((draws["p_cate"] < recipe["cate_mask_ratio"]).view(n, 1, 1),
                       null_text[None].float(), text)
    pred = towers["unet"](unet_in, t, text)
    per = ((pred - draws["noise"]) ** 2).mean(dim=(1, 2, 3))
    snr = acp / (1 - acp)
    weight = torch.clamp(snr, max=recipe["snr_gamma"]) / snr
    return (per * weight).sum() / n_total


class Trainer:
    """The reference step over `params` (the trainable towers' parameters,
    in a fixed order): gradient in blocks of `block` outfits, clip, AdamW,
    EMA. Holds its own moments and EMA."""

    def __init__(self, towers, model_cfg: dict, recipe: dict, params: Sequence[torch.Tensor],
                 block: int = 1):
        self.towers, self.model_cfg, self.recipe = towers, model_cfg, recipe
        self.params = list(params)
        self.block = block
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.ema = [p.detach().clone() for p in self.params]
        self.count = 0

    @torch.no_grad()
    def resume(self, count: int, mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
               ema: Sequence[torch.Tensor]) -> None:
        """Take up a state `count` updates in (the moments and the EMA copied
        in, in the order of `params`)."""
        self.count = count
        for mine, theirs in ((self.mu, mu), (self.nu, nu), (self.ema, ema)):
            for a, b in zip(mine, theirs):
                a.copy_(b)

    def step(self, batch, draws, null_latent, null_text):
        """One step in place. Returns (loss, the clipped gradient as the
        optimizer gets it: a list, one tensor per parameter)."""
        B, olen = batch["input_ids"].shape[:2]
        for p in self.params:
            p.grad = None
        loss = 0.0
        for s in range(0, B, self.block):
            part = {k: v[s:s + self.block] for k, v in batch.items()}
            d = {k: (v[s:s + self.block] if k == "t" else
                     v[s * olen:(s + self.block) * olen]) for k, v in draws.items()}
            l = loss_sum(self.towers, self.model_cfg, self.recipe, part, d, null_latent,
                         null_text, B * olen)
            l.backward()
            loss += float(l.detach())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        r = self.recipe
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            if norm >= r["max_grad_norm"]:
                grads = [g / norm * r["max_grad_norm"] for g in grads]
            self.count += 1
            b1, b2 = r["adam_beta1"], r["adam_beta2"]
            c = np.float32(self.count)
            bc1 = float(np.float32(1) - np.float32(b1) ** c)
            bc2 = float(np.float32(1) - np.float32(b2) ** c)
            d = float(min(np.float32(r["ema_decay"]), (np.float32(1) + np.float32(self.count - 1))
                          / (np.float32(10) + np.float32(self.count - 1))))
            for p, g, mu, nu, e in zip(self.params, grads, self.mu, self.nu, self.ema):
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (mu / bc1) / ((nu / bc2).sqrt() + r["adam_epsilon"])
                p.add_(u + r["adam_weight_decay"] * p, alpha=-r["learning_rate"])
                e.mul_(d).add_(p, alpha=float(np.float32(1) - np.float32(d)))
        return loss, grads

"""Noise-schedule tables on the host, copied from
`difashion_tpu/diffusion/schedule.py` (numpy, so the plans built from them are
row for row those of the JAX package), and the training quantities over them
(`add_noise`, `get_velocity`, `snr`, `min_snr_weights`,
`pred_original_from_epsilon`) as torch functions of device tensors: the table
is copied to a device once and indexed there, so no step waits on the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from difashion_tpu_torch.config import SchedulerConfig


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    """Beta schedule. SD uses 'scaled_linear': linspace in sqrt-space, squared."""
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            cfg.num_train_timesteps, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end,
                            cfg.num_train_timesteps, dtype=np.float64)
    elif cfg.beta_schedule == "squaredcos_cap_v2":
        t = np.arange(cfg.num_train_timesteps, dtype=np.float64)
        f = lambda s: np.cos((s / cfg.num_train_timesteps + 0.008) / 1.008 * np.pi / 2) ** 2
        betas = np.clip(1.0 - f(t + 1) / f(t), 0.0, 0.999)
    else:
        raise ValueError(f"unknown beta schedule {cfg.beta_schedule!r}")
    return betas.astype(np.float32)


@dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed schedule tables (host numpy)."""

    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    num_train_timesteps: int
    prediction_type: str
    steps_offset: int
    final_alpha_cumprod: float  # set_alpha_to_one=False -> alphas_cumprod[0]
    _device_tables: Dict[torch.device, torch.Tensor] = field(
        default_factory=dict, compare=False, repr=False)

    @staticmethod
    def create(cfg: SchedulerConfig) -> "DiffusionSchedule":
        betas = make_betas(cfg)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas).astype(np.float32)
        return DiffusionSchedule(
            betas=betas,
            alphas=alphas,
            alphas_cumprod=acp,
            num_train_timesteps=cfg.num_train_timesteps,
            prediction_type=cfg.prediction_type,
            steps_offset=cfg.steps_offset,
            final_alpha_cumprod=1.0 if cfg.set_alpha_to_one else float(acp[0]),
        )


    # ---- training-side quantities (torch, on the timesteps' device) ---------

    def _acp(self, timesteps: torch.Tensor, ndim: int) -> torch.Tensor:
        """alphas_cumprod[timesteps] in fp32, shaped [n, 1, ...] to broadcast
        against an `ndim`-dimensional batch."""
        table = self._device_tables.get(timesteps.device)
        if table is None:
            table = torch.from_numpy(self.alphas_cumprod).to(timesteps.device)
            self._device_tables[timesteps.device] = table
        acp = table[timesteps.reshape(-1)]
        return acp.reshape((acp.shape[0],) + (1,) * (ndim - 1))

    def add_noise(self, latents: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0): sqrt(acp_t) x0 + sqrt(1 - acp_t) eps, per row."""
        acp = self._acp(timesteps, latents.dim())
        return acp.sqrt() * latents + (1.0 - acp).sqrt() * noise

    def get_velocity(self, latents: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """v-prediction target: sqrt(acp_t) eps - sqrt(1 - acp_t) x0."""
        acp = self._acp(timesteps, latents.dim())
        return acp.sqrt() * noise - (1.0 - acp).sqrt() * latents

    def snr(self, timesteps: torch.Tensor) -> torch.Tensor:
        """Signal-to-noise ratio acp / (1 - acp) per timestep, [n]."""
        acp = self._acp(timesteps, 1)
        return acp / (1.0 - acp)

    def min_snr_weights(self, timesteps: torch.Tensor, gamma: float,
                        prediction_type: str = "epsilon") -> torch.Tensor:
        """min-SNR-gamma loss weights: min(snr, gamma) / snr for epsilon
        prediction, min(snr, gamma) / (snr + 1) for v-prediction."""
        snr = self.snr(timesteps)
        if prediction_type == "v_prediction":
            return torch.clamp(snr, max=gamma) / (snr + 1.0)
        return torch.clamp(snr, max=gamma) / snr

    def pred_original_from_epsilon(self, timesteps: torch.Tensor, noisy: torch.Tensor,
                                   epsilon: torch.Tensor, clip: bool = True
                                   ) -> torch.Tensor:
        """x0-hat = (x_t - sqrt(1 - acp_t) eps) / sqrt(acp_t), clamped to
        [-1, 1] unless `clip` is False. A 0-dim timestep broadcasts."""
        acp = self._acp(timesteps, noisy.dim())
        x0 = (noisy - (1.0 - acp).sqrt() * epsilon) / acp.sqrt()
        return x0.clamp(-1.0, 1.0) if clip else x0


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int,
                      steps_offset: int) -> np.ndarray:
    """'leading' spacing of SD PNDM/DDIM: (arange(n) * (T//n)).round() +
    steps_offset, ascending."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round().astype(np.int64)
    return ts + steps_offset

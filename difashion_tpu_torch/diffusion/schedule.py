"""Noise-schedule tables on the host, copied from
`difashion_tpu/diffusion/schedule.py` (numpy, so the plans built from them are
row for row those of the JAX package). Only what sampling needs; the training
quantities (add_noise, velocity, min-SNR) come with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int,
                      steps_offset: int) -> np.ndarray:
    """'leading' spacing of SD PNDM/DDIM: (arange(n) * (T//n)).round() +
    steps_offset, ascending."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round().astype(np.int64)
    return ts + steps_offset

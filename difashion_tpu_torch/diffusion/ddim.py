"""DDIM sampling. Counterpart of `difashion_tpu/diffusion/ddim.py`.

The host plan (`make_ddim_plan`) is the JAX package's, row for row: 'leading'
timesteps, descending, with alphas_cumprod at each timestep and at the one a
step ratio below it (the final alpha below 0). `ddim_step` runs on torch
tensors; its coefficients are fp32 host numbers computed from the row as the
JAX step computes them on the device, so it never synchronises. eta > 0 adds
eta * sigma_t times an explicit noise tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from difashion_tpu_torch.diffusion.schedule import DiffusionSchedule, leading_timesteps


@dataclass(frozen=True)
class DDIMPlan:
    t_unet: np.ndarray      # [n] int32, descending
    alpha_t: np.ndarray     # [n] f32
    alpha_prev: np.ndarray  # [n] f32
    num_inference_steps: int
    prediction_type: str
    eta: float = 0.0
    clip_sample: bool = False  # the SD config: clip_sample=False
    init_noise_sigma: float = 1.0

    def __len__(self) -> int:
        return int(self.t_unet.shape[0])

    def row(self, i: int) -> dict:
        """Iteration i as host numbers."""
        return {"t_unet": int(self.t_unet[i]), "alpha_t": float(self.alpha_t[i]),
                "alpha_prev": float(self.alpha_prev[i])}


def make_ddim_plan(sched: DiffusionSchedule, num_inference_steps: int,
                   eta: float = 0.0) -> DDIMPlan:
    T = sched.num_train_timesteps
    step_ratio = T // num_inference_steps
    seq = leading_timesteps(T, num_inference_steps, sched.steps_offset)[::-1].copy()
    acp = sched.alphas_cumprod

    def acp_at(t: int) -> float:
        return float(acp[t]) if t >= 0 else sched.final_alpha_cumprod

    alpha_t = np.array([acp_at(int(t)) for t in seq], np.float32)
    alpha_prev = np.array([acp_at(int(t) - step_ratio) for t in seq], np.float32)
    return DDIMPlan(
        t_unet=seq.astype(np.int32),
        alpha_t=alpha_t,
        alpha_prev=alpha_prev,
        num_inference_steps=num_inference_steps,
        prediction_type=sched.prediction_type,
        eta=eta,
    )


def ddim_step(row: dict, model_output: torch.Tensor, sample: torch.Tensor,
              eta: float = 0.0, noise: Optional[torch.Tensor] = None,
              prediction_type: str = "epsilon", clip_sample: bool = False) -> torch.Tensor:
    """One DDIM update x_t -> x_{t_prev}; `row` is `DDIMPlan.row(i)`. Pass
    `noise` (the shape of `sample`) iff eta > 0."""
    f32 = np.float32
    a_t, a_prev = f32(row["alpha_t"]), f32(row["alpha_prev"])
    b_t = f32(1.0) - a_t
    sa, sb = float(np.sqrt(a_t)), float(np.sqrt(b_t))

    if prediction_type == "epsilon":
        x0 = (sample - sb * model_output) / sa
        eps = model_output
    elif prediction_type == "v_prediction":
        x0 = sa * sample - sb * model_output
        eps = sa * model_output + sb * sample
    else:
        raise ValueError(f"unknown prediction type {prediction_type!r}")

    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
        eps = (sample - sa * x0) / sb

    variance = ((f32(1.0) - a_prev) / b_t) * (f32(1.0) - a_t / a_prev)
    std = f32(eta) * np.sqrt(variance)
    direction = float(np.sqrt(f32(1.0) - a_prev - std ** 2)) * eps
    prev_sample = float(np.sqrt(a_prev)) * x0 + direction
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires an explicit noise tensor")
        prev_sample = prev_sample + float(std) * noise
    return prev_sample

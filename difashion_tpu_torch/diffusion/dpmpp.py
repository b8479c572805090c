"""DPM-Solver++(2M) sampling. Counterpart of `difashion_tpu/diffusion/dpmpp.py`,
the fast-serving scheduler (comparable quality in 15-25 steps where PNDM takes
50).

Data-prediction multistep form: lambda_t = log(alpha_t / sigma_t),
h_i = lambda_{i+1} - lambda_i, D_i = (1 + 1/(2 r_i)) x0_i - (1/(2 r_i)) x0_{i-1}
with r_i = h_{i-1} / h_i, and x_{i+1} = (sigma_{i+1} / sigma_i) x_i
- alpha_{i+1} expm1(-h_i) D_i. The host plan (`make_dpmpp_plan`, the JAX
package's row for row) folds every static quantity into per-iteration rows;
the first iteration is first order (no history), and so is the last: the
terminal boundary (alpha, sigma) = (1, 0) makes its h infinite, and it lands
on x0. The carried state is the previous x0-prediction; `dpmpp_step` is
arithmetic on torch tensors with host-number coefficients.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from difashion_tpu_torch.diffusion.schedule import DiffusionSchedule, leading_timesteps


@dataclass(frozen=True)
class DPMppPlan:
    """Host-precomputed per-iteration schedule; length n = num_inference_steps."""

    t_unet: np.ndarray     # [n] int32, descending: the timestep fed to the UNet
    alpha_t: np.ndarray    # [n] f32  sqrt(alphas_cumprod[t])
    sigma_t: np.ndarray    # [n] f32  sqrt(1 - alphas_cumprod[t])
    c_x: np.ndarray        # [n] f32  sigma_{i+1} / sigma_i
    c_d: np.ndarray        # [n] f32  -alpha_{i+1} * expm1(-h_i)
    d0: np.ndarray         # [n] f32  weight on x0_i       (1 + 1/(2r), or 1)
    d1: np.ndarray         # [n] f32  weight on x0_{i-1}   (-1/(2r), or 0)
    num_inference_steps: int
    prediction_type: str
    init_noise_sigma: float = 1.0

    def __len__(self) -> int:
        return int(self.t_unet.shape[0])

    def row(self, i: int) -> dict:
        """Iteration i as host numbers."""
        out = {"t_unet": int(self.t_unet[i])}
        for name in ("alpha_t", "sigma_t", "c_x", "c_d", "d0", "d1"):
            out[name] = float(getattr(self, name)[i])
        return out


def make_dpmpp_plan(sched: DiffusionSchedule, num_inference_steps: int,
                    timestep_spacing: str = "linspace") -> DPMppPlan:
    """The 2M plan. `timestep_spacing`: "linspace" (the DPM-Solver++
    convention) or "leading" (that of PNDM and DDIM)."""
    T = sched.num_train_timesteps
    n = num_inference_steps
    if n > T:
        # the rounded grid would repeat timesteps: h == 0, inf/NaN coefficients
        raise ValueError(f"num_inference_steps ({n}) must be <= num_train_timesteps ({T})")
    if n < 2:
        raise ValueError("dpmpp needs num_inference_steps >= 2")
    if timestep_spacing == "linspace":
        seq = np.linspace(0, T - 1, n).round()[::-1].astype(np.int64)
    elif timestep_spacing == "leading":
        seq = leading_timesteps(T, n, sched.steps_offset)[::-1].copy()
    else:
        raise ValueError(f"unknown timestep_spacing {timestep_spacing!r}")
    assert np.all(np.diff(seq) < 0), "dpmpp timestep grid must be strictly decreasing"
    if seq.max() >= T:
        # 'leading' spacing with steps_offset 1 reaches T at n == T
        raise ValueError(
            f"timestep grid max {int(seq.max())} exceeds num_train_timesteps-1 "
            f"({T - 1}); reduce num_inference_steps (got {n}) for "
            f"timestep_spacing={timestep_spacing!r} with steps_offset={sched.steps_offset}")

    acp = np.asarray(sched.alphas_cumprod, np.float64)
    a = np.sqrt(acp[seq])
    s = np.sqrt(1.0 - acp[seq])
    a_next = np.concatenate([a[1:], [1.0]])   # terminal boundary: alpha = 1
    s_next = np.concatenate([s[1:], [0.0]])   # terminal boundary: sigma = 0

    with np.errstate(divide="ignore"):
        lam = np.log(a) - np.log(s)
        lam_next = np.where(s_next > 0.0, np.log(a_next) - np.log(s_next), np.inf)
    h = lam_next - lam                         # [n], the last +inf

    c_x = s_next / s
    c_d = -a_next * np.expm1(-h)               # expm1(-inf) = -1: c_d = alpha

    d0 = np.ones(n)
    d1 = np.zeros(n)
    for i in range(1, n - 1):                  # the first and last steps: first order
        r = h[i - 1] / h[i]
        d0[i] = 1.0 + 1.0 / (2.0 * r)
        d1[i] = -1.0 / (2.0 * r)

    return DPMppPlan(
        t_unet=seq.astype(np.int32),
        alpha_t=a.astype(np.float32),
        sigma_t=s.astype(np.float32),
        c_x=c_x.astype(np.float32),
        c_d=c_d.astype(np.float32),
        d0=d0.astype(np.float32),
        d1=d1.astype(np.float32),
        num_inference_steps=n,
        prediction_type=sched.prediction_type,
    )


class DPMppState(NamedTuple):
    prev_x0: torch.Tensor   # the previous iteration's x0-prediction


def dpmpp_init_state(sample: torch.Tensor) -> DPMppState:
    return DPMppState(prev_x0=torch.zeros_like(sample))


def dpmpp_step(state: DPMppState, row: dict, model_output: torch.Tensor,
               sample: torch.Tensor, prediction_type: str = "epsilon"):
    """One DPM-Solver++(2M) update; `row` is `DPMppPlan.row(i)`. Returns
    (new_state, prev_sample)."""
    a_t, s_t = row["alpha_t"], row["sigma_t"]
    if prediction_type == "epsilon":
        x0 = (sample - s_t * model_output) / a_t
    elif prediction_type == "v_prediction":
        x0 = a_t * sample - s_t * model_output
    else:
        raise ValueError(f"unknown prediction type {prediction_type!r}")
    # d1 is 0 on the first iteration, so the zero prev_x0 never contributes
    d = row["d0"] * x0 + row["d1"] * state.prev_x0
    return DPMppState(prev_x0=x0), row["c_x"] * sample + row["c_d"] * d

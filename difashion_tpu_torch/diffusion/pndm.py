"""PNDM/PLMS sampling (skip_prk_steps=True). Counterpart of
`difashion_tpu/diffusion/pndm.py`.

The host plan (`make_pndm_plan`) is the JAX package's, row for row: with
skip_prk_steps every piece of the scheduler's state except the epsilon history
is a static function of the iteration index. The timesteps for n steps are
[t_{n-1}, t_{n-2}, t_{n-2}, t_{n-3}, ..., t_0] (n+1 iterations): iteration 0
stores e0 and stashes the sample; iteration 1 is the corrector, (e_new + e0)/2
from the stashed sample over the first interval; iterations 2 and 3 are
2nd/3rd-order Adams-Bashforth, later ones 4th order.

`pndm_step` runs on torch tensors. The plan's rows are host numbers, so the
step branches in Python and never synchronises with the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np
import torch

from difashion_tpu_torch.diffusion.schedule import DiffusionSchedule, leading_timesteps


@dataclass(frozen=True)
class PNDMPlan:
    """Host-precomputed per-iteration schedule; every array has length
    L = n_steps + 1."""

    t_unet: np.ndarray        # [L] int32   timestep fed to the UNet at iteration i
    alpha_t: np.ndarray       # [L] f32     alphas_cumprod at the (adjusted) current t
    alpha_prev: np.ndarray    # [L] f32     alphas_cumprod at the (adjusted) previous t
    ets_coeffs: np.ndarray    # [L, 4] f32  linear-multistep coeffs, newest-first
    cm: np.ndarray            # [L] f32     coefficient on the *current* model output
    append: np.ndarray        # [L] f32     1.0 if this iteration pushes into the history
    use_cur: np.ndarray       # [L] f32     1.0 if the update uses the stashed cur_sample
    save_cur: np.ndarray      # [L] f32     1.0 if this iteration stashes cur_sample
    num_inference_steps: int
    prediction_type: str
    init_noise_sigma: float = 1.0

    def __len__(self) -> int:
        return int(self.t_unet.shape[0])

    def row(self, i: int) -> dict:
        """Iteration i as host numbers."""
        return {
            "t_unet": int(self.t_unet[i]),
            "alpha_t": float(self.alpha_t[i]),
            "alpha_prev": float(self.alpha_prev[i]),
            "ets_coeffs": [float(c) for c in self.ets_coeffs[i]],
            "cm": float(self.cm[i]),
            "append": bool(self.append[i] > 0.5),
            "use_cur": bool(self.use_cur[i] > 0.5),
            "save_cur": bool(self.save_cur[i] > 0.5),
        }


# Newest-first Adams-Bashforth coefficient rows keyed by iteration index.
_AB2 = np.array([3 / 2, -1 / 2, 0.0, 0.0])
_AB3 = np.array([23 / 12, -16 / 12, 5 / 12, 0.0])
_AB4 = np.array([55 / 24, -59 / 24, 37 / 24, -9 / 24])


def make_pndm_plan(sched: DiffusionSchedule, num_inference_steps: int) -> PNDMPlan:
    """The static plan for `num_inference_steps` PLMS steps (skip_prk_steps=True)."""
    T = sched.num_train_timesteps
    step_ratio = T // num_inference_steps
    base = leading_timesteps(T, num_inference_steps, sched.steps_offset)  # ascending
    # [t0..t_{n-2}] + [t_{n-2}] + [t_{n-1}], reversed:
    seq = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
    L = len(seq)
    acp = sched.alphas_cumprod

    def acp_at(t: int) -> float:
        return float(acp[t]) if t >= 0 else sched.final_alpha_cumprod

    t_unet = seq.astype(np.int32)
    alpha_t = np.zeros(L, np.float32)
    alpha_prev = np.zeros(L, np.float32)
    coeffs = np.zeros((L, 4), np.float32)
    cm = np.zeros(L, np.float32)
    append = np.zeros(L, np.float32)
    use_cur = np.zeros(L, np.float32)
    save_cur = np.zeros(L, np.float32)

    for i in range(L):
        t = int(seq[i])
        prev_t = t - step_ratio
        if i == 1:
            # corrector: redo the interval [t + ratio -> t]
            prev_t = t
            t = t + step_ratio
        alpha_t[i] = acp_at(t)
        alpha_prev[i] = acp_at(prev_t)
        append[i] = 0.0 if i == 1 else 1.0
        use_cur[i] = 1.0 if i == 1 else 0.0
        save_cur[i] = 1.0 if i == 0 else 0.0
        if i == 0:
            coeffs[i] = np.array([1.0, 0, 0, 0])   # e0 itself (just appended)
        elif i == 1:
            coeffs[i] = np.array([0.5, 0, 0, 0])   # history holds e0
            cm[i] = 0.5                            # plus the fresh corrector epsilon
        elif i == 2:
            coeffs[i] = _AB2
        elif i == 3:
            coeffs[i] = _AB3
        else:
            coeffs[i] = _AB4

    return PNDMPlan(
        t_unet=t_unet,
        alpha_t=alpha_t,
        alpha_prev=alpha_prev,
        ets_coeffs=coeffs,
        cm=cm,
        append=append,
        use_cur=use_cur,
        save_cur=save_cur,
        num_inference_steps=num_inference_steps,
        prediction_type=sched.prediction_type,
    )


class PNDMState(NamedTuple):
    ets: List[torch.Tensor]   # newest-first epsilon history, at most 4
    cur_sample: torch.Tensor  # the sample stashed at iteration 0


def pndm_init_state(sample: torch.Tensor) -> PNDMState:
    return PNDMState(ets=[], cur_sample=torch.zeros_like(sample))


def pndm_step(state: PNDMState, row: dict, model_output: torch.Tensor,
              sample: torch.Tensor, prediction_type: str = "epsilon"):
    """One PLMS update; `row` is `PNDMPlan.row(i)`. Returns (new_state,
    prev_sample), in the dtype of `sample`."""
    a_t, a_prev = row["alpha_t"], row["alpha_prev"]
    ets = [model_output] + state.ets[:3] if row["append"] else state.ets
    cur = sample if row["save_cur"] else state.cur_sample
    eff_sample = cur if row["use_cur"] else sample

    combo = row["cm"] * model_output
    for c, e in zip(row["ets_coeffs"], ets):
        if c != 0.0:
            combo = combo + c * e
    if prediction_type == "v_prediction":
        combo = a_t ** 0.5 * combo + (1.0 - a_t) ** 0.5 * eff_sample

    sample_coeff = (a_prev / a_t) ** 0.5
    denom = a_t * (1.0 - a_prev) ** 0.5 + (a_t * (1.0 - a_t) * a_prev) ** 0.5
    prev_sample = sample_coeff * eff_sample - ((a_prev - a_t) / denom) * combo
    return PNDMState(ets=ets, cur_sample=cur), prev_sample

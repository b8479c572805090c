"""Per-device memory of the training state, planned without allocating it.
Counterpart of `difashion_tpu/engine/memory.py`.

The model and its `TrainState` are built on the `meta` device (shapes and
dtypes, no storage) through the same `build_train_step` the training loop
uses, so the plan counts the tensors a run holds: the trainable parameters,
the optimizer state (AdamW's two fp32 moments, or the 8-bit blocks: int8
[n_blocks, 256] and one fp32 scale per block), the EMA copy, and the
gradients that live during the update. The optimizer's update count is a
host integer, not a tensor, so it takes no device memory (the JAX package
counts its int32 counters, 4 bytes each).

Two schemes: every device holds the whole state (data parallel), or the
moments and the EMA are sharded over the devices (ZeRO-1) by
`zero1_shard_axis`, the rule of the ZeRO-1 state itself
(`engine/train.py::Zero1`).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

import torch

from difashion_tpu_torch.engine.optim8bit import Adam8bitState
from difashion_tpu_torch.engine.train import (AdamState, TrainState, build_train_step,
                                              zero1_shard_axis)
from difashion_tpu_torch.models.difashion import FROZEN, DiFashion


def _bytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bytes_sharded(tensors: Iterable[torch.Tensor], ndev: int) -> int:
    """Per-device bytes under `zero1_shard_axis`."""
    total = 0
    for t in tensors:
        b = t.numel() * t.element_size()
        total += b // ndev if zero1_shard_axis(tuple(t.shape), ndev) is not None else b
    return total


def opt_state_tensors(opt_state) -> List[torch.Tensor]:
    """Every tensor of an AdamW or 8-bit AdamW state."""
    if isinstance(opt_state, AdamState):
        return list(opt_state.mu) + list(opt_state.nu)
    if isinstance(opt_state, Adam8bitState):
        return (list(opt_state.mu_q) + list(opt_state.mu_s) + list(opt_state.nu_q)
                + list(opt_state.nu_s))
    raise TypeError(f"unknown optimizer state {type(opt_state).__name__}")


def state_bytes(state: TrainState) -> Dict[str, int]:
    """Bytes of a TrainState's tensors: params_trainable, opt_state, ema."""
    return {"params_trainable": _bytes(state.params),
            "opt_state": _bytes(opt_state_tensors(state.opt_state)),
            "ema": _bytes(state.ema.params) if state.ema is not None else 0}


def state_memory_accounting(model_cfg, train_cfg, n_devices: int,
                            param_dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Per-device bytes of the training state at the model's real size, on
    the meta device (nothing allocated), under data parallelism (the state
    whole on every device) and under ZeRO-1 (moments and EMA sharded).

    Buckets: params_trainable, params_frozen, opt_state, ema, and
    grads_transient (one fp32 gradient per trainable parameter, live during
    the update in both schemes)."""
    with torch.device("meta"):
        model = DiFashion(model_cfg)
    model.to(param_dtype)
    _, init_state = build_train_step(model, train_cfg)
    state = init_state()
    frozen = [p for tower in FROZEN for p in getattr(model, tower).parameters()]
    ndev = max(1, n_devices)
    buckets = {**state_bytes(state), "params_frozen": _bytes(frozen),
               "grads_transient": sum(p.numel() * 4 for p in state.params)}
    buckets = {k: buckets[k] for k in ("params_trainable", "params_frozen", "opt_state",
                                       "ema", "grads_transient")}
    opt = opt_state_tensors(state.opt_state)
    per_chip_z1 = (buckets["params_trainable"] + buckets["params_frozen"]
                   + buckets["grads_transient"] + _bytes_sharded(opt, ndev)
                   + (_bytes_sharded(state.ema.params, ndev) if state.ema is not None else 0))
    return {
        "n_devices": ndev,
        "buckets": buckets,
        "per_chip_bytes_dp": sum(buckets.values()),
        "per_chip_bytes_zero1": per_chip_z1,
        "param_count_trainable": sum(p.numel() for p in state.params),
    }


def format_accounting(acc: Dict[str, Any], hbm_bytes: int = 80 * 2**30) -> str:
    gb = lambda b: f"{b / 2**30:.2f} GiB"
    lines = [f"training-state memory accounting ({acc['param_count_trainable'] / 1e6:.0f}M "
             f"trainable params, {acc['n_devices']} devices, {gb(hbm_bytes)}/device):"]
    for k, v in acc["buckets"].items():
        lines.append(f"  {k:<18} {gb(v)}")
    dp, z1 = acc["per_chip_bytes_dp"], acc["per_chip_bytes_zero1"]
    lines.append(f"  per-device DP (replicated state)  {gb(dp)}"
                 f"  -> {'FITS' if dp <= hbm_bytes else 'EXCEEDS'} {gb(hbm_bytes)}")
    lines.append(f"  per-device ZeRO-1 (sharded m/v/EMA) {gb(z1)}"
                 f"  -> {'FITS' if z1 <= hbm_bytes else 'EXCEEDS'} {gb(hbm_bytes)}")
    return "\n".join(lines)

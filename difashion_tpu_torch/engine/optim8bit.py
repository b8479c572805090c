"""Block-wise 8-bit AdamW: the port's `use_8bit_adam` optimizer.

Counterpart of `difashion_tpu/engine/optim8bit.py` (the reference's
bitsandbytes `AdamW8bit` option). The Adam moments are stored as int8 with one
fp32 absmax scale per block of 256 flattened elements, dequantized and
requantized at every update: a 4x saving on the optimizer's memory (the
sd2_base UNet's two fp32 moments are 6.9 GB). Linear absmax blocks stand in
for bitsandbytes' dynamic-tree quantization, as in the JAX package. Plain
PyTorch: the JAX package has no Pallas kernel here.

The update is the JAX chain scale_by_adam8bit -> add_decayed_weights ->
scale_by_learning_rate, applied to the parameters in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 256


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 [n_blocks, BLOCK], fp32 scales [n_blocks]): per-block absmax
    / 127, values rounded half to even and clipped to [-127, 127]; the last
    block is zero-padded."""
    flat = x.reshape(-1).float()
    xp = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    scale = xp.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xp / safe), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """The fp32 tensor of `shape` that `quantize` stored."""
    n = int(np.prod(shape))
    return (q.float() * scale[:, None]).reshape(-1)[:n].reshape(shape)


@dataclass
class Adam8bitState:
    count: int
    mu_q: List[torch.Tensor]
    mu_s: List[torch.Tensor]
    nu_q: List[torch.Tensor]
    nu_s: List[torch.Tensor]


class AdamW8bit:
    """AdamW with int8 block-quantized moments; `learning_rate(count)` gives
    the step size for the count of updates applied so far."""

    def __init__(self, learning_rate: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-2):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> Adam8bitState:
        zeros = [quantize(torch.zeros(p.numel(), device=p.device)) for p in params]
        return Adam8bitState(
            count=0,
            mu_q=[q for q, _ in zeros], mu_s=[s for _, s in zeros],
            nu_q=[q.clone() for q, _ in zeros], nu_s=[s.clone() for _, s in zeros])

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                state: Adam8bitState) -> None:
        """One update of `params` in place from `grads` (already clipped)."""
        b1, b2, eps = self.b1, self.b2, self.eps
        lr = self.learning_rate(state.count)
        state.count += 1
        c = np.float32(state.count)
        bc1 = float(np.float32(1) - np.float32(b1) ** c)
        bc2 = float(np.float32(1) - np.float32(b2) ** c)
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g.float()
            mu = b1 * dequantize(state.mu_q[i], state.mu_s[i], g.shape) + (1 - b1) * g
            nu = b2 * dequantize(state.nu_q[i], state.nu_s[i], g.shape) + (1 - b2) * g * g
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            state.mu_q[i], state.mu_s[i] = quantize(mu)
            state.nu_q[i], state.nu_s[i] = quantize(nu)
            u = u + self.weight_decay * p
            p.add_(u, alpha=-lr)

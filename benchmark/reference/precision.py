"""The precision in which the reference multiplies: fp32 for the reference
itself, and the control's lower precision.

`Precision.cast` is applied to both operands of every matrix product of the
reference (linear layers, convolutions, attention's two products). In fp32
it is the identity. The control (`FP8`) rounds each operand to float8 e4m3
with a per-tensor scale (its largest magnitude onto e4m3's largest finite
value, 448) and multiplies the rounded values in fp32, as fp8 tensor cores
multiply fp8 operands into fp32 sums; under autograd the gradient that flows
back through a cast is rounded to float8 e5m2 the same way, as fp8 training
recipes keep gradients. Normalisations, softmax and the elementwise work stay
in fp32.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def round_to(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to `dtype` under a per-tensor scale, back in x's dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8Cast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_to(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """`name` "fp32" (identity) or "fp8" (the control)."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "fp32" else _Fp8Cast.apply(x)


FP32 = Precision("fp32")
FP8 = Precision("fp8")

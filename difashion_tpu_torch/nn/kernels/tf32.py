"""3xTF32 in plain PyTorch: the operand split and the product that the fp32
kernels (`csrc/flash_attention_f32.cu`, `csrc/skinny_matmul_f32.cu`) compute
on the tensor cores, for their plain 3xTF32 versions, which the tests and
`chip_smoke.py` hold the kernels against.

Each fp32 operand x is split into hi = x rounded to TF32 (to nearest, ties
away from zero, as `cvt.rna.tf32.f32`) and lo = (x - hi) rounded the same
way, and a product sums lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) in fp32;
lo(a) lo(b), about 2^-22 of a product, is dropped. The products run in fp32
(`torch.backends.cuda.matmul.allow_tf32` off on the card).
"""
from __future__ import annotations

from typing import Tuple

import torch

_TF32_DROPPED = 0x1FFF          # the 13 low mantissa bits fp32 has and TF32 has not
_FP32_EXPONENT = 0x7F800000


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as `cvt.rna.tf32.f32` does: half a TF32 unit added to the
    magnitude's bits, then the low 13 bits cleared (a carry moves into the
    exponent; subnormals round alike). Inf and NaN pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~_TF32_DROPPED
    special = (bits & _FP32_EXPONENT) == _FP32_EXPONENT
    return torch.where(special, bits, rounded).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 x as the fp32 kernels split an operand:
    hi = x rounded to TF32, lo = (x - hi) rounded to TF32, so that
    hi + lo = x to about 2^-22 of x (both exact in fp32). hi of an inf or a
    NaN is itself; lo is then NaN (inf - inf), as in the kernels."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split: fp32 input, got {x.dtype}")
    hi = _tf32_round(x)
    return hi, _tf32_round(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 from 3xTF32 operands, as the fp32 kernels form each
    product: lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b); lo lo dropped."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return torch.matmul(al, bh).add_(torch.matmul(ah, bl)).add_(torch.matmul(ah, bh))

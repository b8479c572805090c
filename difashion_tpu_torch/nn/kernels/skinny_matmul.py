"""Skinny-N matrix product: the CUDA kernel's wrapper, its plain version, the
Dense layers' gate, and the autograd Function over both.

Port of `tools/pallas_skinny_matmul.py::_mm_kernel` (through `_mm_call`, the
`_matmul` custom VJP, `matmul_2d` and `pallas_dense_dot`) ->
`csrc/skinny_matmul.cu`: o = x . w^T for x [M, K] and a weight in
`nn.Linear`'s [N, K] layout, summed in fp32 and rounded once to x's dtype
(bf16 or fp16). No bias: the caller adds it.

`dense_route` is the gate of `pallas_dense_dot`, with a CUDA tensor in place
of `_on_tpu()`: a 2-D weight with N <= 1280 columns and at most 8 MiB in the
compute dtype, x and the weight of one compute dtype, and M = the product of
x's leading dimensions with M >= 2048 and M % 512 == 0. The compute dtype is
autocast's where autocast is on (bf16 training over fp32 master weights), as
flax's Dense computes in its `dtype`. One condition is the port's own: the
kernel takes bf16 and fp16, so an fp32 product stays with `F.linear`.

`skinny_matmul` launches the kernel for CUDA tensors and raises on what the
kernel does not take; for CPU tensors it computes the plain version
(`skinny_matmul_ref`), which the CPU tests hold against the JAX kernel in
interpret mode. `SkinnyMatmul` is the counterpart of the `_matmul` custom VJP:
the forward is the kernel, dx = g . w is the kernel again (on the transposed
weight), and dw = g^T x is a plain product, as the JAX package leaves it to
XLA.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from difashion_tpu_torch.nn import kernels

NAME = "skinny_matmul"
MAX_N = 1280
MAX_W_BYTES = 8 * 1024 * 1024
MIN_M = 2048
M_MULTIPLE = 512
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
_BLOCK_M, _MAX_GRID_Y = 128, 65535


def skinny_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x [M, K], w [N, K] -> [M, N] in x's dtype, summed in
    fp32."""
    return (x.float() @ w.float().t()).to(x.dtype)


def compute_dtypes(x: torch.Tensor, weight: torch.Tensor) -> Tuple[torch.dtype, torch.dtype]:
    """The dtypes in which a Dense multiplies x and its weight: autocast's for
    both where it is on for x's device, else their own."""
    if torch.is_autocast_enabled(x.device.type):
        dtype = torch.get_autocast_dtype(x.device.type)
        return dtype, dtype
    return x.dtype, weight.dtype


def gate(rows: int, n: int, k: int, x_dtype: torch.dtype, w_dtype: torch.dtype) -> bool:
    """`pallas_dense_dot`'s conditions on a product of `rows` rows of x with
    an [n, k] weight in these compute dtypes (and the kernel's dtypes)."""
    return (n <= MAX_N and n * k * w_dtype.itemsize <= MAX_W_BYTES and x_dtype == w_dtype
            and x_dtype in _DTYPE_CODES and rows >= MIN_M and rows % M_MULTIPLE == 0)


def dense_route(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether `x @ weight.T` goes through the kernel: a CUDA tensor and
    `gate`. A function of shapes, dtypes, device and the autocast state."""
    if x.device.type != "cuda" or weight.dim() != 2 or x.dim() < 1:
        return False
    return gate(math.prod(x.shape[:-1]), weight.shape[0], weight.shape[1],
                *compute_dtypes(x, weight))


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("skinny_matmul: x and w must lie on one CUDA device")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"skinny_matmul: bf16 or fp16 x and w of one dtype, got "
                        f"{x.dtype}/{w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"skinny_matmul: x [M, K] and w [N, K], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    if m == 0 or k == 0 or w.shape[0] == 0:
        raise ValueError(f"skinny_matmul: empty product {tuple(x.shape)} x {tuple(w.shape)}")
    if k % 8 or x.stride(1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(f"skinny_matmul: x needs K % 8 == 0, unit stride along K, a row "
                         f"stride that is a multiple of 8 and a 16-byte aligned base; got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("skinny_matmul: w must be contiguous and 16-byte aligned")
    if -(-m // _BLOCK_M) > _MAX_GRID_Y:
        raise ValueError(f"skinny_matmul: M = {m} exceeds the grid's "
                         f"{_BLOCK_M * _MAX_GRID_Y} rows")


def _fn():
    fn = getattr(kernels.load(NAME), NAME)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [ctypes.c_int,
                                                                          ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def skinny_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] (unit stride along K) times w [N, K] transposed: [M, N]
    contiguous in x's dtype."""
    if x.device.type == "cpu":
        return skinny_matmul_ref(x, w)
    _check(x, w)
    m, k = x.shape
    n = w.shape[0]
    o = torch.empty(m, n, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), w.data_ptr(), o.data_ptr(), m, n, k, x.stride(0),
                   _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {rc}")
    kernels.LAUNCHES[NAME] += 1
    return o


class SkinnyMatmul(torch.autograd.Function):
    """o = x . w^T through `skinny_matmul` (or, with `plain`, its plain
    version). Saves x and w; the backward takes dx = g . w through the same
    function on the contiguous transpose of w, and dw = g^T x as one plain
    product in the inputs' dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, plain: bool):
        ctx.save_for_backward(x, w)
        ctx.plain = plain
        return (skinny_matmul_ref if plain else skinny_matmul)(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mm = skinny_matmul_ref if ctx.plain else skinny_matmul
        g = g.contiguous()
        dx = mm(g, w.t().contiguous()) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(g.t(), x) if ctx.needs_input_grad[1] else None
        return dx, dw, None

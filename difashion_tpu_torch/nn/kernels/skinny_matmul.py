"""Skinny-N matrix product: the CUDA kernel's wrapper, its plain version, the
Dense layers' gate, and the autograd Function over both.

Port of `tools/pallas_skinny_matmul.py::_mm_kernel` (through `_mm_call`, the
`_matmul` custom VJP, `matmul_2d` and `pallas_dense_dot`) ->
`csrc/skinny_matmul.cu`: o = x . w^T (+ bias) for x [M, K] and a weight in
`nn.Linear`'s [N, K] layout (or, with `w_kn=True`, one given as [K, N]),
summed in fp32 and rounded once to x's dtype (bf16 or fp16); a bias is added
to the rounded product and the sum rounded again, as flax's Dense adds its
bias after the dot_general.

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
interpret mode. `tile_n` is the kernel's output tile width per N, chosen by
measurement on the H100 (`scripts/skinny_matmul_tiles.py`). `SkinnyMatmul` is
the counterpart of the `_matmul` custom VJP: the forward is the kernel, dx =
g . w is the kernel again on the stored [N, K] weight read as [K, N] (no
transposed copy), dw = g^T x is a plain product, as the JAX package leaves
it to XLA, and db = g summed over rows.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from difashion_tpu_torch.nn import kernels

NAME = "skinny_matmul"
MAX_N = 1280
MAX_W_BYTES = 8 * 1024 * 1024
MIN_M = 2048
M_MULTIPLE = 512
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
TILE_WIDTHS = (128, 160, 256)          # the widths the kernel is built for
# Measured exceptions to `tile_n`'s rule (scripts/skinny_matmul_tiles.py on an
# H100): for dx, w read as [K, N], a 160-wide tile reads three 64-column
# chunks of w, and 128 wins at these N
_KN_TILE_N = {320: 128, 2560: 128}


def tile_n(n: int, w_kn: bool = False) -> int:
    """The kernel's output tile width (BN) for an N-column product with w in
    the given layout: 160 where it splits N into whole tiles (N = 320 in two,
    the fastest at every routed N that 160 divides; 256 lost everywhere),
    else 128, save the measured exceptions for dx."""
    if w_kn and n in _KN_TILE_N:
        return _KN_TILE_N[n]
    return 160 if n % 160 == 0 else 128


def skinny_matmul_ref(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      *, w_kn: bool = False) -> torch.Tensor:
    """Plain version: x [M, K] times w [N, K] transposed (w [K, N] as it is
    with `w_kn`) -> [M, N] in x's dtype, summed in fp32 and rounded once; a
    bias is added to the rounded product and the sum rounded again."""
    y = (x.float() @ (w.float() if w_kn else w.float().t())).to(x.dtype)
    if bias is not None:
        y = (y.float() + bias.float()).to(x.dtype)
    return y


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


def _check(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], w_kn: bool) -> None:
    if not (x.is_cuda and w.device == x.device
            and (bias is None or bias.device == x.device)):
        raise ValueError("skinny_matmul: x, w and the bias must lie on one CUDA device")
    if (x.dtype not in _DTYPE_CODES or w.dtype != x.dtype
            or (bias is not None and bias.dtype != x.dtype)):
        raise TypeError(f"skinny_matmul: bf16 or fp16 x, w and bias of one dtype, got "
                        f"{x.dtype}/{w.dtype}/{None if bias is None else bias.dtype}")
    k_axis = 0 if w_kn else 1
    if x.dim() != 2 or w.dim() != 2 or w.shape[k_axis] != x.shape[1]:
        raise ValueError(f"skinny_matmul: x [M, K] and w {'[K, N]' if w_kn else '[N, K]'}, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1 - k_axis]
    if m == 0 or k == 0 or n == 0:
        raise ValueError(f"skinny_matmul: empty product {tuple(x.shape)} x {tuple(w.shape)}")
    if bias is not None and (bias.shape != (n,) or not bias.is_contiguous()):
        raise ValueError(f"skinny_matmul: the bias must be a contiguous [{n}], got "
                         f"{tuple(bias.shape)}")
    if k % 8 or x.stride(1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(f"skinny_matmul: x needs K % 8 == 0, unit stride along K, a row "
                         f"stride that is a multiple of 8 and a 16-byte aligned base; got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    if not w.is_contiguous() or w.data_ptr() % 16 or (w_kn and n % 8):
        raise ValueError("skinny_matmul: w must be contiguous and 16-byte aligned (and, "
                         "as [K, N], have N % 8 == 0)")


_FN = None


def _fn():
    """The kernel's C entry, loaded once (a launch is on every gated Dense
    call of a forward, so the host path stays short)."""
    global _FN
    if _FN is None:
        fn = getattr(kernels.load(NAME), NAME)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _error(rc: int) -> str:
    if rc == -1:
        return "arguments the kernel does not take"
    if rc == -2:
        return "cuTensorMapEncodeTiled is not available (CUDA 12 or newer needed)"
    if rc <= -1000:
        return f"cuTensorMapEncodeTiled failed with CUresult {-1000 - rc}"
    return f"CUDA error {rc}"


def launch(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], w_kn: bool,
           bn: int) -> torch.Tensor:
    """One launch of the kernel with tile width `bn` on inputs `_check` has
    passed; raises if the launch fails."""
    m, k = x.shape
    n = w.shape[1] if w_kn else w.shape[0]
    o = torch.empty((m, n), dtype=x.dtype, device=x.device)
    dev = x.device.index
    args = (x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            o.data_ptr(), m, n, k, x.stride(0), _DTYPE_CODES[x.dtype], int(w_kn), bn)
    # the launch goes to the current device's current stream; a device guard
    # only where x lies on another device
    if dev == torch.cuda.current_device():
        rc = _fn()(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = _fn()(*args, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: {_error(rc)}")
    kernels.LAUNCHES[NAME] += 1
    return o


def skinny_matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  *, w_kn: bool = False) -> torch.Tensor:
    """x [M, K] (unit stride along K) times w [N, K] transposed, or w [K, N]
    with `w_kn`, plus an optional bias [N]: [M, N] contiguous in x's dtype."""
    if x.device.type == "cpu":
        return skinny_matmul_ref(x, w, bias, w_kn=w_kn)
    _check(x, w, bias, w_kn)
    return launch(x, w, bias, w_kn, tile_n(w.shape[1] if w_kn else w.shape[0], w_kn))


class SkinnyMatmul(torch.autograd.Function):
    """o = x . w^T (+ bias) through `skinny_matmul` (or, with `plain`, its
    plain version). Saves x and w; the backward takes dx = g . w through the
    same function on w as stored, read as [K, N] (`w_kn`), dw = g^T x as one
    plain product in the inputs' dtype, and db = g summed over rows in g's
    dtype (what autograd gives through a bias add)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, plain: bool,
                bias: Optional[torch.Tensor] = None):
        ctx.save_for_backward(x, w)
        ctx.plain = plain
        ctx.has_bias = bias is not None
        return (skinny_matmul_ref if plain else skinny_matmul)(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mm = skinny_matmul_ref if ctx.plain else skinny_matmul
        g = g.contiguous()
        dx = mm(g, w, w_kn=True) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(g.t(), x) if ctx.needs_input_grad[1] else None
        db = g.sum(0) if ctx.has_bias and ctx.needs_input_grad[3] else None
        return dx, dw, None, db

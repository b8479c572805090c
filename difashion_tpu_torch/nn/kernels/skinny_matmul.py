"""Skinny-N matrix product: the CUDA kernels' wrappers, their plain versions,
the Dense layers' gate, and the autograd Function over both.

Port of `tools/pallas_skinny_matmul.py::_mm_kernel` (through `_mm_call`, the
`_matmul` custom VJP, `matmul_2d` and `pallas_dense_dot`): o = x . w^T
(+ bias) for x [M, K] and a weight in `nn.Linear`'s [N, K] layout (or, with
`w_kn=True`, one given as [K, N]), summed in fp32; a bias is added to the
rounded product, as flax's Dense adds its bias after the dot_general.
  * bf16 and fp16 -> `csrc/skinny_matmul.cu`: one fp32 sum rounded once to
    x's dtype, the bias sum rounded again.
  * fp32 -> `csrc/skinny_matmul_f32.cu`, counted as `skinny_matmul_f32`:
    3xTF32 on the tensor cores (each operand split into a TF32 high part and
    a TF32 remainder, three products summed; `tf32.mm_3xtf32`), which keeps
    fp32 accuracy and so, like the fp32 flash kernels, is not gated by
    `torch.backends.cuda.matmul.allow_tf32`.

`dense_route` is the gate of `pallas_dense_dot`, with a CUDA tensor in place
of `_on_tpu()`: a 2-D weight with N <= 1280 columns and at most 8 MiB in the
compute dtype, x and the weight of one compute dtype (bf16, fp16 or fp32),
and M = the product of x's leading dimensions with M >= 2048 and
M % 512 == 0. The compute dtype is autocast's where autocast is on (bf16
training over fp32 master weights), as flax's Dense computes in its `dtype`.
The kernels also read x's rows in 16-byte pieces, which the TPU kernel's
(block_m, K) blocks do not need: `aligned` holds that rule on the x that a
Dense would pass (after its cast and reshape), and a product it refuses goes
to `F.linear`, as the JAX model's Dense computes any shape. dx = g . w reads
g [M, N] by the same rule; where g fails it, dx alone is a plain product.

`skinny_matmul` launches the kernel of x's dtype for CUDA tensors and raises
on what the kernels do not take; for CPU tensors it computes the plain
version (`skinny_matmul_ref`, fp32 sums), which the CPU tests hold against
the JAX kernel in interpret mode. `skinny_matmul_3xtf32_ref` is the fp32
kernel's arithmetic in plain PyTorch (the split products): the tests and
`chip_smoke.py` hold the fp32 kernel against it. `tile_n` is the 16-bit
kernel's output tile width per N, chosen by measurement on the H100
(`scripts/skinny_matmul_tiles.py`); the fp32 kernel's is 128 at every N,
the widest whose two sets of fp32 accumulators fit a thread's registers.
`SkinnyMatmul` is the counterpart of the `_matmul` custom VJP: the forward
is the kernel, dx = g . w is the kernel again on the stored [N, K] weight
read as [K, N] (no transposed copy), dw = g^T x is a plain product, as the
JAX package leaves it to XLA, and db = g summed over rows.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from difashion_tpu_torch.nn import kernels
from difashion_tpu_torch.nn.kernels.tf32 import mm_3xtf32

NAME = "skinny_matmul"
NAME_F32 = "skinny_matmul_f32"         # the fp32 kernel's source, C entry and counter
MAX_N = 1280
MAX_W_BYTES = 8 * 1024 * 1024
MIN_M = 2048
M_MULTIPLE = 512
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
TILE_WIDTHS = (128, 160, 256)          # the widths the 16-bit kernel is built for
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


def skinny_matmul_3xtf32_ref(x: torch.Tensor, w: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             w_kn: bool = False) -> torch.Tensor:
    """The fp32 kernel's arithmetic in plain PyTorch: x [M, K] times w [N, K]
    transposed (w [K, N] with `w_kn`) as three fp32 products of TF32-split
    operands (`mm_3xtf32`), and the bias added to the sum. fp32 only; for the
    tests and `chip_smoke.py` (the kernel sums in another order)."""
    for t in (x, w) if bias is None else (x, w, bias):
        if t.dtype != torch.float32:
            raise TypeError(f"skinny_matmul_3xtf32_ref: fp32 inputs, got {t.dtype}")
    y = mm_3xtf32(x, w if w_kn else w.t())
    return y if bias is None else y.add_(bias)


def compute_dtypes(x: torch.Tensor, weight: torch.Tensor) -> Tuple[torch.dtype, torch.dtype]:
    """The dtypes in which a Dense multiplies x and its weight: autocast's for
    both where it is on for x's device, else their own."""
    if torch.is_autocast_enabled(x.device.type):
        dtype = torch.get_autocast_dtype(x.device.type)
        return dtype, dtype
    return x.dtype, weight.dtype


def gate(rows: int, n: int, k: int, x_dtype: torch.dtype, w_dtype: torch.dtype) -> bool:
    """`pallas_dense_dot`'s conditions on a product of `rows` rows of x with
    an [n, k] weight in these compute dtypes: one dtype, a kernel's."""
    return (n <= MAX_N and n * k * w_dtype.itemsize <= MAX_W_BYTES and x_dtype == w_dtype
            and x_dtype in KERNEL_DTYPES and rows >= MIN_M and rows % M_MULTIPLE == 0)


def dense_route(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether `x @ weight.T` goes through the kernel: a CUDA tensor and
    `gate`. A function of shapes, dtypes, device and the autocast state."""
    if x.device.type != "cuda" or weight.dim() != 2 or x.dim() < 1:
        return False
    return gate(math.prod(x.shape[:-1]), weight.shape[0], weight.shape[1],
                *compute_dtypes(x, weight))


def aligned(x: torch.Tensor) -> bool:
    """Whether the kernels read x [M, K] as it lies: rows in 16-byte pieces
    (8 values of 16 bits, 4 of fp32), so K a multiple of that, unit stride
    along K, a row stride that is a multiple of it and a 16-byte-aligned
    base. A function of shape, strides, dtype and address."""
    vec = 16 // x.element_size()
    return (x.dim() == 2 and x.shape[1] % vec == 0 and x.stride(1) == 1
            and x.stride(0) % vec == 0 and x.data_ptr() % 16 == 0)


def _check(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], w_kn: bool) -> None:
    if not (x.is_cuda and w.device == x.device
            and (bias is None or bias.device == x.device)):
        raise ValueError("skinny_matmul: x, w and the bias must lie on one CUDA device")
    if (x.dtype not in KERNEL_DTYPES or w.dtype != x.dtype
            or (bias is not None and bias.dtype != x.dtype)):
        raise TypeError(f"skinny_matmul: bf16, fp16 or fp32 x, w and bias of one dtype, got "
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
    vec = 16 // x.element_size()
    if not aligned(x):
        raise ValueError(f"skinny_matmul: x needs K % {vec} == 0, unit stride along K, a row "
                         f"stride that is a multiple of {vec} and a 16-byte aligned base; got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    if not w.is_contiguous() or w.data_ptr() % 16 or (w_kn and n % vec):
        raise ValueError(f"skinny_matmul: w must be contiguous and 16-byte aligned (and, "
                         f"as [K, N], have N % {vec} == 0)")


_FNS = {}


def _entry(name: str, ints: int):
    """A kernel's C entry (x, w, bias, o, M, N, K, ldx, `ints` ints, the
    stream), loaded once (a launch is on every gated Dense call of a
    forward, so the host path stays short)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(kernels.load(name), name)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                       + [ctypes.c_int] * ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _fn():
    """The 16-bit kernel's C entry (dtype code, w_kn, BN)."""
    return _entry(NAME, 3)


def _fn_f32():
    """The fp32 kernel's C entry (w_kn)."""
    return _entry(NAME_F32, 1)


def _error(rc: int) -> str:
    if rc == -1:
        return "arguments the kernel does not take"
    if rc == -2:
        return "cuTensorMapEncodeTiled is not available (CUDA 12 or newer needed)"
    if rc <= -1000:
        return f"cuTensorMapEncodeTiled failed with CUresult {-1000 - rc}"
    return f"CUDA error {rc}"


def launch(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], w_kn: bool,
           bn: Optional[int] = None) -> torch.Tensor:
    """One launch of the kernel of x's dtype on inputs `_check` has passed
    (the 16-bit kernel with tile width `bn`; the fp32 kernel's is fixed);
    raises if the launch fails."""
    m, k = x.shape
    n = w.shape[1] if w_kn else w.shape[0]
    o = torch.empty((m, n), dtype=x.dtype, device=x.device)
    dev = x.device.index
    args = (x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            o.data_ptr(), m, n, k, x.stride(0))
    if x.dtype == torch.float32:
        name, fn, args = NAME_F32, _fn_f32(), args + (int(w_kn),)
    else:
        name, fn, args = NAME, _fn(), args + (_DTYPE_CODES[x.dtype], int(w_kn), bn)
    kernels.bind_context(dev)
    # the launch goes to the current device's current stream; a device guard
    # only where x lies on another device
    if dev == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {_error(rc)}")
    kernels.LAUNCHES[name] += 1
    return o


def skinny_matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  *, w_kn: bool = False) -> torch.Tensor:
    """x [M, K] (unit stride along K) times w [N, K] transposed, or w [K, N]
    with `w_kn`, plus an optional bias [N]: [M, N] contiguous in x's dtype."""
    if x.device.type == "cpu":
        return skinny_matmul_ref(x, w, bias, w_kn=w_kn)
    _check(x, w, bias, w_kn)
    if x.dtype == torch.float32:
        return launch(x, w, bias, w_kn)
    return launch(x, w, bias, w_kn, tile_n(w.shape[1] if w_kn else w.shape[0], w_kn))


class SkinnyMatmul(torch.autograd.Function):
    """o = x . w^T (+ bias) through `skinny_matmul` (or, with `plain`, its
    plain version). Saves x and w; the backward takes dx = g . w through the
    same function on w as stored, read as [K, N] (`w_kn`), where g is
    `aligned` (N a multiple of 16 bytes' worth of values), else through
    `torch.matmul`; dw = g^T x as one plain product in the inputs' dtype, and
    db = g summed over rows in g's dtype (what autograd gives through a bias
    add)."""

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
        dx = None
        if ctx.needs_input_grad[0]:
            dx = mm(g, w, w_kn=True) if aligned(g) else torch.matmul(g, w)
        dw = torch.matmul(g.t(), x) if ctx.needs_input_grad[1] else None
        db = g.sum(0) if ctx.has_bias and ctx.needs_input_grad[3] else None
        return dx, dw, None, db

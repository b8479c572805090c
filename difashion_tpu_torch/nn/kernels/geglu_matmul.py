"""GEGLU in one kernel: the CUDA kernel's wrapper, its plain version and the
route of `nn.layers.GEGLU`.

`geglu_matmul(x, w, bias)` computes `h * gelu(gate)` where
`[h | gate] = x . w^T + bias`, for x [M, K], the projection's weight in
`nn.Linear`'s [2F, K] layout (the F h rows, then the F gate rows) and its
bias [2F]: [M, F]. It is the port's own fusion, with no TPU counterpart (the
JAX package leaves its GEGLU to XLA, which fuses the gate into the product):
`csrc/geglu_matmul.cu` never writes the 2F-wide pre-activation, which the
unfused path wrote and read back in two strided elementwise passes. The
arithmetic is the JAX GEGLU's (flax's Dense rounds the dot to the dtype and
adds the bias after it, then the exact gelu and the product), step for step
in the kernel's dtype:

    hb  = round(round(x . w_h^T) + b_h)       gb = round(round(x . w_g^T) + b_g)
    g   = round(gelu(gb))                      gelu in fp32, erf, not tanh
    out = round(hb * g)

each product one fp32 sum. `geglu_matmul_ref` is that in plain PyTorch: CPU
tensors take it, and the tests and `chip_smoke.py` hold the kernel against
it. For a CUDA tensor the wrapper launches the kernel or raises on what it
does not take (bf16 or fp16 only, F a multiple of `TILE_F`, x read in place
by `skinny_matmul.aligned`'s rule). `tile_width` is the kernel's output tile
width per K, chosen by measurement on the H100.

`geglu_route` is `GEGLU.forward`'s test for the kernel: a CUDA tensor, one
16-bit compute dtype for x and the weight (`skinny_matmul.compute_dtypes`:
autocast's where it is on), F a multiple of `TILE_F`, and autograd not
recording (the kernel has no backward: training keeps the unfused path,
whose backward autograd writes). Each is observed on the call's inputs.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from difashion_tpu_torch.nn import kernels
from difashion_tpu_torch.nn.kernels import skinny_matmul as sm

NAME = "geglu_matmul"
KERNEL_DTYPES = (torch.bfloat16, torch.float16)
TILE_WIDTHS = (64, 128)      # the output tile widths (BN) the kernel is built for
TILE_F = 128                 # F must be a multiple of it (and so of every width)


def tile_width(k: int) -> int:
    """The kernel's output tile width (BN) for a K-deep projection, measured
    on an H100 (scripts/geglu_matmul.py): 64 at the UNet's 4096- and
    1024-token sites (K = 320, 640), 128 from K = 1280."""
    return 128 if k >= 1280 else 64


def geglu_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: x [M, K], w [2F, K], bias [2F] or None -> [M, F] in
    x's dtype, rounded where the kernel (and the JAX GEGLU) rounds: the
    product summed in fp32, then the bias, the gelu (`gelu_erf`, in fp32)
    and the product each rounded to x's dtype."""
    y = (x.float() @ w.float().t()).to(x.dtype)
    if bias is not None:
        y = (y.float() + bias.float()).to(x.dtype)
    h, gate = y.chunk(2, dim=-1)
    return (h.float() * gelu_erf(gate.float()).to(x.dtype).float()).to(x.dtype)


def gelu_erf(v: torch.Tensor) -> torch.Tensor:
    """The exact gelu as PyTorch's CUDA GELU kernel and the kernel's
    epilogue compute it: v * 0.5 * (1 + erf(v * sqrt(1/2))), left to right,
    in v's dtype (fp32 here)."""
    return v * 0.5 * (1.0 + torch.erf(v * math.sqrt(0.5)))


def rounding_gap_bound(x: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """How far another correctly rounded evaluation of `geglu_matmul_ref`
    may land from it, element by element, for the tests and
    `chip_smoke.py`: where two fp32 sums over K differ in order (the kernel's
    wgmma against a plain product), or the bias is added before the first
    rounding (`F.linear`), each of h and gate may round one unit in the last
    place apart (u: 2^-7 bf16, 2^-10 fp16) of the product and of its bias
    sum, and the two fp32 sums themselves lie up to K units of fp32 of the
    sum of the products' magnitudes apart (cancellation); that gap carried
    through the gelu (|gelu'| <= 1.13) and the product, plus one unit of the
    output. [M, F] in fp32."""
    u = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -10
    p = x.float() @ w.float().t()
    e = x.shape[1] * 2.0 ** -23 * (x.float().abs() @ w.float().abs().t())
    y = p.to(x.dtype).float()
    if bias is not None:
        y = (y + bias.float()).to(x.dtype).float()
    f = w.shape[0] // 2
    h, gate = y[:, :f], y[:, f:]
    g = gelu_erf(gate).to(x.dtype).float()
    dh = 2 * u * (p[:, :f].abs() + h.abs()) + e[:, :f]
    dg = 2 * u * (p[:, f:].abs() + gate.abs()) + e[:, f:]
    return dh * g.abs() + (h.abs() + dh) * 1.13 * dg + 2 * u * (h * g).abs()


def recording(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records a call on these tensors: the test `sdpa`
    and `Dense` make before they choose a path without a backward."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def geglu_gate(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> bool:
    """The route's conditions on any device: a 16-bit compute dtype shared
    by x and the weight, F (half the weight's rows) a multiple of `TILE_F`,
    and autograd not recording."""
    if weight.dim() != 2 or x.dim() < 1 or x.shape[-1] != weight.shape[1]:
        return False
    x_dtype, w_dtype = sm.compute_dtypes(x, weight)
    return (x_dtype == w_dtype and x_dtype in KERNEL_DTYPES
            and weight.shape[0] % (2 * TILE_F) == 0 and not recording(x, weight, bias))


def geglu_route(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> bool:
    """Whether GEGLU's projection `x @ weight.T + bias`, gate and product go
    through the kernel: a CUDA tensor and `geglu_gate`. `aligned` is checked
    by the caller on the x it passes."""
    return x.device.type == "cuda" and geglu_gate(x, weight, bias)


def _check(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if not (x.is_cuda and w.device == x.device
            and (bias is None or bias.device == x.device)):
        raise ValueError("geglu_matmul: x, w and the bias must lie on one CUDA device")
    check_operands(x, w, bias)


def check_operands(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """The wrapper's checks other than the device's: dtypes, shapes, the
    layout the kernel reads (raises on what it does not take)."""
    if (x.dtype not in KERNEL_DTYPES or w.dtype != x.dtype
            or (bias is not None and bias.dtype != x.dtype)):
        raise TypeError(f"geglu_matmul: bf16 or fp16 x, w and bias of one dtype, got "
                        f"{x.dtype}/{w.dtype}/{None if bias is None else bias.dtype}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"geglu_matmul: x [M, K] and w [2F, K], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    if m == 0 or k == 0 or w.shape[0] == 0:
        raise ValueError(f"geglu_matmul: empty product {tuple(x.shape)} x {tuple(w.shape)}")
    if w.shape[0] % (2 * TILE_F):
        raise ValueError(f"geglu_matmul: F = {w.shape[0] // 2} (half of w's rows) must be a "
                         f"multiple of {TILE_F}")
    if bias is not None and (bias.shape != (w.shape[0],) or not bias.is_contiguous()):
        raise ValueError(f"geglu_matmul: the bias must be a contiguous [{w.shape[0]}], got "
                         f"{tuple(bias.shape)}")
    if not sm.aligned(x):
        raise ValueError(f"geglu_matmul: x needs K % 8 == 0, unit stride along K, a row "
                         f"stride that is a multiple of 8 and a 16-byte aligned base; got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("geglu_matmul: w must be contiguous and 16-byte aligned")


def _fn():
    """The kernel's C entry (dtype code, BN)."""
    return sm._entry(NAME, 2)


def launch(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           bn: int) -> torch.Tensor:
    """One launch of the kernel on inputs `_check` has passed, with output
    tile width `bn` (one of `TILE_WIDTHS`, dividing F); raises if the launch
    fails."""
    m, k = x.shape
    f = w.shape[0] // 2
    o = torch.empty((m, f), dtype=x.dtype, device=x.device)
    dev = x.device.index
    args = (x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            o.data_ptr(), m, f, k, x.stride(0), sm._DTYPE_CODES[x.dtype], bn)
    fn = _fn()
    kernels.bind_context(dev)
    if dev == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: {sm._error(rc)}")
    kernels.LAUNCHES[NAME] += 1
    return o


def gelu_all(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The kernel epilogue's round(gelu(v)) for every 16-bit pattern v of
    `dtype` (bf16 or fp16), in order of the pattern: [65536] int16, the
    results' bits. For the tests, which hold it against PyTorch's GELU."""
    fn = kernels.load(NAME).geglu_gelu_all
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(65536, dtype=torch.int16, device=device)
    kernels.bind_context(out.device.index)
    with torch.cuda.device(out.device):
        rc = fn(out.data_ptr(), sm._DTYPE_CODES[dtype],
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"geglu_gelu_all launch failed: {sm._error(rc)}")
    return out


def geglu_matmul(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h * gelu(gate) of [h | gate] = x [M, K] . w [2F, K]^T + bias [2F]:
    [M, F] contiguous in x's dtype."""
    if x.device.type == "cpu":
        return geglu_matmul_ref(x, w, bias)
    _check(x, w, bias)
    return launch(x, w, bias, tile_width(x.shape[1]))

"""GroupNorm (+ SiLU): the CUDA kernel's wrapper, its plain version, and the
autograd Function over both.

Port of `difashion_tpu/nn/pallas/groupnorm.py::_gn_silu_kernel` (through
`_pallas_gn_silu`) -> `csrc/group_norm_silu.cu`: GroupNorm over contiguous
NCHW x with fp32 group statistics (biased variance), the per-channel affine
y = x * a + b (a = scale * rstd, b = bias - mean * a) in fp32, y rounded to
the input dtype, then the optional SiLU, rounded again. The JAX kernel has a
VMEM ceiling that leaves the VAE's 512x512 levels to XLA; this one has none.

`group_norm_silu` launches the kernel for CUDA tensors and raises on what the
kernel does not take; for CPU tensors it computes the plain version
(`group_norm_silu_ref`), which the CPU tests hold against the JAX package.
`GroupNormSiLU` is the counterpart of the `_gn_silu` custom VJP: the forward
is the kernel and saves only x; the backward recomputes through the plain
version, as the JAX package's does (there is no backward kernel).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from difashion_tpu_torch.nn import kernels

NAME = "group_norm_silu"
ACTS = (None, "silu")
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_THREADS, _VECS_PER_THREAD, _VEC_BYTES = 256, 2, 16
# blocks per call the chunking aims at: about 16 per SM of the H100's 132,
# so that a small batch (the VAE decode's 4 x 32 groups) still fills the card
_TARGET_BLOCKS = 2048
_MAX_CHUNKS = 65535


def group_norm_silu_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        groups: int, eps: float, act: Optional[str] = None
                        ) -> torch.Tensor:
    """Plain version: GroupNorm over [B, C, *spatial] in fp32 (biased
    variance), the fp32 affine, the result in x's dtype, then the optional
    SiLU in that dtype (`_gn_silu_ref`'s order)."""
    y = F.group_norm(x.float(), groups, scale.float(), bias.float(), eps).to(x.dtype)
    return F.silu(y) if act == "silu" else y


def tile_elements(dtype: torch.dtype) -> int:
    """Elements of one tile of the kernel: 256 threads x 2 vectors of 16 bytes."""
    return _THREADS * _VECS_PER_THREAD * (_VEC_BYTES // dtype.itemsize)


def chunking(span: int, n_groups: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(chunks per group, tiles per chunk) for groups of `span` elements: about
    _TARGET_BLOCKS blocks in all, every chunk whole tiles and none empty."""
    tiles = -(-span // tile_elements(dtype))
    want = min(tiles, _MAX_CHUNKS, max(1, -(-_TARGET_BLOCKS // n_groups)))
    per_chunk = -(-tiles // want)
    return -(-tiles // per_chunk), per_chunk


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
           act: Optional[str]) -> None:
    if not (x.is_cuda and scale.device == x.device and bias.device == x.device):
        raise ValueError("group_norm_silu: x, scale and bias must lie on one CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm_silu: bf16, fp16 or fp32 x, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"group_norm_silu: x must be a non-empty [B, C, *spatial], "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"group_norm_silu: x must be contiguous (NCHW), got strides "
                         f"{x.stride()}")
    c = x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"group_norm_silu: {c} channels are not divisible into {groups} groups")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm_silu: scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be [{c}]")
    if act not in ACTS:
        raise ValueError(f"group_norm_silu: unknown activation {act!r}")
    if x.numel() // (x.shape[0] * groups) >= 2 ** 31 or x.shape[0] * groups >= 2 ** 31:
        raise ValueError(f"group_norm_silu: {tuple(x.shape)} in {groups} groups is beyond "
                         "the kernel's index range")


def _fn():
    fn = getattr(kernels.load(NAME), NAME)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(+SiLU) of contiguous x [B, C, *spatial] (bf16, fp16 or fp32)
    with scale and bias [C] (any float dtype, used in fp32). Returns y in x's
    dtype and shape."""
    if x.device.type == "cpu":
        return group_norm_silu_ref(x, scale, bias, groups, eps, act)
    _check(x, scale, bias, groups, act)
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    cg = c // groups
    span, n_groups = cg * hw, b * groups
    chunks, per_chunk = chunking(span, n_groups, x.dtype)
    vec = _VEC_BYTES // x.element_size()
    y = torch.empty_like(x)
    partials = torch.empty(n_groups * chunks * 3, dtype=torch.float32, device=x.device)
    scale32 = scale.detach().float().contiguous()
    bias32 = bias.detach().float().contiguous()
    vector = hw % vec == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), y.data_ptr(),
                   partials.data_ptr(), n_groups, span, hw, cg, groups, chunks, per_chunk,
                   float(eps), int(act == "silu"), _DTYPE_CODES[x.dtype], int(vector),
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {rc}")
    kernels.LAUNCHES[NAME] += 1
    return y


class GroupNormSiLU(torch.autograd.Function):
    """y = GroupNorm(+SiLU)(x) through `group_norm_silu` (the kernel on CUDA).
    Saves x, scale and bias (the inputs, no activation of its own); the
    backward recomputes the plain version under autograd and takes its
    gradients, in the dtypes the plain version gives with or without
    autocast."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, scale, bias, groups: int, eps: float, act: Optional[str]):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps, ctx.act = groups, eps, act
        return group_norm_silu(x, scale, bias, groups, eps, act)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip((x, scale, bias), ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            y = group_norm_silu_ref(*leaves, ctx.groups, ctx.eps, ctx.act)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return tuple(next(grads) if t.requires_grad else None for t in leaves) + (None,) * 3

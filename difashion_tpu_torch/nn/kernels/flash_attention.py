"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Port of `difashion_tpu/nn/pallas/flash_attention.py::_fwd_kernel` (reached
through `_forward` and `flash_attention`). The kernel is
`difashion_tpu_torch/csrc/flash_attention_fwd.cu`: non-causal attention with an
online softmax in fp32, bf16/fp16 operands on the tensor cores, ragged KV
masked in the kernel. It returns O in the input dtype and the per-row
natural-log LSE in fp32 as [B*H, Sq] (the training slice's backward needs it).

`flash_attention` launches the kernel for CUDA tensors and raises on what the
kernel does not take. For CPU tensors it computes the plain version,
`flash_attention_ref`, which the CPU tests hold against the JAX kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from difashion_tpu_torch.nn import kernels

NAME = "flash_attention_fwd"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: q [B, H, Sq, D], k/v [B, H, Skv, D] -> (o [B, H, Sq, D]
    in q's dtype, lse [B*H, Sq] fp32). Logits, softmax and the product with V
    in fp32; a ragged KV is simply its own length."""
    b, h, sq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), lse.reshape(b * h, sq)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: bf16 or fp16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, S, D]")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash_attention: empty sequence")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds the grid limit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # the kernel copies rows in 16-byte vectors: last dim contiguous, every
        # other stride a multiple of 8 elements, a 16-byte aligned base
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} strides {t.stride()} / alignment "
                "not supported (last dim contiguous, others multiples of 8)")


def _lib() -> ctypes.CDLL:
    lib = kernels.load(NAME)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention. q [B, H, Sq, D], k/v [B, H, Skv, D], any strides
    with a contiguous last dim (so the [B, S, H, D] view of a projection is
    read in place). Returns (o, lse): o [B, H, Sq, D] in q's dtype, laid out
    as [B, Sq, H, D] in memory; lse [B*H, Sq] fp32, natural log."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale)
    _check(q, k, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, sq, skv, d, ctypes.addressof(strides),
            float(scale), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    kernels.LAUNCHES[NAME] += 1
    return o, lse

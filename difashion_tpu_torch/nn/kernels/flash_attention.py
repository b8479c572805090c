"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd Function over both.

Ports of `difashion_tpu/nn/pallas/flash_attention.py`:
  * `_fwd_kernel` (through `_forward`) -> `csrc/flash_attention_fwd.cu`:
    non-causal attention with an online softmax in fp32, bf16/fp16 operands
    on the tensor cores, ragged KV masked in the kernel. Returns O in the input
    dtype and the per-row natural-log LSE in fp32 as [B*H, Sq].
  * `_dq_kernel` (through `_backward`) -> `csrc/flash_attention_dq.cu`:
    dQ = scale * [P * (dO V^T - D)] K with P recomputed from the LSE.
  * `_dkv_kernel` (through `_backward`) -> `csrc/flash_attention_dkv.cu`:
    dV = P^T dO and dK = scale * [P * (dO V^T - D)]^T Q.
D = rowsum(dO * O) is plain torch in fp32 (`attention_delta`), as the JAX
package leaves it to XLA. `FlashAttention` is the counterpart of the
`_flash_core` custom VJP: its forward saves q, k, v, o and the LSE, its
backward runs the two backward kernels.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take. For CPU tensors it computes its plain version
(`flash_attention_ref`, `flash_attention_dq_ref`, `flash_attention_dkv_ref`),
which the CPU tests hold against the JAX kernels. The plain backward rounds P
and dS to the input dtype before their products, as the kernels do (a no-op
in fp32).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from difashion_tpu_torch.nn import kernels

NAME = "flash_attention_fwd"
DQ_NAME = "flash_attention_dq"
DKV_NAME = "flash_attention_dkv"
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


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, [B*H, Sq]: the backward's per-row constant."""
    b, h, sq, _ = o.shape
    return (do.float() * o.float()).sum(-1).reshape(b * h, sq)


def _probs(q, k, lse, scale):
    """P = exp(scale * Q K^T - LSE) in fp32, [B, H, Sq, Skv]."""
    b, h, sq, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(scale)
    return s.sub_(lse.reshape(b, h, sq, 1)).exp_()


def _dscores(p, do, v, delta):
    """dS = P * (dO V^T - D) in fp32; overwrites nothing of p."""
    b, h, sq, _ = p.shape
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return dp.sub_(delta.reshape(b, h, sq, 1)).mul_(p)


def flash_attention_dq_ref(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """Plain version of the dQ kernel: dQ [B, H, Sq, D] in q's dtype. dS is
    rounded to q's dtype before the product with K."""
    ds = _dscores(_probs(q, k, lse, scale), do, v, delta)
    dq = torch.matmul(ds.to(q.dtype).float(), k.float()).mul_(scale)
    return dq.to(q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, delta, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: (dK, dV) [B, H, Skv, D] in k's and
    v's dtypes. P and dS are rounded to the input dtype before their
    products with dO and Q."""
    p = _probs(q, k, lse, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    ds = _dscores(p, do, v, delta)
    del p
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()).mul_(scale)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of `flash_attention_ref` from the LSE-recompute
    formulas: (dq, dk, dv) for the cotangent `do` of o."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = attention_delta(o, do)
    dq = flash_attention_dq_ref(q, k, v, do, lse, delta, scale)
    return (dq,) + flash_attention_dkv_ref(q, k, v, do, lse, delta, scale)


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
        if not _strides_ok(t):
            raise ValueError(
                f"flash_attention: {name} strides {t.stride()} / alignment "
                "not supported (last dim contiguous, others multiples of 8)")


def _strides_ok(t: torch.Tensor) -> bool:
    """The kernels copy rows in 16-byte vectors: last dim contiguous, every
    other stride a multiple of 8 elements, a 16-byte aligned base."""
    return t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _lib(name: str, nargs_ptr: int, nargs_int: int) -> ctypes.CDLL:
    """The kernel's library with its C function's argument types set: the
    pointers, the ints, then strides, scale, dtype and stream."""
    lib = kernels.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * nargs_ptr + [ctypes.c_int] * nargs_int + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, tensors, ints, strided, scale: float, dtype) -> None:
    """Call kernel `name` on the current stream with the data pointers of
    `tensors`, the ints, and the (batch, head, seq) element strides of the
    `strided` tensors; raise on a launch error; count the launch."""
    strides = [s for t in strided for s in t.stride()[:3]]
    st = (ctypes.c_int64 * len(strides))(*strides)
    fn = getattr(_lib(name, len(tensors), len(ints)), name)
    dev = tensors[0].device
    with torch.cuda.device(dev):
        rc = fn(*(t.data_ptr() for t in tensors), *ints, ctypes.addressof(st),
                float(scale), _DTYPE_CODES[dtype],
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    kernels.LAUNCHES[name] += 1


def _empty_bshd(b: int, h: int, s: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] tensor whose memory is [B, S, H, D], so that merging the
    heads (or the projection's backward) needs no copy."""
    return torch.empty(b, s, h, d, dtype=like.dtype, device=like.device).transpose(1, 2)


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
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o = _empty_bshd(b, h, sq, d, q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    _launch(NAME, (q, k, v, o, lse), (b, h, sq, k.shape[2], d), (q, k, v, o),
            scale, q.dtype)
    return o, lse


def _bwd_inputs(q, k, v, do, lse, delta):
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_attention backward: dO {tuple(do.shape)} "
                         f"{do.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    want = (q.shape[0] * q.shape[1], q.shape[2])
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != want or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} must be a contiguous "
                             f"fp32 {want} tensor on q's device")
    # dO comes from autograd in whatever strides it has
    return do if _strides_ok(do) else do.contiguous()


def flash_attention_dq(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """dQ [B, H, Sq, D] in q's dtype (memory [B, Sq, H, D]) from the forward's
    LSE and D = `attention_delta(o, do)`, both [B*H, Sq] fp32."""
    if q.device.type == "cpu":
        return flash_attention_dq_ref(q, k, v, do, lse, delta, scale)
    do = _bwd_inputs(q, k, v, do, lse, delta)
    b, h, sq, d = q.shape
    dq = _empty_bshd(b, h, sq, d, q)
    _launch(DQ_NAME, (q, k, v, do, lse, delta, dq), (b, h, sq, k.shape[2], d),
            (q, k, v, do, dq), scale, q.dtype)
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B, H, Skv, D] in the input dtype (memory [B, Skv, H, D])."""
    if q.device.type == "cpu":
        return flash_attention_dkv_ref(q, k, v, do, lse, delta, scale)
    do = _bwd_inputs(q, k, v, do, lse, delta)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    dk, dv = _empty_bshd(b, h, skv, d, k), _empty_bshd(b, h, skv, d, v)
    _launch(DKV_NAME, (q, k, v, do, lse, delta, dk, dv), (b, h, sq, skv, d),
            (q, k, v, do, dk, dv), scale, q.dtype)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` for the cotangent `do` of o: D in
    torch, then the dQ and the dK/dV kernels (their plain versions on the
    CPU)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = attention_delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, scale)
    return (dq,) + flash_attention_dkv(q, k, v, do, lse, delta, scale)


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with the flash kernels in both directions (or,
    with `plain=True`, their plain versions). Saves q, k, v, o and the LSE;
    the backward recomputes P from the LSE."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, scale: float, plain: bool = False):
        o, lse = (flash_attention_ref if plain else flash_attention)(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.plain = scale, plain
        return o

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_ref if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None, None

"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd Function over both.

Ports of `difashion_tpu/nn/pallas/flash_attention.py`:
  * `_fwd_kernel` (through `_forward`) -> `csrc/flash_attention_fwd.cu`:
    non-causal attention with an online softmax in fp32, bf16/fp16 operands
    on the tensor cores (TMA, wgmma, warp specialisation), ragged KV masked
    in the kernel. Returns O in the input dtype and the per-row natural-log
    LSE in fp32 as [B*H, Sq].
  * `_dq_kernel` (through `_backward`) -> `csrc/flash_attention_dq.cu`:
    dQ = scale * [P * (dO V^T - D)] K with P recomputed from the LSE.
  * `_dkv_kernel` (through `_backward`) -> `csrc/flash_attention_dkv.cu`:
    dV = P^T dO and dK = scale * [P * (dO V^T - D)]^T Q; where its KV tiles
    are too few to fill the card, the query range is split in parts
    (`dkv_splits`) whose fp32 partial sums the same source adds in split
    order, into a workspace the wrapper allocates.
  The 16-bit kernels are built the same way (TMA, wgmma, warp
  specialisation, persistent grids) and read the head dim in place.
  * all three for fp32 inputs -> `csrc/flash_attention_f32.cu` (SIMT FFMA,
    no tf32, no 16-bit rounding), counted as `flash_attention_fwd_f32`,
    `flash_attention_dq_f32` and `flash_attention_dkv_f32`.
D = rowsum(dO * O) is plain torch in fp32 (`attention_delta`), as the JAX
package leaves it to XLA. `FlashAttention` is the counterpart of the
`_flash_core` custom VJP: its forward saves q, k, v, o and the LSE, its
backward runs the two backward kernels.

Every head dim up to 128 runs on the kernels, in bf16, fp16 and fp32, as the
Pallas kernel takes any d <= 128. `kernel_head_dim` works out, in one place,
what the kernels are handed for a head dim d, the same for the forward and
the backward (`pad_head_dim` makes the zero-padded copies where d % 8 != 0
in 16 bits): zero columns of Q, K, V and dO leave S, dP, D and the kept
columns of O, dQ, dK and dV exactly as they were, and the scale stays
1/sqrt(d) of the unpadded d.

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
F32_SOURCE = "flash_attention_f32"     # the fp32 kernels' source; each counts as <name>_f32
MAX_HEAD_DIM = 128
FWD_HEAD_DIMS = (64, 128)              # the 16-bit kernels' padded head dims (TMA zero fill)
# The dK/dV kernel's tile per padded head dim, as csrc/flash_attention_dkv.cu
# builds it (kTile64, kTile128): (consumer warpgroups, i.e. a KV tile of 64
# rows each; rows of a Q tile). The split plan reads it.
DKV_TILES = {64: (2, 64), 128: (1, 64)}
SM_COUNT = 132                         # an H100 SXM's SMs: the split plan's target
SPLIT_MIN_Q_TILES = 8                  # the fewest Q tiles a part of a split has
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def kernel_head_dim(d: int, dtype: torch.dtype, backward: bool = False) -> int:
    """The head dim the kernels are handed for a true head dim d <= 128, the
    same for the forward and (`backward=True`) the dQ and dK/dV kernels:
      * fp32: d (the SIMT kernels take any d, padding their tiles in place);
      * 16 bits: d where d % 8 == 0, read in place (the kernels' TMA boxes
        are 64 columns wide and zero-fill up to 64 or 128: sd15's 40 and 80
        need no copy); any other d rounded up to a multiple of 8 (a padded
        copy: TMA takes strides in multiples of 16 bytes).
    """
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in 1..{MAX_HEAD_DIM}")
    if dtype == torch.float32:
        return d
    return -(-d // 8) * 8


def dkv_splits(b: int, h: int, sq: int, skv: int, d: int) -> int:
    """How many parts the dK/dV kernel splits the query range into, for a
    16-bit call at head dim d <= 128 with its tile (`DKV_TILES`). Where its
    (KV tile, batch * head) tiles leave most of SM_COUNT SMs idle, as many
    parts as one wave of SMs takes, each of at least SPLIT_MIN_Q_TILES Q
    tiles (a part's saving has to pay for the workspace pass), counted again
    so that no part is empty; else 1. Of the training step's sites that
    splits the 77-token cross-attention at 4096 tokens only (measured by
    scripts/flash_bwd_tiles.py: at 1024 and 256 tokens the split ran
    slower)."""
    nc, bq = DKV_TILES[64 if d <= 64 else 128]
    tiles = -(-skv // (64 * nc)) * b * h
    q_tiles = -(-sq // bq)
    splits = min(SM_COUNT // tiles, q_tiles // SPLIT_MIN_Q_TILES)
    if splits <= 1:
        return 1
    per = -(-q_tiles // splits)
    return -(-q_tiles // per)


def pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    """t [B, H, S, d] zero-padded to [B, H, S, dp], a copy whose memory is
    [B, S, H, dp] (the projections' layout); t itself when dp == d."""
    b, h, s, d = t.shape
    if dp == d:
        return t
    out = torch.zeros(b, s, h, dp, dtype=t.dtype, device=t.device)
    out[..., :d] = t.transpose(1, 2)
    return out.transpose(1, 2)


def _unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    """The first d columns of a kernel's padded output, copied into [B, S, H, d]
    memory as `_empty_bshd` lays it out; t itself when it has d columns."""
    if t.shape[-1] == d:
        return t
    b, h, s, _ = t.shape
    return _empty_bshd(b, h, s, d, t).copy_(t[..., :d])


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
            f"flash_attention: bf16, fp16 or fp32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, S, D]")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match")
    kernel_head_dim(d, q.dtype)   # raises for a head dim no kernel takes
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash_attention: empty sequence")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds the grid limit")


def _layout_ok(t: torch.Tensor) -> bool:
    """What the kernels read in place: the last dim contiguous; for 16-bit
    tensors (TMA, 16-byte vectors) also every other stride of a dim longer
    than 1 a multiple of 8 elements and a 16-byte aligned base."""
    if t.stride(3) != 1 and t.shape[3] > 1:
        return False
    if t.dtype == torch.float32:
        return True
    return all(s % 8 == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1) \
        and t.data_ptr() % 16 == 0


def _kernel_inputs(tensors, dp: int):
    """The tensors as the kernel reads them: zero-padded copies to dp columns,
    or the tensors themselves, which must then be laid out as `_layout_ok`
    says."""
    out = tuple(pad_head_dim(t, dp) for t in tensors)
    for t in out:
        if not _layout_ok(t):
            raise ValueError(
                f"flash_attention: strides {t.stride()} / alignment not supported "
                "(last dim contiguous; in 16 bits the others multiples of 8)")
    return out


def _fn(source: str, name: str, nargs_ptr: int, nargs_int: int):
    """C function `name` of the library built from `csrc/<source>.cu`, its
    argument types set: the pointers, the ints, then strides, scale, dtype and
    stream."""
    fn = getattr(kernels.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * nargs_ptr + [ctypes.c_int] * nargs_int + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _strides(strided):
    """(batch, head, seq) element strides of each tensor; a dim of length 1
    gets 8 (any multiple of 8 does: its only coordinate is 0)."""
    return [t.stride(i) if t.shape[i] > 1 else 8 for t in strided for i in range(3)]


def _launch(name: str, tensors, ints, strided, scale: float, dtype,
            entry: Optional[str] = None) -> None:
    """Call kernel `name` (its fp32 counterpart `<name>_f32` for fp32; the C
    function `entry` of its source where given) on the current stream with
    the data pointers of `tensors`, the ints, and the (batch, head, seq)
    element strides of the `strided` tensors; raise on a launch error; count
    the launch under `name`."""
    source = name
    if dtype == torch.float32:
        source, name = F32_SOURCE, f"{name}_f32"
    strides = _strides(strided)
    st = (ctypes.c_int64 * len(strides))(*strides)
    fn = _fn(source, entry or name, len(tensors), len(ints))
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
    """Non-causal attention. q [B, H, Sq, D], k/v [B, H, Skv, D], D <= 128,
    bf16, fp16 or fp32, any strides with a contiguous last dim (so the
    [B, S, H, D] view of a projection is read in place). Returns (o, lse): o
    [B, H, Sq, D] in q's dtype, laid out as [B, Sq, H, D] in memory; lse
    [B*H, Sq] fp32, natural log. The scale defaults to 1/sqrt(D)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale)
    _check(q, k, v)
    b, h, sq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dp = kernel_head_dim(d, q.dtype)
    qp, kp, vp = _kernel_inputs((q, k, v), dp)
    o = _empty_bshd(b, h, sq, dp, q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    _launch(NAME, (qp, kp, vp, o, lse), (b, h, sq, k.shape[2], dp), (qp, kp, vp, o),
            scale, q.dtype)
    return _unpad(o, d), lse


def _bwd_inputs(q, k, v, do, lse, delta):
    """q, k, v and dO as the backward kernels read them (padded to the head
    dim `kernel_head_dim` gives, dO made contiguous where autograd handed it
    in strides the kernels do not take)."""
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
    dp = kernel_head_dim(q.shape[3], q.dtype, backward=True)
    if dp == q.shape[3] and not _layout_ok(do):
        do = do.contiguous()
    return _kernel_inputs((q, k, v, do), dp)


def flash_attention_dq(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """dQ [B, H, Sq, D] in q's dtype (memory [B, Sq, H, D]) from the forward's
    LSE and D = `attention_delta(o, do)`, both [B*H, Sq] fp32."""
    if q.device.type == "cpu":
        return flash_attention_dq_ref(q, k, v, do, lse, delta, scale)
    qp, kp, vp, dop = _bwd_inputs(q, k, v, do, lse, delta)
    b, h, sq, dp = qp.shape
    dq = _empty_bshd(b, h, sq, dp, q)
    _launch(DQ_NAME, (qp, kp, vp, dop, lse, delta, dq), (b, h, sq, k.shape[2], dp),
            (qp, kp, vp, dop, dq), scale, q.dtype)
    return _unpad(dq, q.shape[3])


def flash_attention_dkv(q, k, v, do, lse, delta, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B, H, Skv, D] in the input dtype (memory [B, Skv, H, D]).
    In 16 bits, where `dkv_splits` gives more than one part, the kernel's
    fp32 partial sums go to a workspace of 2 * splits * B * H * Skv * D
    values, which the same launch adds up (one counted launch)."""
    if q.device.type == "cpu":
        return flash_attention_dkv_ref(q, k, v, do, lse, delta, scale)
    qp, kp, vp, dop = _bwd_inputs(q, k, v, do, lse, delta)
    b, h, sq, dp = qp.shape
    skv = k.shape[2]
    dk, dv = _empty_bshd(b, h, skv, dp, k), _empty_bshd(b, h, skv, dp, v)
    splits = 1 if q.dtype == torch.float32 else dkv_splits(b, h, sq, skv, dp)
    if splits == 1:
        _launch(DKV_NAME, (qp, kp, vp, dop, lse, delta, dk, dv), (b, h, sq, skv, dp),
                (qp, kp, vp, dop, dk, dv), scale, q.dtype)
    else:
        ws = torch.empty(2 * splits * b * h * skv * dp, dtype=torch.float32, device=q.device)
        _launch(DKV_NAME, (qp, kp, vp, dop, lse, delta, dk, dv, ws),
                (b, h, sq, skv, dp, splits), (qp, kp, vp, dop, dk, dv), scale, q.dtype,
                entry=f"{DKV_NAME}_split")
    d = q.shape[3]
    return _unpad(dk, d), _unpad(dv, d)


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

"""GroupNorm (+ SiLU): the CUDA kernel's wrapper, its plan, its plain
version, and the autograd Function over both.

Port of `difashion_tpu/nn/pallas/groupnorm.py::_gn_silu_kernel` (through
`_pallas_gn_silu`) -> `csrc/group_norm_silu.cu`: GroupNorm over channels-last
x (in memory [B, S, C], the TPU kernel's layout) with fp32 group statistics
(biased variance), the per-channel affine y = (x - mean) * a + bias
(a = scale * rstd; the TPU kernel's x * a + (bias - mean * a) cancels where
|mean| >> std) in fp32, y rounded to the input dtype, then the optional
SiLU, rounded again. The JAX kernel has a VMEM ceiling that leaves the VAE's
512x512 levels to XLA; this one has none.

`gn_plan` decides, from the shape alone, how the kernel covers x: in one read
by thread-block clusters where a band of groups fits their shared memory, in
two passes otherwise. `group_norm_silu` launches the kernel for CUDA tensors
and raises on what the kernel does not take (a layout other than channels-last
among it); for CPU tensors it computes the plain version
(`group_norm_silu_ref`), which the CPU tests hold against the JAX package.
`GroupNormSiLU` is the counterpart of the `_gn_silu` custom VJP: the forward
is the kernel and saves only x; the backward recomputes the statistics and
takes the plain version's gradients, written out (`group_norm_silu_grads`),
as the JAX package's recomputes through its reference (there is no backward
kernel).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from difashion_tpu_torch.nn import kernels

NAME = "group_norm_silu"
ACTS = (None, "silu")
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_ROUTES = {"one_read": 0, "two_pass": 1}
_THREADS = 256
_BOX_ROWS = 256        # TMA's largest box along a dimension
_BOX_BYTES = 16 * 1024  # a one-read TMA box: a slice's boxes are summed as they
                        # arrive and stored as soon as they are normalised
_MAX_BAND = 256        # channels of a one-read band (the box's inner dimension)
_MAX_K = 8             # groups of a one-read band
_MAX_BOXES = 64        # boxes of a one-read slice (a barrier each)
_CLUSTERS = (1, 2, 4, 8, 16)  # CTAs of a cluster: powers of two pack the GPCs; past 8
                              # the non-portable size
# (largest cluster, shared-memory bytes of a CTA's slice) tried in turn: the
# smallest cluster whose slices let 3 CTAs share an SM (each also holds ~12 KB
# of static arrays), else 2. A CTA's life is its loads, its sums, the
# cluster's merge, then the normalisation and its stores: the SM's memory
# pipe idles through the middle unless other CTAs are loading or storing, so
# a band that would take one CTA an SM (slices of 100-208 KB) is faster in
# two passes (scripts/group_norm_plans.py).
ONE_READ_TIERS = ((16, 62 * 1024), (16, 100 * 1024))
# the narrowest band row the one-read route takes: TMA fetches a band row by
# row, and rows of 16 bytes (the VAE's 128 and 256 channels) waste its
# requests and DRAM's 32-byte sectors (scripts/group_norm_plans.py)
ONE_READ_MIN_ROW_BYTES = 32
# blocks per call the two-pass route aims at: about 16 per SM of the H100's
# 132, so that a small batch (the VAE decode's 4 rows) still fills the card
_TARGET_BLOCKS = 2048
# the least a two-pass block reads, so that its fixed costs stay small
# (scripts/group_norm_plans.py: 64 KB chunks ran the decode's 256x256 and
# 512x512 levels up to 11 % slower)
_CHUNK_BYTES = 256 * 1024


def group_norm_silu_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        groups: int, eps: float, act: Optional[str] = None
                        ) -> torch.Tensor:
    """Plain version: GroupNorm over [B, C, *spatial] in fp32 (biased
    variance), the fp32 affine y = (x - mean) * a + bias with a = scale *
    rstd (the kernel's form), the result in x's dtype, then the optional SiLU
    in that dtype (`_gn_silu_ref`'s order). The statistics take the
    reference's [B, S, C] form (`_group_stats`). Every pass over x is
    elementwise or a reduction over S, so y keeps x's memory layout and no
    layout copy is made, forward or backward."""
    b, c = x.shape[:2]
    cg = c // groups
    xf = x.float().reshape(b, c, -1)
    mean, rstd = _group_stats(xf, groups, eps)
    a = scale.float().view(groups, cg) * rstd
    centred = xf - mean.expand(b, groups, cg).reshape(b, c, 1)
    y = torch.addcmul(bias.float().view(c, 1), centred, a.view(b, c, 1))
    y = y.reshape(x.shape).to(x.dtype)
    return F.silu(y) if act == "silu" else y


def _group_stats(xf: torch.Tensor, groups: int, eps: float):
    """Group mean and rstd [B, G, 1] of xf [B, C, S] (fp32): each channel's
    mean and variance over S, merged into its group's on [B, C] exactly (the
    channels of a group count alike, and the variance is the mean of the
    channels' variances plus that of their means, never E[x^2] - E[x]^2)."""
    b, c = xf.shape[:2]
    var_c, mean_c = torch.var_mean(xf, dim=2, correction=0)
    mean_c, var_c = mean_c.view(b, groups, -1), var_c.view(b, groups, -1)
    mean = mean_c.mean(dim=2, keepdim=True)
    var = (var_c + (mean_c - mean).square()).mean(dim=2, keepdim=True)
    return mean, torch.rsqrt(var + eps)


@torch.no_grad()
def group_norm_silu_grads(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          dout: torch.Tensor, groups: int, eps: float,
                          act: Optional[str] = None) -> tuple:
    """(dx, dscale, dbias) of the plain version at dout, written out: the
    SiLU's backward on the recomputed, rounded y (autograd's `silu_backward`),
    then GroupNorm's, dx = rstd * (scale * dy - mean_g(scale * dy) - xhat *
    mean_g(scale * dy * xhat)), in fp32 from per-channel sums over S, each
    gradient in its input's dtype and dx in x's layout. The same gradients as
    autograd through `group_norm_silu_ref`, in a third of its passes and
    without recording a graph."""
    b, c = x.shape[:2]
    cg = c // groups
    xf = x.float().reshape(b, c, -1)
    mean, rstd = _group_stats(xf, groups, eps)
    scale_g = scale.float().view(groups, cg)
    a = (scale_g * rstd).reshape(b, c, 1)
    centred = xf - mean.expand(b, groups, cg).reshape(b, c, 1)
    d = dout.reshape(b, c, -1)
    if act == "silu":
        y = torch.addcmul(bias.float().view(c, 1), centred, a).to(x.dtype)
        d = torch.ops.aten.silu_backward(d, y)
    dy = d.float()
    s1 = dy.sum(dim=2).view(b, groups, cg)                 # sum over S of dy
    s2 = (dy * centred).sum(dim=2).view(b, groups, cg)     # ... of dy * (x - mean)
    n = cg * xf.shape[2]
    m1 = (scale_g * s1).sum(dim=2, keepdim=True) / n       # mean_g(scale * dy)
    m2 = (scale_g * s2).sum(dim=2, keepdim=True) / n       # mean_g(scale * dy * (x - mean))
    coef = (-rstd.pow(3) * m2).expand(b, groups, cg).reshape(b, c, 1)
    const = (-rstd * m1).expand(b, groups, cg).reshape(b, c, 1)
    dx = torch.addcmul(torch.addcmul(const, centred, coef), dy, a)
    dscale = (s2 * rstd).sum(dim=0).reshape(c)
    return (dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype),
            s1.sum(dim=0).reshape(c).to(bias.dtype))


def is_channels_last(x: torch.Tensor) -> bool:
    """x [B, C, *spatial] lies in memory as a contiguous [B, *spatial, C]
    (`torch.channels_last` for 4-D x)."""
    if x.dim() == 4:
        return x.is_contiguous(memory_format=torch.channels_last)
    return x.movedim(1, -1).is_contiguous()


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """x, copied to channels-last where it is not (a no-op for the models'
    activations)."""
    if is_channels_last(x):
        return x
    return x.movedim(1, -1).contiguous().movedim(-1, 1)


class GNPlan(NamedTuple):
    """How the kernel covers x. route "one_read": clusters of n CTAs, each
    holding `rows` rows of a band of k groups in shared memory, loaded in TMA
    boxes of `box_rows`. route "two_pass": n chunks of `rows` rows, bands of
    k groups, in 16-byte vectors where `vector`, else element by element."""
    route: str
    k: int
    n: int
    rows: int
    box_rows: int
    vector: bool

    def slice_bytes(self, cg: int, itemsize: int) -> int:
        """Shared memory of a CTA's slice on the one-read route."""
        return self.rows * self.k * cg * itemsize if self.route == "one_read" else 0


def _one_read_rows(s: int, row_bytes: int, tiers: Sequence) -> Optional[tuple]:
    """(n, rows, box_rows) of the smallest cluster in the first tier whose
    slices of a band of `row_bytes` per row fit, or None. A CTA's rows are
    split into equal boxes of about _BOX_BYTES, each a multiple of 8 rows."""
    most = min(_BOX_ROWS, max(8, _BOX_BYTES // row_bytes // 8 * 8))
    for max_n, budget in tiers:
        for n in (c for c in _CLUSTERS if c <= max_n):
            per = -(-s // n)
            boxes = -(-per // most)
            box_rows = -(-(-(-per // boxes)) // 8) * 8
            rows = boxes * box_rows
            if rows * row_bytes <= budget and boxes <= _MAX_BOXES:
                return -(-s // rows), rows, box_rows
    return None


def gn_plan(shape: Sequence[int], groups: int, dtype: torch.dtype,
            aligned: bool = True) -> GNPlan:
    """The kernel's plan for channels-last x of `shape` [B, C, *spatial] in
    `groups` groups (`aligned`: x and y start on 16 bytes). One read where
    TMA takes the tensor (a row of C elements a multiple of 16 bytes), a band
    of k groups (k the smallest count whose channels make a multiple of 16
    bytes) has rows of at least ONE_READ_MIN_ROW_BYTES and fits a cluster's
    shared memory by ONE_READ_TIERS; two passes otherwise. Raises ValueError
    for a shape neither route takes."""
    return _plan(tuple(int(d) for d in shape), groups, dtype, aligned, ONE_READ_TIERS,
                 ONE_READ_MIN_ROW_BYTES, _CHUNK_BYTES, _TARGET_BLOCKS)


@functools.lru_cache(maxsize=1024)
def _plan(shape: tuple, groups: int, dtype: torch.dtype, aligned: bool, tiers: tuple,
          min_row_bytes: int, chunk_bytes: int, target_blocks: int) -> GNPlan:
    """gn_plan's work, cached: the wrapper plans every call, and the models
    call it with a few dozen shapes."""
    b, c = int(shape[0]), int(shape[1])
    s = math.prod(int(d) for d in shape[2:])
    item = torch.empty((), dtype=dtype).element_size()
    cg = c // groups
    vector = aligned and (c * item) % 16 == 0
    k = 16 // math.gcd(cg * item, 16)
    if (vector and groups % k == 0 and k <= _MAX_K and k * cg <= _MAX_BAND
            and k * cg * item >= min_row_bytes and b * (groups // k) <= 65535
            and s < 2 ** 31):
        fit = _one_read_rows(s, k * cg * item, tiers)
        if fit is not None:
            n, rows, box_rows = fit
            return GNPlan("one_read", k, n, rows, box_rows, True)
    vec = 16 // item if vector else 1
    # a block covers whole rows where a sweep of 256 threads takes them
    # (coalesced reads), else the narrowest band of whole vectors that fits
    ks = [groups] + [j for j in range(1, groups) if groups % j == 0]
    k = next((j for j in ks if (j * cg) % vec == 0 and j * cg // vec <= _THREADS), None)
    if k is None:
        raise ValueError(f"group_norm_silu: {c} channels in {groups} groups of {dtype} are "
                         "beyond the kernel's band")
    blocks = b * (groups // k)
    least = max(1, -(-chunk_bytes // (k * cg * item)))
    chunks = max(1, min(-(-target_blocks // blocks), -(-s // least), 65535))
    rows = -(-s // chunks)
    return GNPlan("two_pass", k, -(-s // rows), rows, 0, vector)


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
           act: Optional[str]) -> None:
    if not (x.is_cuda and scale.device == x.device and bias.device == x.device):
        raise ValueError("group_norm_silu: x, scale and bias must lie on one CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm_silu: bf16, fp16 or fp32 x, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"group_norm_silu: x must be a non-empty [B, C, *spatial], "
                         f"got {tuple(x.shape)}")
    if not is_channels_last(x):
        raise ValueError(f"group_norm_silu: x must be contiguous channels-last "
                         f"([B, *spatial, C] in memory), got shape {tuple(x.shape)} and "
                         f"strides {x.stride()}")
    c = x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"group_norm_silu: {c} channels are not divisible into {groups} groups")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm_silu: scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be [{c}]")
    if act not in ACTS:
        raise ValueError(f"group_norm_silu: unknown activation {act!r}")
    if x.shape[0] > 65535 or x.numel() // (x.shape[0] * c) >= 2 ** 31:
        raise ValueError(f"group_norm_silu: {tuple(x.shape)} is beyond the kernel's "
                         "index range")


def _fn(lib: Optional[ctypes.CDLL] = None):
    fn = getattr(lib or kernels.load(NAME), NAME)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(+SiLU) of channels-last x [B, C, *spatial] (bf16, fp16 or
    fp32) with scale and bias [C] (any float dtype, used in fp32). Returns y
    in x's dtype, shape and layout."""
    if x.device.type == "cpu":
        return group_norm_silu_ref(x, scale, bias, groups, eps, act)
    _check(x, scale, bias, groups, act)
    # y is a fresh allocation, 16-byte aligned
    plan = gn_plan(x.shape, groups, x.dtype, aligned=x.data_ptr() % 16 == 0)
    return launch(x, scale, bias, groups, eps, act, plan)


def launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
           eps: float, act: Optional[str], plan: GNPlan,
           lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs with the given plan
    (`group_norm_silu`'s, or another one to time: scripts/group_norm_plans.py),
    from the built library or from `lib` (a build with other defines)."""
    b, c = x.shape[:2]
    y = torch.empty_like(x)
    partials = (torch.empty(b * groups * (plan.n * 3 + 2), dtype=torch.float32,
                            device=x.device) if plan.route == "two_pass" else None)
    scale32 = scale.detach().float().contiguous()
    bias32 = bias.detach().float().contiguous()
    kernels.bind_context(x.device.index)
    with torch.cuda.device(x.device):
        rc = _fn(lib)(x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), y.data_ptr(),
                   None if partials is None else partials.data_ptr(), b, x.numel() // (b * c), c, groups,
                   _ROUTES[plan.route], plan.k, plan.n, plan.rows, plan.box_rows,
                   int(plan.vector), float(eps), int(act == "silu"), _DTYPE_CODES[x.dtype],
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed ({plan}): CUDA error {rc}")
    kernels.LAUNCHES[NAME] += 1
    return y


class GroupNormSiLU(torch.autograd.Function):
    """y = GroupNorm(+SiLU)(x) through `group_norm_silu` (the kernel on CUDA).
    Saves x, scale and bias (the inputs, no activation of its own); the
    backward recomputes the statistics and takes the plain version's
    gradients (`group_norm_silu_grads`), as the JAX package's custom VJP
    recomputes through its reference (there is no backward kernel)."""

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
        grads = group_norm_silu_grads(x, scale, bias, dy, ctx.groups, ctx.eps, ctx.act)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad[:3])) + (None,) * 3

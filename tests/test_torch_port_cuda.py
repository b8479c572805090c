"""The CUDA kernels (flash-attention forward, dQ, dK/dV in 16 bits and in fp32;
GroupNorm + SiLU; the skinny-N matmul in 16 bits and in fp32; the fused
GEGLU) against their plain versions, on the card, with TF32 off; and the
tiny SDXL-shaped model through them.

Every test here needs an NVIDIA GPU (Hopper, sm_90a) with the CUDA toolkit, is
marked `cuda`, and skips elsewhere. The module imports torch only (no JAX), so
on a GPU machine without JAX it runs with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from difashion_tpu_torch.nn import kernels
from difashion_tpu_torch.nn.attention import sdpa
from difashion_tpu_torch.nn.kernels.flash_attention import (
    attention_delta,
    flash_attention,
    flash_attention_dkv,
    flash_attention_dkv_ref,
    flash_attention_dq,
    flash_attention_dq_ref,
    flash_attention_ref,
)
from difashion_tpu_torch.nn.kernels.groupnorm import (
    gn_plan,
    group_norm_silu,
    group_norm_silu_ref,
    is_channels_last,
)
from difashion_tpu_torch.nn.kernels.skinny_matmul import (
    SkinnyMatmul,
    skinny_matmul,
    skinny_matmul_3xtf32_ref,
    skinny_matmul_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, h, sq, skv, d, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)
            for shape in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d))]


SHAPES = [
    (1, 2, 256, 256, 64),
    (2, 1, 384, 384, 64),
    (1, 2, 256, 77, 64),     # ragged cross-attention KV
    (1, 1, 100, 50, 32),     # both dims ragged
    (1, 2, 64, 64, 64),      # the short sequences of the mid level
    (1, 2, 77, 77, 64),
    (2, 3, 130, 77, 16),     # the tiny config's head dim
    (1, 2, 200, 300, 128),
    (1, 2, 200, 77, 40),     # sd15's head dims: every kernel pads them by TMA's
    (2, 1, 130, 300, 80),    # zero fill, no padded copy
]


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_matches_plain(dev, b, h, sq, skv, d, dtype):
    q, k, v = _qkv(b, h, sq, skv, d, dtype, dev)
    o, lse = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ro, rlse = flash_attention_ref(q, k, v)
    err = (o.float() - ro.float()).abs()
    # P is rounded to the input dtype before the PV product (as in the TPU
    # kernel), the plain version keeps it in fp32
    assert err.max().item() <= 3e-2 and err.mean().item() <= 3e-3
    assert o.dtype == dtype and o.shape == (b, h, sq, d)
    np.testing.assert_allclose(lse.cpu().numpy(), rlse.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_strided_views_and_launch_count(dev):
    b, s, h, d = 2, 300, 5, 64
    g = torch.Generator(device=dev).manual_seed(1)
    proj = torch.randn(3, b, s, h * d, generator=g, device=dev).bfloat16()
    q, k, v = (t.view(b, s, h, d).transpose(1, 2) for t in proj)
    kernels.reset_launches()
    o, _ = flash_attention(q, k, v)
    o2, _ = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert kernels.LAUNCHES["flash_attention_fwd"] == 2
    assert torch.equal(o, o2)
    # output memory is [B, S, H, D]: merging heads is free
    assert o.transpose(1, 2).is_contiguous()


def _proj(b, s, h, d, dtype, dev, seed):
    """The [B, H, S, D] view of a [B, S, H*D] projection, as the UNet's
    attention hands it over."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, s, h * d, generator=g, device=dev).to(dtype)
    return x.view(b, s, h, d).transpose(1, 2)


@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sq,skv", [(200, 77), (333, 130)])
def test_forward_head_dims_on_strided_views(dev, d, dtype, sq, skv):
    """Every head dim the forward takes (d % 8 == 0 read in place, the kernel
    padding to 64 or 128 with TMA's zero fill), ragged Sq and Skv, the
    projections' strided views: against the plain version, O laid out as
    [B, S, H, D], the scale that of the unpadded d."""
    b, h = 2, 3
    q, k, v = (_proj(b, s, h, d, dtype, dev, seed) for s, seed in ((sq, 1), (skv, 2), (skv, 3)))
    kernels.reset_launches()
    o, lse = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    ro, rlse = flash_attention_ref(q, k, v)
    err = (o.float() - ro.float()).abs()
    assert err.max().item() <= 3e-2 and err.mean().item() <= 3e-3
    np.testing.assert_allclose(lse.cpu().numpy(), rlse.cpu().numpy(), rtol=1e-4, atol=1e-4)
    assert o.dtype == dtype and o.shape == (b, h, sq, d) and o.transpose(1, 2).is_contiguous()


def test_forward_head_dim_not_a_multiple_of_8(dev):
    """d = 20 goes through the wrapper's zero-padded copy to 24."""
    q, k, v = _qkv(2, 3, 100, 77, 20, torch.bfloat16, dev, seed=6)
    o, lse = flash_attention(q, k, v)
    ro, rlse = flash_attention_ref(q, k, v)
    assert (o.float() - ro.float()).abs().max().item() <= 3e-2
    assert (lse - rlse).abs().max().item() <= 1e-4
    assert o.shape == q.shape and o.transpose(1, 2).is_contiguous()


def test_sdpa_routes(dev):
    q, k, v = _qkv(2, 2, 128, 77, 64, torch.bfloat16, dev)
    kernels.reset_launches()
    out = sdpa(q, k, v)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    with kernels.plain_versions():
        ref = sdpa(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    # d > 128 (the VAE mid-attention) takes the plain path
    wq, wk, wv = _qkv(1, 1, 64, 64, 512, torch.bfloat16, dev)
    sdpa(wq, wk, wv)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    # fp32 goes to the fp32 kernel, sd15's d = 80 to the forward kernel
    sdpa(q.float(), k.float(), v.float())
    assert kernels.LAUNCHES["flash_attention_fwd_f32"] == 1
    fq, fk, fv = _qkv(1, 1, 64, 64, 80, torch.bfloat16, dev)
    sdpa(fq, fk, fv)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 2
    assert kernels.LAUNCHES["flash_attention_fwd_f32"] == 1


def test_wrapper_rejects(dev):
    q, k, v = _qkv(1, 1, 64, 64, 64, torch.bfloat16, dev)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention(q, k.float(), v)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :, :32], v)
    wq, wk, wv = _qkv(1, 1, 64, 64, 136, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        flash_attention(wq, wk, wv)                       # head dim above 128
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), k, v)          # last dim not contiguous
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :, 4:60], k[:, :, :, 4:60], v[:, :, :, 4:60])  # 8-byte base


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_backward_kernels_match_plain(dev, b, h, sq, skv, d, dtype):
    q, k, v = _qkv(b, h, sq, skv, d, dtype, dev, seed=2)
    g = torch.Generator(device=dev).manual_seed(3)
    do = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)  # random cotangent
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    scale = d ** -0.5
    dq = flash_attention_dq(q, k, v, do, lse, delta, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    rdq = flash_attention_dq_ref(q, k, v, do, lse, delta, scale)
    rdk, rdv = flash_attention_dkv_ref(q, k, v, do, lse, delta, scale)
    # the plain versions round P and dS to the input dtype where the kernels
    # do; what is left is the order of the fp32 sums, ex2.approx, and the odd
    # 16-bit rounding of P or dS that falls the other way
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == dtype and got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= 1e-2


def test_backward_layout_and_launch_counts(dev):
    b, s, h, d = 2, 300, 5, 64
    g = torch.Generator(device=dev).manual_seed(4)
    proj = torch.randn(4, b, s, h * d, generator=g, device=dev).bfloat16()
    q, k, v, do = (t.view(b, s, h, d).transpose(1, 2) for t in proj)
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    kernels.reset_launches()
    dq = flash_attention_dq(q, k, v, do, lse, delta, d ** -0.5)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, d ** -0.5)
    assert kernels.LAUNCHES["flash_attention_dq"] == 1
    assert kernels.LAUNCHES["flash_attention_dkv"] == 1
    # gradients are laid out as [B, S, H, D]: the projections' backward reads
    # them without a copy
    for t in (dq, dk, dv):
        assert t.transpose(1, 2).is_contiguous()
    # a contiguous dO gives the same result as the strided one; and the same
    # result again (no atomics)
    dq2 = flash_attention_dq(q, k, v, do.contiguous(), lse, delta, d ** -0.5)
    dk2, dv2 = flash_attention_dkv(q, k, v, do.contiguous(), lse, delta, d ** -0.5)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)



@pytest.mark.parametrize("sq", [77, 100, 300])
@pytest.mark.parametrize("skv", [77, 100, 300])
@pytest.mark.parametrize("d", [64, 40, 80])
def test_backward_kernels_ragged_lengths(dev, sq, skv, d):
    """Ragged query and key lengths on both sides of the tiles: zero-filled Q
    and dO rows past Sq (P = 1 there, harmless only through the masking),
    zero-filled K columns past Skv (masked in dQ), an LSE and D row that
    does not meet TMA's 16-byte stride rule (Sq = 77, 100)."""
    b, h = 2, 3
    q, k, v = _qkv(b, h, sq, skv, d, torch.bfloat16, dev, seed=sq + skv + d)
    do = torch.randn(b, h, sq, d, generator=torch.Generator(device=dev).manual_seed(7),
                     device=dev).bfloat16()
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, d ** -0.5)
    got = (flash_attention_dq(*args),) + flash_attention_dkv(*args)
    torch.cuda.synchronize()
    want = (flash_attention_dq_ref(*args),) + flash_attention_dkv_ref(*args)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all()) and g.shape == w.shape
        assert _rel(g, w) <= 1e-2


@pytest.mark.parametrize("d", [40, 80])
def test_backward_reads_sd15_head_dims_in_place(dev, d, monkeypatch):
    """sd15's d = 40 and 80 reach the backward kernels as they are: no padded
    copy of q, k, v or dO, no [.., dp] output sliced back; the gradients
    match the plain versions."""
    from difashion_tpu_torch.nn.kernels import flash_attention as fa

    padded = []
    real_pad, real_empty = fa.pad_head_dim, fa._empty_bshd

    def pad(t, dp):
        padded.append((t.shape[-1], dp))
        return real_pad(t, dp)

    def empty(b, h, s, dd, like):
        padded.append((d, dd))
        return real_empty(b, h, s, dd, like)

    monkeypatch.setattr(fa, "pad_head_dim", pad)
    monkeypatch.setattr(fa, "_empty_bshd", empty)
    b, h, sq, skv = 2, 8, 256, 77
    proj = torch.randn(4, b, sq, h * d, generator=torch.Generator(device=dev).manual_seed(d),
                       device=dev).bfloat16()
    q, do = (t.view(b, sq, h, d).transpose(1, 2) for t in proj[::3])
    k, v = (t[:, :skv].view(b, skv, h, d).transpose(1, 2) for t in proj[1:3])
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, d ** -0.5)
    kernels.reset_launches()
    got = (flash_attention_dq(*args),) + flash_attention_dkv(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_dq"] == 1
    assert kernels.LAUNCHES["flash_attention_dkv"] == 1
    assert padded and all(have == dp for have, dp in padded)
    want = (flash_attention_dq_ref(*args),) + flash_attention_dkv_ref(*args)
    for g, w in zip(got, want):
        assert g.shape == (b, h, g.shape[2], d) and g.transpose(1, 2).is_contiguous()
        assert _rel(g, w) <= 1e-2


@pytest.mark.parametrize("b,h,sq,d", [(8, 5, 4096, 64), (2, 5, 1024, 64), (2, 8, 1024, 80),
                                      (1, 2, 1000, 40)])
def test_dkv_split_path_is_deterministic(dev, b, h, sq, d):
    """The 77-token cross-attention's dK/dV through the split path (the
    query range in parts, their fp32 partial sums added in split order by a
    second kernel of the same launch): one counted launch a call, the plain
    version's result, and the same bits on a second call."""
    from difashion_tpu_torch.nn.kernels.flash_attention import dkv_splits

    skv = 77
    assert dkv_splits(b, h, sq, skv, d) > 1
    q, k, v = _qkv(b, h, sq, skv, d, torch.bfloat16, dev, seed=11)
    do = torch.randn(b, h, sq, d, generator=torch.Generator(device=dev).manual_seed(12),
                     device=dev).bfloat16()
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, d ** -0.5)
    kernels.reset_launches()
    dk, dv = flash_attention_dkv(*args)
    dk2, dv2 = flash_attention_dkv(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_dkv"] == 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    rdk, rdv = flash_attention_dkv_ref(*args)
    assert _rel(dk, rdk) <= 1e-2 and _rel(dv, rdv) <= 1e-2


def test_sdpa_autograd_routes_through_the_kernels(dev):
    q, k, v = (t.requires_grad_() for t in _qkv(2, 5, 256, 77, 64, torch.bfloat16, dev,
                                                 seed=5))
    do = torch.randn(2, 5, 256, 64, device=dev).bfloat16()
    kernels.reset_launches()
    out = sdpa(q, k, v)
    out.backward(do)
    assert dict(kernels.LAUNCHES) == {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                                      "flash_attention_dkv": 1, "flash_attention_fwd_f32": 0,
                                      "flash_attention_dq_f32": 0, "flash_attention_dkv_f32": 0,
                                      "group_norm_silu": 0, "skinny_matmul": 0,
                                      "skinny_matmul_f32": 0, "geglu_matmul": 0}
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    with kernels.plain_versions():
        sdpa(q, k, v).backward(do)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    for got, t in zip(grads, (q, k, v)):
        assert _rel(got, t.grad) <= 2e-2
    # without autograd the forward kernel runs alone and saves nothing
    with torch.no_grad():
        assert sdpa(q, k, v).grad_fn is None
    assert kernels.LAUNCHES["flash_attention_dq"] == 1


# ---- fp32 flash attention ----------------------------------------------------

F32_SHAPES = [
    (1, 2, 256, 256, 64),
    (1, 2, 256, 77, 64),     # ragged cross-attention KV
    (1, 1, 100, 50, 32),     # both dims ragged
    (2, 3, 130, 77, 16),     # the tiny config's head dim
    (1, 2, 200, 77, 40),     # sd15's
    (2, 1, 130, 300, 80),
    (1, 2, 200, 300, 128),
    (1, 1, 70, 90, 20),      # any d
]


@pytest.mark.parametrize("b,h,sq,skv,d", F32_SHAPES)
def test_f32_kernels_match_plain(dev, b, h, sq, skv, d):
    """The fp32 forward, dQ and dK/dV kernels within 2e-5 of the fp32 plain
    versions (fp32 sums in another order, exp2f for exp), on the projections'
    strided views; counted under their own names."""
    q, k, v, do = (_proj(b, s, h, d, torch.float32, dev, seed)
                   for s, seed in ((sq, 1), (skv, 2), (skv, 3), (sq, 4)))
    scale = d ** -0.5
    kernels.reset_launches()
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        "flash_attention_fwd_f32": 1, "flash_attention_dq_f32": 1, "flash_attention_dkv_f32": 1}
    ro, rlse = flash_attention_ref(q, k, v)
    rdq = flash_attention_dq_ref(q, k, v, do, rlse, delta, scale)
    rdk, rdv = flash_attention_dkv_ref(q, k, v, do, rlse, delta, scale)
    for got, want in ((o, ro), (lse, rlse), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for t in (o, dq, dk, dv):
        assert t.transpose(1, 2).is_contiguous()


# Sq and Skv one below and one above the fp32 kernels' 64-row tiles (and the
# wgmma forward's 128-row blocks), and head dims from 4 to 128 (d = 17:
# 4-byte copies)
F32_EDGE_SHAPES = [
    (1, 2, 63, 65, 64),
    (1, 2, 65, 63, 64),
    (1, 2, 127, 129, 64),
    (2, 1, 129, 127, 64),
    (1, 3, 100, 77, 4),
    (2, 1, 130, 90, 20),
    (1, 2, 100, 77, 36),
    (1, 2, 130, 200, 100),
    (1, 2, 200, 300, 128),
    (1, 2, 70, 90, 17),
]


@pytest.mark.parametrize("b,h,sq,skv,d", F32_EDGE_SHAPES)
def test_f32_backward_at_tile_edges(dev, b, h, sq, skv, d):
    """The fp32 dQ and dK/dV kernels (3xTF32 on the tensor cores) at the
    edges of their tiles: within 2e-5 per element of the fp32 plain
    backward, within 2e-5 relative L2 of the plain 3xTF32 backward (which
    splits where the kernels split), and bit-identical on a second call."""
    from difashion_tpu_torch.nn.kernels.flash_attention import flash_attention_bwd_3xtf32_ref

    q, k, v, do = (_proj(b, s, h, d, torch.float32, dev, seed)
                   for s, seed in ((sq, 5), (skv, 6), (skv, 7), (sq, 8)))
    scale = d ** -0.5
    o, lse = flash_attention(q, k, v)
    args = (q, k, v, do, lse, attention_delta(o, do), scale)
    got = (flash_attention_dq(*args),) + flash_attention_dkv(*args)
    again = (flash_attention_dq(*args),) + flash_attention_dkv(*args)
    torch.cuda.synchronize()
    plain = (flash_attention_dq_ref(*args),) + flash_attention_dkv_ref(*args)
    split = flash_attention_bwd_3xtf32_ref(q, k, v, o, lse, do, scale)
    for g, a, w, t in zip(got, again, plain, split):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
        assert _rel(g, t) <= 2e-5


@pytest.mark.parametrize("b,h,sq,skv,d", F32_EDGE_SHAPES)
def test_f32_forward_at_tile_edges(dev, b, h, sq, skv, d):
    """The fp32 forward kernels (3xTF32 on the tensor cores: wgmma over 128
    Q rows at d = 36 and 64, mma.sync over 64 or 128 at the others) at the edges of
    their tiles: O and the LSE within 2e-5 per element of the fp32 plain
    forward, within 2e-5 relative L2 of the plain 3xTF32 forward (which
    splits where the kernels split), and bit-identical on a second call."""
    from difashion_tpu_torch.nn.kernels.flash_attention import flash_attention_3xtf32_ref

    q, k, v = (_proj(b, s, h, d, torch.float32, dev, seed)
               for s, seed in ((sq, 15), (skv, 16), (skv, 17)))
    kernels.reset_launches()
    got = flash_attention(q, k, v)
    again = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd_f32"] == 2
    plain = flash_attention_ref(q, k, v)
    split = flash_attention_3xtf32_ref(q, k, v)
    for g, a, w, t in zip(got, again, plain, split):
        assert g.shape == w.shape and torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
        assert _rel(g, t) <= 2e-5


def _f32_forward_kernels(q, k, v):
    """The names of the CUDA kernels one fp32 `flash_attention` call runs."""
    from torch.profiler import ProfilerActivity, profile

    flash_attention(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention(q, k, v)
        torch.cuda.synchronize()
    return {name for name in ("fwd_wg_kernel", "fwd_tc_kernel")
            if any(name in evt.key for evt in prof.key_averages())}


def test_f32_forward_routes(dev):
    """The C side's choice of fp32 forward: the wgmma kernel at d = 64 and
    40 on the projections' aligned views; the mma.sync kernel at d = 64 on a
    view whose strides are not multiples of 4 floats (rows 66 floats apart),
    and at d = 80 and 16. Each route within 2e-5 of the plain version."""
    def cut(s, h, d, width, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(2, s, h, width, generator=g, device=dev)
        return x[..., :d].transpose(1, 2)

    cases = [((_proj(2, s, 3, 64, torch.float32, dev, i) for i, s in ((1, 200), (2, 77), (3, 77))),
              "fwd_wg_kernel"),
             ((_proj(2, s, 8, 40, torch.float32, dev, i) for i, s in ((4, 300), (5, 130), (6, 130))),
              "fwd_wg_kernel"),
             ((cut(s, 3, 64, 66, i) for i, s in ((7, 200), (8, 77), (9, 77))), "fwd_tc_kernel"),
             ((_proj(2, s, 8, 80, torch.float32, dev, i) for i, s in ((10, 200), (11, 77), (12, 77))),
              "fwd_tc_kernel"),
             ((_proj(2, s, 3, 16, torch.float32, dev, i) for i, s in ((13, 130), (14, 77), (15, 77))),
              "fwd_tc_kernel")]
    for tensors, route in cases:
        q, k, v = tensors
        assert _f32_forward_kernels(q, k, v) == {route}, (tuple(q.shape), q.stride())
        o, lse = flash_attention(q, k, v)
        ro, rlse = flash_attention_ref(q, k, v)
        torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(lse, rlse, rtol=2e-5, atol=2e-5)


def test_f32_dkv_split_path_is_deterministic(dev):
    """The fp32 dK/dV of the 77-token cross-attention at 4096 tokens (the
    training step's shape) through the split path (the query range in 3
    parts, their fp32 partial sums added in split order by a second kernel
    of the same launch): one counted launch a call, the same bits on a
    second call, and the plain fp32 backward within 2e-5 relative L2 (the
    bound of chip_smoke.py's kernel_bwd)."""
    from difashion_tpu_torch.nn.kernels.flash_attention import dkv_splits

    b, h, sq, skv, d = 8, 5, 4096, 77, 64
    assert dkv_splits(b, h, sq, skv, d, torch.float32) == 3
    q, k, v, do = (_proj(b, s, h, d, torch.float32, dev, seed)
                   for s, seed in ((sq, 11), (skv, 12), (skv, 13), (sq, 14)))
    o, lse = flash_attention(q, k, v)
    args = (q, k, v, do, lse, attention_delta(o, do), d ** -0.5)
    kernels.reset_launches()
    dk, dv = flash_attention_dkv(*args)
    dk2, dv2 = flash_attention_dkv(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_dkv_f32"] == 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    rdk, rdv = flash_attention_dkv_ref(*args)
    assert _rel(dk, rdk) <= 2e-5 and _rel(dv, rdv) <= 2e-5


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_sdpa_at_sd15_head_dims(dev, d, dtype):
    """sd15's head dims (8 heads over 320, 640 and 1280 channels) through sdpa
    with autograd, self- and cross-attention: no exception, the kernels of
    the dtype launched for d <= 128 (none for 160), forward and gradients
    against the plain versions."""
    b, h = 2, 8
    f32 = dtype == torch.float32
    for skv in (256, 77):
        q, k, v = (_proj(b, s, h, d, dtype, dev, seed).requires_grad_()
                   for s, seed in ((256, 1), (skv, 2), (skv, 3)))
        do = _proj(b, 256, h, d, dtype, dev, 4)
        kernels.reset_launches()
        out = sdpa(q, k, v)
        out.backward(do)
        torch.cuda.synchronize()
        suffix = "_f32" if f32 else ""
        want = 1 if d <= 128 else 0
        for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
            assert kernels.LAUNCHES[name + suffix] == want
        grads = [t.grad.clone() for t in (q, k, v)]
        for t in (q, k, v):
            t.grad = None
        with kernels.plain_versions():
            ref = sdpa(q, k, v)
            ref.backward(do)
        tol = 2e-5 if f32 else 2e-2
        assert out.dtype == dtype and _rel(out, ref) <= tol
        for got, t in zip(grads, (q, k, v)):
            assert bool(torch.isfinite(got).all()) and _rel(got, t.grad) <= tol


def _tiny_inputs(model, dev, F=4):
    """One GOR outfit at the tiny config (chip_smoke.py's gor_inputs)."""
    from difashion_tpu_torch.engine.generate import GenerationInputs

    cfg = model.config
    s, C = cfg.unet.sample_size, cfg.vae.latent_channels
    g = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=g).to(dev)
    ids = torch.randint(0, cfg.text.vocab_size, (F, 77), generator=g).to(dev)
    with torch.inference_mode():
        cate_text = model.encode_text(ids)
        null_text = model.encode_text(torch.zeros_like(ids[:1]))[0]
    return GenerationInputs(
        init_latents=rand(F, s, s, C), outfit_idx=torch.zeros(F, dtype=torch.long, device=dev),
        known_latents=rand(1, F, s, s, C) * 0.2,
        gen_mask=torch.ones(1, F, dtype=torch.bool, device=dev),
        gen_index=torch.arange(F, device=dev).view(1, F), hist_latents=rand(F, s, s, C) * 0.2,
        cate_text=cate_text, null_text=null_text, null_latent=rand(s, s, C) * 0.05)


def test_tiny_sampler_in_fp32(dev):
    """mixed_precision other than "bf16" builds an fp32 model: `build_sampler`
    at the tiny config runs every UNet attention on the fp32 kernel and
    matches the CPU's fp32 run."""
    import copy

    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.engine.generate import build_sampler, make_guidance_spec
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn.attention import CrossAttention
    from difashion_tpu_torch.nn.layers import GroupNorm

    cpu = create_difashion(ModelConfig.tiny(), seed=0, device="cpu")
    cuda = copy.deepcopy(cpu).to(dev)
    n_attn = sum(isinstance(m, CrossAttention) for m in cpu.unet.modules())
    n_gn = sum(isinstance(m, GroupNorm) for m in cpu.unet.modules())
    out = {}
    for name, model, where in (("cpu", cpu, "cpu"), ("cuda", cuda, dev)):
        sampler = build_sampler(model, num_inference_steps=5,
                                spec=make_guidance_spec(12.0, 4.0, 5.0), eta=0.1)
        kernels.reset_launches()
        out[name] = sampler(_tiny_inputs(model, where)).cpu()
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        "flash_attention_fwd_f32": 6 * n_attn, "group_norm_silu": 6 * n_gn}
    assert bool(torch.isfinite(out["cuda"]).all())
    assert _rel(out["cuda"], out["cpu"]) <= 1e-4


def test_fp32_train_step(dev):
    """One train step of the tiny config with mixed_precision="no" (autocast
    off, fp32 throughout): the fp32 forward, dQ and dK/dV kernels under every
    UNet attention, a finite loss and moved parameters."""
    from difashion_tpu_torch.config import ModelConfig, TrainConfig
    from difashion_tpu_torch.engine.train import TrainBatch, build_train_step
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn.attention import CrossAttention

    cfg, tc = ModelConfig.tiny(), TrainConfig(mixed_precision="no")
    model = create_difashion(cfg, seed=0, device=dev)
    n_attn = sum(isinstance(m, CrossAttention) for m in model.unet.modules())
    step, init = build_train_step(model, tc)
    state = init()
    before = [p.detach().clone() for p in state.params]
    g = torch.Generator(device=dev).manual_seed(1)
    B, olen, s, C = tc.train_batch_size, 4, cfg.unet.sample_size, cfg.vae.latent_channels
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    batch = TrainBatch(images=None, latent_mean=r(B, olen, s, s, C),
                       latent_logvar=r(B, olen, s, s, C) - 6.0,
                       input_ids=torch.randint(0, cfg.text.vocab_size, (B, olen, 77),
                                               generator=g, device=dev),
                       hist_latents=r(B, olen, s, s, C) * 0.3)
    with torch.no_grad():
        null_text = model.encode_text(torch.zeros(1, 77, dtype=torch.long, device=dev))[0]
    kernels.reset_launches()
    state, metrics = step(state, batch, r(s, s, C) * 0.05, null_text, g)
    torch.cuda.synchronize()
    launches = {n: c for n, c in kernels.LAUNCHES.items() if c and "flash" in n}
    assert launches == {"flash_attention_fwd_f32": n_attn, "flash_attention_dq_f32": n_attn,
                        "flash_attention_dkv_f32": n_attn}
    assert np.isfinite(float(metrics["loss"])) and not bool(metrics["update_skipped"])
    assert any(not torch.equal(a, p) for a, p in zip(before, state.params))


# ---- GroupNorm (+ SiLU) ------------------------------------------------------

GN_SHAPES = [  # (B, C, H, W, groups): both routes, one CTA and clusters, ragged S
    (2, 64, 8, 8, 32),
    (3, 64, 4, 4, 8),          # the tiny config's groups; HW = 16
    (1, 96, 7, 7, 32),         # HW = 49, cg 3: bands of 8 groups, ragged boxes
    (2, 960, 16, 16, 32),      # C/G = 30, the UNet's widest up-level norm
    (1, 960, 64, 64, 32),      # its 64x64 level: a cluster of 10 (non-portable size)
    (1, 128, 128, 128, 32),    # a VAE level: a cluster over 16384 rows
    (1, 512, 256, 256, 32),    # 4 MB a band in fp32: two passes
    (2, 4, 1, 1, 2),           # one element per channel
    (2, 33, 5, 7, 3),          # odd C: 66-byte rows, no TMA, scalar two passes
]


def _gn_inputs(shape, groups, dtype, dev, seed=0, offset=0.0):
    """x channels-last (drawn as [B, H, W, C]), scale and bias [C]."""
    b, c = shape[:2]
    g = torch.Generator(device=dev).manual_seed(seed)
    nhwc = (b,) + tuple(shape[2:]) + (c,)
    x = (torch.randn(nhwc, generator=g, device=dev) * 2 + offset).to(dtype).movedim(-1, 1)
    scale = torch.randn(c, generator=g, device=dev) * 0.5 + 1
    bias = torch.randn(c, generator=g, device=dev) * 0.5
    return x, scale, bias


def _gn_close(got, want, pre, dtype):
    """fp32: 1e-5. 16-bit types: one unit in the last place of the plain
    version's rounding, of y or (after SiLU) of the y it was computed from
    (2^-7 of the value for bf16, 2^-10 for fp16), plus 1e-5 for the fp32
    rounding of y = x * a + b near zero."""
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return bool((diff <= 1e-5 + 1e-5 * want.abs()).all())
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    return bool((diff <= rel * (want.float().abs() + pre.float().abs()) + 1e-5).all())


@pytest.mark.parametrize("b,c,h,w,groups", GN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_kernel_matches_plain(dev, b, c, h, w, groups, dtype, act):
    x, scale, bias = _gn_inputs((b, c, h, w), groups, dtype, dev)
    kernels.reset_launches()
    y = group_norm_silu(x, scale, bias, groups, 1e-6, act)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["group_norm_silu"] == 1
    pre = group_norm_silu_ref(x, scale, bias, groups, 1e-6)
    want = group_norm_silu_ref(x, scale, bias, groups, 1e-6, act)
    assert y.dtype == dtype and y.shape == x.shape and is_channels_last(y)
    assert bool(torch.isfinite(y).all())
    assert _gn_close(y, want, pre, dtype)
    # deterministic: no atomics, a fixed merge order (the cluster's too)
    for _ in range(3):
        assert torch.equal(y, group_norm_silu(x, scale, bias, groups, 1e-6, act))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_kernel_misaligned_and_ragged(dev, dtype):
    """x starting off a 16-byte boundary (a batch row of a [B, S, C] buffer
    whose rows are 2 elements short of 16 bytes) takes the scalar two-pass
    route; a ragged S (7 x 9) on a 16-byte C the one-read route."""
    b, c, groups = 3, 64, 8
    g = torch.Generator(device=dev).manual_seed(4)
    buf = torch.randn(b * 63 * c + 2, generator=g, device=dev).to(dtype)
    x = buf[2:].view(b, 7, 9, c).movedim(-1, 1)
    assert x.data_ptr() % 16 and is_channels_last(x)
    scale, bias = torch.rand(c, generator=g, device=dev) + 0.5, torch.randn(c, device=dev)
    assert gn_plan(x.shape, groups, dtype, aligned=False).route == "two_pass"
    for xx in (x, x.clone()):
        y = group_norm_silu(xx, scale, bias, groups, 1e-5, "silu")
        pre = group_norm_silu_ref(xx, scale, bias, groups, 1e-5)
        assert _gn_close(y, torch.nn.functional.silu(pre), pre, dtype)
        assert torch.equal(y, group_norm_silu(xx, scale, bias, groups, 1e-5, "silu"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_kernel_large_offset(dev, dtype):
    """|mean| >> std: the (count, mean, M2) merge does not cancel."""
    x, scale, bias = _gn_inputs((2, 64, 32, 32), 8, dtype, dev, seed=1, offset=100.0)
    y = group_norm_silu(x, scale, bias, 8, 1e-5)
    if dtype == torch.bfloat16:
        pre = group_norm_silu_ref(x, scale, bias, 8, 1e-5)
        assert _gn_close(y, pre, pre, dtype)
        return
    ref = torch.nn.functional.group_norm(x.double(), 8, scale.double(), bias.double(), 1e-5)
    # y = x * a + b cancels products of about 50 (x ~ 100, a ~ 0.5), whose fp32
    # rounding (50 * 2^-24 = 3e-6 each) is the floor here; a variance taken as
    # E[x^2] - E[x]^2 in fp32 would be off by ~2.5e-4 of itself and move y by ~1e-4
    assert (y.double() - ref).abs().max().item() <= 4e-5


def test_group_norm_kernel_beyond_2_31_elements(dev):
    """65 x 128 x 512 x 512 bf16 (2^31 + 2^25 elements, the VAE encoder's
    first level one image past the precompute batch): 64-bit offsets."""
    b, c, s, groups = 65, 128, 512, 32
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(b, s, s, c, generator=g, device=dev, dtype=torch.bfloat16).movedim(-1, 1)
    assert x.numel() > 2 ** 31 and gn_plan(x.shape, groups, x.dtype).route == "two_pass"
    scale = torch.rand(c, generator=g, device=dev) + 0.5
    bias = torch.randn(c, generator=g, device=dev) * 0.1
    y = group_norm_silu(x, scale, bias, groups, 1e-6, "silu")
    torch.cuda.synchronize()
    assert torch.equal(y[-1:], group_norm_silu(x, scale, bias, groups, 1e-6, "silu")[-1:])
    for i in (0, b - 1):
        pre = group_norm_silu_ref(x[i:i + 1], scale, bias, groups, 1e-6)
        want = group_norm_silu_ref(x[i:i + 1], scale, bias, groups, 1e-6, "silu")
        assert _gn_close(y[i:i + 1], want, pre, torch.bfloat16)
    del x, y
    torch.cuda.empty_cache()


def test_group_norm_kernel_at_a_1024px_decoder_shape(dev):
    """The SDXL decode's last level: 128 channels at 1024 x 1024, groups of
    4 channels x 1,048,576 pixels (4x the 512 px decode's), bf16, two images:
    the two-pass route, within the plain version's rounding, deterministic."""
    x, scale, bias = _gn_inputs((2, 128, 1024, 1024), 32, torch.bfloat16, dev, seed=5)
    assert gn_plan(x.shape, 32, x.dtype).route == "two_pass"
    kernels.reset_launches()
    y = group_norm_silu(x, scale, bias, 32, 1e-6, "silu")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["group_norm_silu"] == 1
    pre = group_norm_silu_ref(x, scale, bias, 32, 1e-6)
    want = group_norm_silu_ref(x, scale, bias, 32, 1e-6, "silu")
    assert _gn_close(y, want, pre, torch.bfloat16)
    assert torch.equal(y, group_norm_silu(x, scale, bias, 32, 1e-6, "silu"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_plain_version_either_layout(dev, dtype):
    """The plain version on the card gives the same numbers on channels-last
    and on NCHW x (per-channel moments over S: no layout copy), up to the
    order of its fp32 sums."""
    x, scale, bias = _gn_inputs((2, 320, 32, 32), 32, dtype, dev, seed=3, offset=3.0)
    got = group_norm_silu_ref(x, scale, bias, 32, 1e-6, "silu")
    want = group_norm_silu_ref(x.contiguous(), scale, bias, 32, 1e-6, "silu")
    assert is_channels_last(got) and want.is_contiguous()
    assert _gn_close(got, want, group_norm_silu_ref(x, scale, bias, 32, 1e-6), dtype)


def test_group_norm_wrapper_rejects(dev):
    x, scale, bias = _gn_inputs((2, 64, 8, 8), 8, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        group_norm_silu(x.transpose(2, 3), scale, bias, 8, 1e-5)      # not contiguous
    with pytest.raises(ValueError):
        group_norm_silu(x.contiguous(), scale, bias, 8, 1e-5)         # NCHW, not channels-last
    with pytest.raises(ValueError):
        group_norm_silu(x, scale, bias, 6, 1e-5)                      # 64 % 6
    with pytest.raises(TypeError):
        group_norm_silu(x.double(), scale, bias, 8, 1e-5)
    with pytest.raises(ValueError):
        group_norm_silu(x, scale.cpu(), bias, 8, 1e-5)
    with pytest.raises(ValueError):
        group_norm_silu(x, scale, bias, 8, 1e-5, act="gelu")


def test_group_norm_module_routes_through_the_kernel(dev):
    from difashion_tpu_torch.nn.layers import GroupNorm

    gn = GroupNorm(8, 64, eps=1e-5, act="silu").to(dev)
    with torch.no_grad():
        gn.weight.normal_()
        gn.bias.normal_()
    x = torch.randn(2, 64, 16, 16, device=dev).bfloat16().requires_grad_()
    dy = torch.randn(2, 64, 16, 16, device=dev).bfloat16()
    kernels.reset_launches()
    with torch.inference_mode():
        gn(x.detach())
    # an NCHW input is made channels-last for the kernel
    gn(x.detach().contiguous())
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = gn(x)
    y.backward(dy)
    assert kernels.LAUNCHES["group_norm_silu"] == 3
    grads = [t.grad.clone() for t in (x, gn.weight, gn.bias)]
    for t in (x, gn.weight, gn.bias):
        t.grad = None
    with kernels.plain_versions(), torch.autocast("cuda", dtype=torch.bfloat16):
        y_plain = gn(x)
        y_plain.backward(dy)
    assert kernels.LAUNCHES["group_norm_silu"] == 3
    assert y.dtype == y_plain.dtype == torch.bfloat16
    pre = group_norm_silu_ref(x.detach(), gn.weight, gn.bias, 8, 1e-5)
    assert _gn_close(y, y_plain, pre, torch.bfloat16)
    # the backward recomputes the plain version: the same gradients, but for
    # the order of the CUDA backward's sums
    for got, t in zip(grads, (x, gn.weight, gn.bias)):
        assert got.dtype == t.dtype and _rel(got, t.grad) <= 1e-3


# ---- skinny-N matmul ---------------------------------------------------------------

MM_SHAPES = [  # (M, K, N): the route's shapes, both tile widths, ragged edges
    (8192, 320, 320),
    (4096, 640, 640),
    (2048, 1280, 1280),
    (4096, 1280, 320),         # net_2 at C = 320
    (2048, 640, 2560),         # dx of net_2 at C = 640
    (1000, 96, 200),           # M, N and the last K chunk ragged
    (130, 40, 24),
]


def _mm_inputs(m, k, n, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = (torch.randn(n, k, generator=g, device=dev) / k ** 0.5).to(dtype)
    return x, w


# the fp32 kernel against its plain 3xTF32 version: the same split products
# summed in another order (chip_smoke.py's F32_MM_TOL)
F32_MM_TOL = 2e-6


def _mm_counter(dtype):
    return "skinny_matmul_f32" if dtype == torch.float32 else "skinny_matmul"


def _mm_plain(dtype):
    """The plain version the kernel of `dtype` is held against: the fp32
    kernel's arithmetic (3xTF32) in fp32, the fp32 sum rounded once in 16 bits."""
    return skinny_matmul_3xtf32_ref if dtype == torch.float32 else skinny_matmul_ref


def _mm_close(got, want, dtype):
    """16 bits: both sum in fp32 and round once: at most one unit in the last
    place apart (2^-7 of the value in bf16, 2^-10 in fp16), plus the fp32
    sums' order near zero. fp32: F32_MM_TOL relative L2."""
    if dtype == torch.float32:
        return _rel(got, want) <= F32_MM_TOL
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    diff = (got.float() - want.float()).abs()
    return bool((diff <= rel * want.float().abs() + 1e-3).all())


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_skinny_matmul_kernel_matches_plain(dev, m, k, n, dtype):
    x, w = _mm_inputs(m, k, n, dtype, dev)
    kernels.reset_launches()
    o = skinny_matmul(x, w)
    torch.cuda.synchronize()
    assert {c: v for c, v in kernels.LAUNCHES.items() if v} == {_mm_counter(dtype): 1}
    assert o.dtype == dtype and o.shape == (m, n) and o.is_contiguous()
    assert _mm_close(o, _mm_plain(dtype)(x, w), dtype)
    # a row stride wider than K (a view into a wider tensor) reads in place
    wide = torch.zeros(m, k + 8, dtype=dtype, device=dev)
    wide[:, :k] = x
    assert torch.equal(skinny_matmul(wide[:, :k], w), o)


def _mm_close_after_bias(got, want, prod, dtype):
    """Kernel vs plain with a bias: the products may round one unit in the
    last place apart (as `_mm_close`), and the sums with the bias round once
    more (a unit of the result's). fp32: F32_MM_TOL relative L2."""
    if dtype == torch.float32:
        return _rel(got, want) <= F32_MM_TOL
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    diff = (got.float() - want.float()).abs()
    return bool((diff <= rel * (prod.float().abs() + want.float().abs()) + 1e-3).all())


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("w_kn", [False, True])
def test_skinny_matmul_bias_and_layout_match_plain(dev, m, k, n, dtype, w_kn):
    """The kernel with a bias, and with the weight given as [K, N] (`w_kn`,
    the backward's dx layout), against the plain version; the [K, N] form of
    a weight gives what its [N, K] form gives."""
    x, w = _mm_inputs(m, k, n, dtype, dev, seed=1)
    b = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(2), device=dev).to(dtype)
    wl = w.t().contiguous() if w_kn else w
    plain = _mm_plain(dtype)
    kernels.reset_launches()
    o = skinny_matmul(x, wl, b, w_kn=w_kn)
    torch.cuda.synchronize()
    assert {c: v for c, v in kernels.LAUNCHES.items() if v} == {_mm_counter(dtype): 1}
    assert o.dtype == dtype and o.shape == (m, n) and o.is_contiguous()
    prod = plain(x, wl, w_kn=w_kn)
    assert _mm_close_after_bias(o, plain(x, wl, b, w_kn=w_kn), prod, dtype)
    no_bias = skinny_matmul(x, wl, w_kn=w_kn)
    assert _mm_close(no_bias, prod, dtype) and _mm_close(no_bias, skinny_matmul(x, w), dtype)


@pytest.mark.parametrize("m,k,n", [(512, 64, 30), (2048, 320, 1001)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_skinny_matmul_odd_n_matches_plain(dev, m, k, n, dtype):
    """N % 8 != 0: rows of o are not 16-byte multiples, so the epilogue
    stores from registers instead of through TMA (the fp32 kernel stores
    from registers always, single floats where N is odd)."""
    x, w = _mm_inputs(m, k, n, dtype, dev, seed=5)
    b = torch.randn(n, device=dev).to(dtype)
    plain = _mm_plain(dtype)
    for bias in (None, b):
        kernels.reset_launches()
        o = skinny_matmul(x, w, bias)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[_mm_counter(dtype)] == 1
        prod = plain(x, w)
        assert o.shape == (m, n) and o.is_contiguous()
        assert _mm_close_after_bias(o, plain(x, w, bias), prod, dtype)


def test_skinny_matmul_f32_against_fp64(dev):
    """The fp32 kernel no farther from an fp64 product than 1.25x its plain
    3xTF32 version (both drop lo * lo), and far closer than one TF32 pass
    (F.linear with TF32 allowed) at a routed shape, in both layouts."""
    rel = lambda a, b: ((a.double() - b).norm() / b.norm()).item()
    x, w = _mm_inputs(8192, 640, 640, torch.float32, dev, seed=6)
    b = torch.randn(640, device=dev)
    ref = x.double() @ w.double().t() + b.double()
    plain = rel(skinny_matmul_3xtf32_ref(x, w, b), ref)
    for o in (skinny_matmul(x, w, b), skinny_matmul(x, w.t().contiguous(), b, w_kn=True)):
        assert rel(o, ref) <= 1.25 * plain
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = torch.nn.functional.linear(x, w, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert rel(skinny_matmul(x, w, b), ref) < rel(one_pass, ref) / 50


def test_skinny_matmul_wrapper_rejects_bias_and_layout(dev):
    x, w = _mm_inputs(512, 64, 64, torch.bfloat16, dev)
    b = torch.zeros(64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        skinny_matmul(x, w, b.float())                       # bias dtype
    with pytest.raises(ValueError):
        skinny_matmul(x, w, b[:32])                          # bias length
    with pytest.raises(ValueError):
        skinny_matmul(x, w, b.cpu())
    with pytest.raises(ValueError):
        skinny_matmul(x, w[:60].t().contiguous(), w_kn=True)  # [K, N] with N % 8
    with pytest.raises(ValueError):
        skinny_matmul(x, w[:32], w_kn=True)                  # [K, N] with K != x's


def test_skinny_matmul_wrapper_rejects(dev):
    x, w = _mm_inputs(512, 64, 64, torch.bfloat16, dev)
    with pytest.raises(TypeError):
        skinny_matmul(x.float(), w)                          # mixed dtypes
    with pytest.raises(TypeError):
        skinny_matmul(x.double(), w.double())                # no kernel's dtype
    with pytest.raises(ValueError):
        skinny_matmul(x[:, :60], w[:, :60])                  # K % 8
    with pytest.raises(ValueError):
        skinny_matmul(x.float()[:, :62], w.float()[:, :62])  # fp32: K % 4
    with pytest.raises(ValueError):
        skinny_matmul(x.float(), w.float()[:62].t().contiguous(), w_kn=True)  # fp32 N % 4
    with pytest.raises(ValueError):
        skinny_matmul(x.t(), w)                              # not unit stride along K
    with pytest.raises(ValueError):
        skinny_matmul(x, w.cpu())


def test_dense_routes_through_the_kernel(dev):
    from difashion_tpu_torch.nn.layers import Dense

    dense = Dense(320, 640).to(dev)
    with torch.no_grad():
        dense.bias.normal_()
    x = torch.randn(2, 2048, 320, device=dev).requires_grad_()
    dy = torch.randn(2, 2048, 640, device=dev).bfloat16()
    kernels.reset_launches()
    with torch.inference_mode():
        dense(x.detach())                                    # fp32: the fp32 kernel
    assert kernels.LAUNCHES["skinny_matmul"] == 0 and kernels.LAUNCHES["skinny_matmul_f32"] == 1
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = dense(x)                                          # fp32 master weight, bf16 compute
    y.backward(dy)
    assert kernels.LAUNCHES["skinny_matmul"] == 2            # forward and dx
    assert y.dtype == torch.bfloat16 and y.shape == (2, 2048, 640)
    grads = [t.grad.clone() for t in (x, dense.weight, dense.bias)]
    for t in (x, dense.weight, dense.bias):
        t.grad = None
    with kernels.plain_versions(), torch.autocast("cuda", dtype=torch.bfloat16):
        y_plain = dense(x)
        y_plain.backward(dy)
    assert kernels.LAUNCHES["skinny_matmul"] == 2
    assert _rel(y, y_plain) <= 1e-2
    for got, t in zip(grads, (x, dense.weight, dense.bias)):
        assert got.dtype == t.dtype == torch.float32 and _rel(got, t.grad) <= 1e-2
    # M = 1024 is outside the gate: F.linear
    with torch.autocast("cuda", dtype=torch.bfloat16), torch.no_grad():
        dense(x[:, :512])
    assert kernels.LAUNCHES["skinny_matmul"] == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_routes_only_what_the_kernel_reads(dev, dtype):
    """At 2048 rows the gate takes Dense(30, 100) and Dense(64, 100); the
    kernels cannot read K = 30 (nor, in 16 bits, dx's N = 100) nor an x
    whose row stride is off: those go to F.linear / torch.matmul, no launch
    and no error. Each against F.linear and its autograd."""
    from difashion_tpu_torch.nn.layers import Dense

    name = "skinny_matmul" if dtype == torch.bfloat16 else "skinny_matmul_f32"
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5

    def run(k, n, strided=False):
        dense = Dense(k, n).to(dev)
        # x in the compute dtype, so that autocast's cast keeps its strides
        base = torch.randn(2048, k + (1 if strided else 0), device=dev).to(dtype)
        x = (base[:, :k] if strided else base).requires_grad_()
        g = torch.randn(2048, n, device=dev)
        auto = torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16)
        kernels.reset_launches()
        with auto:
            y = dense(x)
        y.backward(g.to(y.dtype))
        launches = kernels.LAUNCHES[name]
        got = [y.detach(), x.grad.clone(), dense.weight.grad.clone()]
        x.grad = dense.weight.grad = dense.bias.grad = None
        with auto:
            y = F.linear(x, dense.weight, dense.bias)
        y.backward(g.to(y.dtype))
        for a, b in zip(got, (y.detach(), x.grad, dense.weight.grad)):
            assert _rel(a, b) <= tol
        return launches

    assert run(30, 100) == 0
    assert run(64, 64, strided=True) == 0
    # bf16: the kernel forward, dx plain (100 % 8); fp32: both on the kernel
    assert run(64, 100) == (1 if dtype == torch.bfloat16 else 2)


@pytest.mark.parametrize("kernel", ["skinny_matmul", "flash_attention", "group_norm_silu"])
def test_kernel_launches_from_a_fresh_thread(dev, kernel):
    """A kernel's launch as the first CUDA call of a new thread (as the dx
    of a Dense is in the thread autograd starts for a backward): the wrapper
    binds the device's context before its driver calls."""
    import threading

    if kernel == "skinny_matmul":
        x, w = _mm_inputs(2048, 320, 640, torch.bfloat16, dev)
        run = lambda: skinny_matmul(x, w, w_kn=False)
    elif kernel == "flash_attention":
        q, k, v = _qkv(1, 2, 256, 256, 64, torch.bfloat16, dev)
        run = lambda: flash_attention(q, k, v)[0]
    else:
        x = torch.randn(2, 64, 8, 8, device=dev).to(memory_format=torch.channels_last)
        s, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
        run = lambda: group_norm_silu(x, s, b, 32, 1e-5, "silu")
    want = run()
    torch.cuda.synchronize()
    out = {}

    def worker():
        try:
            out["y"] = run()
            torch.cuda.synchronize()
        except Exception as e:   # reported in the main thread
            out["error"] = e

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and "error" not in out, out.get("error")
    assert torch.equal(out["y"], want)


def test_skinny_matmul_autograd_with_bias_matches_plain(dev):
    """Forward with the bias in the epilogue, dx through the kernel on the
    stored weight (no transposed copy), dw and db plain: against the plain
    Function."""
    x, w = _mm_inputs(4096, 320, 640, torch.bfloat16, dev, seed=4)
    b = torch.randn(640, device=dev).bfloat16()
    for t in (x, w, b):
        t.requires_grad_()
    g = torch.randn(4096, 640, device=dev).bfloat16()
    kernels.reset_launches()
    y = SkinnyMatmul.apply(x, w, False, b)
    y.backward(g)
    assert kernels.LAUNCHES["skinny_matmul"] == 2
    grads = [t.grad.clone() for t in (x, w, b)]
    for t in (x, w, b):
        t.grad = None
    y_plain = SkinnyMatmul.apply(x, w, True, b)
    y_plain.backward(g)
    assert _mm_close_after_bias(y, y_plain, skinny_matmul_ref(x, w), torch.bfloat16)
    assert _mm_close(grads[0], x.grad, torch.bfloat16)
    assert torch.equal(grads[1], w.grad) and torch.equal(grads[2], b.grad)
    assert grads[2].dtype == torch.bfloat16


def test_skinny_matmul_f32_autograd_matches_plain(dev):
    """fp32 through `Dense`: the forward and dx on the fp32 kernel (one
    launch each), dw and db plain; against the plain versions (fp32 F.linear
    and its autograd, TF32 off)."""
    from difashion_tpu_torch.nn.layers import Dense

    dense = Dense(320, 640).to(dev)
    with torch.no_grad():
        dense.bias.normal_()
    x = torch.randn(2, 2048, 320, device=dev).requires_grad_()
    dy = torch.randn(2, 2048, 640, device=dev)
    kernels.reset_launches()
    y = dense(x)
    y.backward(dy)
    assert {c: v for c, v in kernels.LAUNCHES.items() if v} == {"skinny_matmul_f32": 2}
    grads = [t.grad.clone() for t in (x, dense.weight, dense.bias)]
    for t in (x, dense.weight, dense.bias):
        t.grad = None
    with kernels.plain_versions():
        y_plain = dense(x)
        y_plain.backward(dy)
    assert kernels.LAUNCHES["skinny_matmul_f32"] == 2
    assert y.dtype == torch.float32 and _rel(y, y_plain) <= 1e-5
    for got, t in zip(grads, (x, dense.weight, dense.bias)):
        assert got.dtype == torch.float32 and _rel(got, t.grad) <= 1e-5


def test_skinny_matmul_autograd_matches_plain(dev):
    x, w = _mm_inputs(4096, 320, 640, torch.bfloat16, dev, seed=3)
    x.requires_grad_()
    w.requires_grad_()
    g = torch.randn(4096, 640, device=dev).bfloat16()
    kernels.reset_launches()
    SkinnyMatmul.apply(x, w, False).backward(g)
    assert kernels.LAUNCHES["skinny_matmul"] == 2
    dx, dw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    SkinnyMatmul.apply(x, w, True).backward(g)
    assert _mm_close(dx, x.grad, torch.bfloat16) and torch.equal(dw, w.grad)


# GEGLU's projections of a UNet forward at sd2_base and sd15 (the same widths:
# C = 320, 640, 1280 at 4096, 1024, 256 and 64 tokens), M cut to 8192 rows,
# and ragged ones: (M, K, F), the weight [2F, K]
GEGLU_SHAPES = [(8192, 320, 1280), (8192, 640, 2560), (8192, 1280, 5120), (4096, 1280, 5120),
                (4100, 1280, 5120), (1000, 96, 128), (130, 40, 256)]
# the share of elements on which the kernel and its plain version (cuBLAS's
# fp32 product, another order of the sums) round apart on random inputs: at
# most 0.13 % in bf16 and 1.1 % in fp16 at K = 1280 on the H100, each within
# `rounding_gap_bound`
GEGLU_APART_SHARE = {torch.bfloat16: 0.005, torch.float16: 0.02}


def _geglu_inputs(m, k, f, dtype, dev, exact, seed=0):
    """x [M, K], w [2F, K], bias [2F]: random, or (`exact`) on grids whose
    fp32 sums over K are exact in any order (multiples of 2^-9 below 2^8),
    so that the kernel and the plain version round the same sums."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if exact:
        grid = lambda lo, shape, scale: (torch.randint(-lo, lo + 1, shape, generator=g,
                                                       device=dev) / scale).to(dtype)
        return grid(8, (m, k), 8.0), grid(8, (2 * f, k), 64.0), grid(64, (2 * f,), 32.0)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = (torch.randn(2 * f, k, generator=g, device=dev) / k ** 0.5).to(dtype)
    return x, w, (0.5 * torch.randn(2 * f, generator=g, device=dev)).to(dtype)


@pytest.mark.parametrize("m,k,f", GEGLU_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_geglu_matmul_kernel_matches_plain(dev, m, k, f, dtype):
    """The fused kernel at every tile width it is built for, with and
    without a bias: bit for bit where the sums are exact; on
    random inputs apart on at most GEGLU_APART_SHARE of the elements, each
    by no more than one unit of the rounded sums carries to the output; one
    launch per call through the wrapper, counted as geglu_matmul only."""
    from difashion_tpu_torch.nn.kernels import geglu_matmul as gg

    xe, we, be = _geglu_inputs(m, k, f, dtype, dev, exact=True)
    x, w, b = _geglu_inputs(m, k, f, dtype, dev, exact=False, seed=1)
    for bias_e, bias in ((be, b), (None, None)):
        want_e, want = gg.geglu_matmul_ref(xe, we, bias_e), gg.geglu_matmul_ref(x, w, bias)
        bound = gg.rounding_gap_bound(x, w, bias)
        for bn in gg.TILE_WIDTHS:
            got = gg.launch(xe, we, bias_e, bn)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (m, f) and got.is_contiguous()
            assert torch.equal(got, want_e), bn
            gap = (gg.launch(x, w, bias, bn).float() - want.float()).abs()
            assert (gap > 0).float().mean() <= GEGLU_APART_SHARE[dtype], bn
            assert bool((gap <= bound).all()), bn
    kernels.reset_launches()
    o = gg.geglu_matmul(x, w, b)
    torch.cuda.synchronize()
    assert {c: v for c, v in kernels.LAUNCHES.items() if v} == {"geglu_matmul": 1}
    assert torch.equal(o, gg.launch(x, w, b, gg.tile_width(k)))
    # a row stride wider than K (a view into a wider tensor) reads in place
    wide = torch.zeros(m, k + 8, dtype=dtype, device=dev)
    wide[:, :k] = x
    assert torch.equal(gg.geglu_matmul(wide[:, :k], w, b), o)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_geglu_gelu_is_torch_gelu_at_every_input(dev, dtype):
    """The epilogue's gelu (round(gelu(v)), erff in fp32) at all 65,536
    16-bit patterns against PyTorch's GELU on the card, bit for bit (NaNs as
    NaNs: their bits are the converters')."""
    from difashion_tpu_torch.nn.kernels import geglu_matmul as gg

    patterns = torch.arange(65536, dtype=torch.int32, device=dev)
    patterns = torch.where(patterns >= 32768, patterns - 65536, patterns).to(torch.int16)
    got = gg.gelu_all(dtype, dev)
    want = F.gelu(patterns.view(dtype).float()).to(dtype).view(torch.int16)
    nan = torch.isnan(got.view(dtype)) & torch.isnan(want.view(dtype))
    assert bool(((got == want) | nan).all())
    assert int(nan.sum()) == int(torch.isnan(want.view(dtype)).sum()) > 0


def test_geglu_matmul_wrapper_rejects(dev):
    from difashion_tpu_torch.nn.kernels import geglu_matmul as gg

    x, w, b = _geglu_inputs(512, 64, 128, torch.bfloat16, dev, exact=False)
    with pytest.raises(TypeError):
        gg.geglu_matmul(x.float(), w.float(), b.float())          # fp32
    with pytest.raises(ValueError):
        gg.geglu_matmul(x, w[:192], b[:192])                      # F = 96
    with pytest.raises(ValueError):
        gg.geglu_matmul(x[:, :60], w[:, :60].contiguous(), b)     # K % 8
    with pytest.raises(ValueError):
        gg.geglu_matmul(x, w, b.cpu())
    with pytest.raises(ValueError):
        gg.geglu_matmul(x, w.cpu(), b)


def test_geglu_routes_per_unet_forward(dev):
    """An sd2_base UNet forward (2 rows) in bf16: 16 fused launches without
    autograd, the skinny-N kernel's launches as many as on the unfused path
    (the route patched off), and the output within the unfused path's
    rounding; under autograd (bf16 autocast over fp32 weights, the train
    step's forward) no fused launch."""
    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.models.unet import UNet2DCondition
    from difashion_tpu_torch.nn import layers

    cfg = ModelConfig.sd2_base().unet
    torch.manual_seed(0)
    unet = UNet2DCondition(cfg).to(dev)
    for mod in unet.modules():   # the residual branches' outputs are not zero here
        if isinstance(mod, layers.GEGLU):
            torch.nn.init.normal_(mod.proj.bias, std=0.5)
    s = cfg.sample_size
    x = torch.randn(2, cfg.in_channels, s, s, device=dev)
    t = torch.tensor([10, 700], device=dev)
    ctx = torch.randn(2, 77, cfg.cross_attention_dim, device=dev)
    counts = {}
    unet16 = UNet2DCondition(cfg).to(dev).to(torch.bfloat16)
    unet16.load_state_dict(unet.state_dict())
    route = layers.geglu_route
    with torch.inference_mode():
        for name, patched in (("fused", route), ("unfused", lambda *a: False)):
            layers.geglu_route = patched
            try:
                kernels.reset_launches()
                counts[name] = (unet16(x.bfloat16(), t, ctx.bfloat16()).float(),
                                dict(kernels.LAUNCHES))
            finally:
                layers.geglu_route = route
    (fused, n_fused), (unfused, n_unfused) = counts["fused"], counts["unfused"]
    assert n_fused["geglu_matmul"] == 16 and n_unfused["geglu_matmul"] == 0
    assert n_fused["skinny_matmul"] == n_unfused["skinny_matmul"] > 0
    assert _rel(fused, unfused) <= 2e-2
    kernels.reset_launches()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = unet(x, t, ctx)
    y.float().square().mean().backward()
    assert kernels.LAUNCHES["geglu_matmul"] == 0 and kernels.LAUNCHES["skinny_matmul"] > 0


def test_tiny_xl_forward_through_the_kernels(dev):
    """The tiny SDXL-shaped bundle in bf16 (per-level depth, the added
    conditioning, two text towers): the text encode and a UNet forward
    through the kernels against the same through their plain versions;
    every transformer block's attentions on the flash kernel and its
    GEGLU on the fused kernel."""
    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn.attention import BasicTransformerBlock

    model = create_difashion(ModelConfig.tiny_xl(), seed=0, device=dev, dtype=torch.bfloat16)
    n_blocks = sum(isinstance(m, BasicTransformerBlock) for m in model.unet.modules())
    g = torch.Generator(device=dev).manual_seed(6)
    ids = torch.randint(1, 990, (4, 77), generator=g, device=dev)
    ids[:, 12] = 999
    x = torch.randn(4, 8, 8, 8, generator=g, device=dev).bfloat16()
    t = torch.tensor([10, 300, 600, 990], device=dev)
    time_ids = torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 4, device=dev)
    out = {}
    with torch.inference_mode():
        for name in ("kernels", "plain"):
            with kernels.plain_versions() if name == "plain" else contextlib.nullcontext():
                kernels.reset_launches()
                ctx, pooled = model.encode_text(ids, pooled=True)
                eps = model.apply_unet(x, t, ctx, pooled, time_ids)
                torch.cuda.synchronize()
                out[name] = (ctx.float(), pooled.float(), eps.float(), dict(kernels.LAUNCHES))
    (ctx, pooled, eps, n), (ctx_p, pooled_p, eps_p, n_p) = out["kernels"], out["plain"]
    assert n_blocks == 18 and n["flash_attention_fwd"] == 2 * n_blocks
    assert n["geglu_matmul"] == n_blocks and n["group_norm_silu"] > 0
    assert not any(n_p.values())
    assert bool(torch.isfinite(eps).all())
    assert _rel(ctx, ctx_p) <= 1e-2 and _rel(pooled, pooled_p) <= 1e-2
    assert _rel(eps, eps_p) <= 2e-2


def _tiny_train_dataset(path, n_items=16):
    """A synthetic dataset for the train command at the tiny config: 6
    outfits, a history, 5 categories and the catalog's [16, 8, 8, 4] moments."""
    from difashion_tpu_torch.data.precompute import save_processed

    rng = np.random.RandomState(0)
    path.mkdir()
    table = {"uids": list(rng.randint(1, 4, 6)), "oids": list(range(100, 106)),
             "outfits": [list(o) for o in rng.randint(1, n_items, (6, 4))],
             "category": [list(c) for c in rng.randint(1, 6, (6, 4))]}
    for name, d in (("train.npy", table), ("train_history.npy", {1: {2: [3, 4]}}),
                    ("id_cate_dict.npy", {c: f"cate{c}" for c in range(1, 6)})):
        np.save(path / name, np.array(d, dtype=object))
    save_processed(str(path), "all_item_moments",
                   mean=rng.randn(n_items, 8, 8, 4).astype(np.float32),
                   logvar=rng.uniform(-8, -2, (n_items, 8, 8, 4)).astype(np.float32))
    return str(path)


def test_train_cli_tiny_on_the_card(dev, tmp_path):
    from difashion_tpu_torch.checkpoint import CheckpointStore
    from difashion_tpu_torch.cli import train as train_cli
    from difashion_tpu_torch.engine.train import AdamState, EMAState, TrainState

    data, out = _tiny_train_dataset(tmp_path / "data"), str(tmp_path / "ckpt")
    args = ["--tiny", "--data_path", data, "--output_dir", out]   # --device cuda by default
    kernels.reset_launches()
    state, model = train_cli.main(args + ["--max_train_steps", "3"])
    launches = dict(kernels.LAUNCHES)
    assert state.params[0].is_cuda and state.step == 3
    # bf16 autocast: every attention of the 3 steps through the 16-bit kernels
    for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
                 "group_norm_silu"):
        assert launches[name] > 0 and launches[name] % 3 == 0, launches
    assert launches["flash_attention_fwd_f32"] == 0
    empty = lambda ts: [torch.empty_like(t) for t in ts]
    template = TrainState(names=list(state.names), params=empty(state.params),
                          opt_state=AdamState(0, empty(state.opt_state.mu),
                                              empty(state.opt_state.nu)),
                          ema=EMAState(empty(state.ema.params), 0))
    loaded = CheckpointStore(out).load(template)
    assert loaded.step == 3 and loaded.opt_state.count == 3 and loaded.ema.step == 3
    for a, b in zip(state.params + state.opt_state.mu + state.opt_state.nu + state.ema.params,
                    loaded.params + loaded.opt_state.mu + loaded.opt_state.nu
                    + loaded.ema.params):
        assert torch.equal(a, b)
    kernels.reset_launches()
    resumed, _ = train_cli.main(args + ["--max_train_steps", "4",
                                        "--resume_from_checkpoint", "latest"])
    assert resumed.step == 4 and CheckpointStore(out).all_steps() == [3, 4]
    assert dict(kernels.LAUNCHES) == {k: v // 3 for k, v in launches.items()}


def test_info_reports_the_card(dev, capsys):
    import json

    from difashion_tpu_torch.cli import info

    out = info.main(["--json", "--model", "tiny"])
    assert json.loads(capsys.readouterr().out) == out
    assert out["backend"] == "cuda" and out["devices"] == torch.cuda.device_count()
    assert out["device_kind"] == torch.cuda.get_device_name(0)
    assert out["cuda"] == torch.version.cuda and out["hbm_accounting"]["fits_dp"]

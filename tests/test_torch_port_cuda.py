"""The flash-attention CUDA kernels (forward, dQ, dK/dV) against their plain
versions, on the card.

Every test here needs an NVIDIA GPU (Hopper, sm_90a) with the CUDA toolkit, is
marked `cuda`, and skips elsewhere. The module imports torch only (no JAX), so
on a GPU machine without JAX it runs with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

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

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
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


def test_sdpa_routes(dev):
    q, k, v = _qkv(2, 2, 128, 77, 64, torch.bfloat16, dev)
    kernels.reset_launches()
    out = sdpa(q, k, v)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    ref = sdpa(q, k, v, plain=True)
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    # d > 128 (the VAE mid-attention) takes the plain path
    wq, wk, wv = _qkv(1, 1, 64, 64, 512, torch.bfloat16, dev)
    sdpa(wq, wk, wv)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    with pytest.raises(NotImplementedError):
        sdpa(q.float(), k.float(), v.float())
    fq, fk, fv = _qkv(1, 1, 64, 64, 80, torch.bfloat16, dev)
    with pytest.raises(NotImplementedError):
        sdpa(fq, fk, fv)


def test_wrapper_rejects(dev):
    q, k, v = _qkv(1, 1, 64, 64, 64, torch.bfloat16, dev)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :, :32], v)


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


def test_sdpa_autograd_routes_through_the_kernels(dev):
    q, k, v = (t.requires_grad_() for t in _qkv(2, 5, 256, 77, 64, torch.bfloat16, dev,
                                                 seed=5))
    do = torch.randn(2, 5, 256, 64, device=dev).bfloat16()
    kernels.reset_launches()
    out = sdpa(q, k, v)
    out.backward(do)
    assert dict(kernels.LAUNCHES) == {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                                      "flash_attention_dkv": 1}
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    sdpa(q, k, v, plain=True).backward(do)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    for got, t in zip(grads, (q, k, v)):
        assert _rel(got, t.grad) <= 2e-2
    # without autograd the forward kernel runs alone and saves nothing
    with torch.no_grad():
        assert sdpa(q, k, v).grad_fn is None
    assert kernels.LAUNCHES["flash_attention_dq"] == 1

"""The flash-attention CUDA kernel against its plain version, on the card.

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
    flash_attention,
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

"""The flash-attention kernel's plain version, which the port runs on the CPU,
against the JAX package's Pallas kernel in interpret mode. The CUDA kernel
itself is held against the same plain version on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difashion_tpu.nn.pallas.flash_attention import flash_attention as jax_flash
from difashion_tpu_torch.nn import kernels
from difashion_tpu_torch.nn.attention import sdpa
from difashion_tpu_torch.nn.kernels.flash_attention import (
    F32_SOURCE,
    FWD_HEAD_DIMS,
    MAX_HEAD_DIM,
    attention_delta,
    flash_attention,
    flash_attention_bwd_ref,
    flash_attention_ref,
    kernel_head_dim,
    pad_head_dim,
)

SHAPES = [
    (1, 2, 256, 256, 64),    # self-attention, aligned
    (2, 1, 384, 384, 64),    # several q blocks
    (1, 2, 256, 77, 64),     # cross-attention: ragged KV
    (1, 1, 100, 50, 32),     # both dims ragged
    (1, 2, 64, 64, 64),      # the short self-attention of the UNet's mid level
    (1, 2, 77, 77, 64),
    (1, 2, 200, 77, 40),     # sd15's head dims (8 heads over 320 and 640 channels)
    (2, 1, 130, 150, 80),
]


def _qkv(b, h, sq, skv, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d))]


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
def test_plain_version_matches_pallas_kernel(b, h, sq, skv, d):
    q, k, v = _qkv(b, h, sq, skv, d)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=128, block_kv=128, interpret=True))
    o, lse = flash_attention_ref(*map(torch.from_numpy, (q, k, v)))
    # fp32 throughout; same bound as tests/test_flash_attention.py
    np.testing.assert_allclose(o.numpy(), ref, rtol=2e-5, atol=2e-5)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / np.sqrt(d)
    mx = s.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want.reshape(b * h, sq),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_uses_plain_version_on_cpu_without_launching():
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 40, 77, 16, seed=1))
    kernels.reset_launches()
    o, lse = flash_attention(q, k, v, scale=0.3)
    ro, rlse = flash_attention_ref(q, k, v, scale=0.3)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert o.shape == (2, 2, 40, 16) and lse.shape == (4, 40)
    assert sdpa(q, k, v).shape == (2, 2, 40, 16)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 0


def test_sdpa_matches_jax_sdpa_on_cpu():
    """The router's CPU paths: d <= 128 -> the plain flash version; d > 128
    -> plain matmul + softmax, as the JAX package computes both there."""
    from difashion_tpu.nn.attention import sdpa as jax_sdpa

    for shape, seed in (((1, 2, 12, 9, 8), 2), ((1, 1, 16, 16, 160), 3)):
        q, k, v = _qkv(*shape, seed=seed)
        want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   use_flash=False))
        got = sdpa(*map(torch.from_numpy, (q, k, v)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        with kernels.plain_versions():
            got = sdpa(*map(torch.from_numpy, (q, k, v)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_sdpa_at_sd15_head_dims_matches_jax_sdpa(d):
    """sd15's head dims through the router on the CPU: 40 and 80 the plain
    flash version (the kernels' on the card), 160 plain matmul + softmax, as
    the JAX package computes them there."""
    from difashion_tpu.nn.attention import sdpa as jax_sdpa

    for skv in (96, 77):
        q, k, v = _qkv(2, 8, 96, skv, d, seed=d + skv)
        want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   use_flash=False))
        got = sdpa(*map(torch.from_numpy, (q, k, v)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [20, 40, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_padding_helper_keeps_the_function(d, dtype):
    """What the kernels are handed for a head dim d: padded with zero columns
    (a copy laid out as [B, S, H, dp]) and run at the scale of the unpadded
    d, the forward and the backward then sliced back equal the unpadded
    ones: zero columns add nothing to S, dP or D."""
    fwd_dp = kernel_head_dim(d, dtype)
    bwd_dp = kernel_head_dim(d, dtype, backward=True)
    if dtype == torch.float32:
        assert fwd_dp == bwd_dp == d
    else:
        # the backward kernels read the head dim in place as the forward does:
        # a copy only for d % 8 != 0 (20 -> 24), none for sd15's 40 and 80
        assert fwd_dp == -(-d // 8) * 8 and fwd_dp % 8 == 0
        assert bwd_dp == fwd_dp == {20: 24, 40: 40, 80: 80, 128: 128}[d]
    q, k, v, do = (torch.from_numpy(x) for x in
                   _qkv(2, 3, 70, 77, d, seed=d) + _qkv(2, 3, 70, 1, d, seed=d + 1)[:1])
    o, lse = flash_attention_ref(q, k, v)
    grads = flash_attention_bwd_ref(q, k, v, o, lse, do)
    scale = d ** -0.5
    # and the zero columns the kernels' TMA boxes add, up to 64 or 128
    for dp in {fwd_dp, bwd_dp, 64 if d <= 64 else 128, 128}:
        qp, kp, vp, dop = (pad_head_dim(t, dp) for t in (q, k, v, do))
        assert qp.shape == (2, 3, 70, dp) and torch.equal(qp[..., :d], q)
        assert not qp[..., d:].any() and (dp == d or qp.transpose(1, 2).is_contiguous())
        po, plse = flash_attention_ref(qp, kp, vp, scale)
        torch.testing.assert_close(po[..., :d], o, rtol=1e-6, atol=1e-6)
        assert not po[..., d:].any()
        torch.testing.assert_close(plse, lse, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(attention_delta(po, dop), attention_delta(o, do),
                                   rtol=1e-6, atol=1e-6)
        pgrads = flash_attention_bwd_ref(qp, kp, vp, po, plse, dop, scale)
        for pg, g in zip(pgrads, grads):
            torch.testing.assert_close(pg[..., :d], g, rtol=1e-5, atol=1e-6)
            assert not pg[..., d:].any()
    assert pad_head_dim(q, d) is q
    with pytest.raises(ValueError):
        kernel_head_dim(MAX_HEAD_DIM + 8, dtype)


def test_kernel_source_covers_the_wrapper_head_dims():
    """The forward's CUDA source instantiates the padded head dims the
    wrapper's head dims land on (every multiple of 8 up to 128 in 16 bits, its
    TMA boxes padding to 64 or 128), the fp32 source every d up to 128; both
    carry their source notes (the TPU kernel they replace)."""
    src = open(os.path.join(kernels.CSRC_DIR, "flash_attention_fwd.cu")).read()
    cases = tuple(int(c) for c in re.findall(r"case (\d+): return launch_default", src))
    assert cases == FWD_HEAD_DIMS
    assert "const int dp = a.D <= 64 ? 64 : 128;" in src
    for d in range(1, MAX_HEAD_DIM + 1):
        dp = kernel_head_dim(d, torch.bfloat16)
        assert dp % 8 == 0 and d <= dp <= MAX_HEAD_DIM
    assert "flash_attention.py::_fwd_kernel" in src
    assert 'extern "C" int flash_attention_fwd(' in src
    f32 = open(os.path.join(kernels.CSRC_DIR, f"{F32_SOURCE}.cu")).read()
    for dp in (32, 64, 128):
        assert f"fwd<{dp}>(" in f32 and f"dq<{dp}>(" in f32 and f"dkv<{dp}>(" in f32
    assert "D <= 128" in f32 and "::_fwd_kernel" in f32

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
    HEAD_DIMS,
    flash_attention,
    flash_attention_ref,
)

SHAPES = [
    (1, 2, 256, 256, 64),    # self-attention, aligned
    (2, 1, 384, 384, 64),    # several q blocks
    (1, 2, 256, 77, 64),     # cross-attention: ragged KV
    (1, 1, 100, 50, 32),     # both dims ragged
    (1, 2, 64, 64, 64),      # the short self-attention of the UNet's mid level
    (1, 2, 77, 77, 64),
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
        for plain in (False, True):
            got = sdpa(*map(torch.from_numpy, (q, k, v)), plain=plain)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_kernel_source_covers_the_wrapper_head_dims():
    """The CUDA source instantiates exactly the head dims the wrapper admits,
    and carries its source note (the TPU kernel it replaces)."""
    src = open(os.path.join(kernels.CSRC_DIR, "flash_attention_fwd.cu")).read()
    cases = tuple(int(c) for c in re.findall(r"case (\d+): return launch", src))
    assert cases == HEAD_DIMS
    assert "flash_attention.py::_fwd_kernel" in src
    assert 'extern "C" int flash_attention_fwd' in src

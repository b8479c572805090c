"""The flash-attention backward's plain version, which the port runs on the
CPU, against the JAX package's Pallas backward kernels (`_dq_kernel`,
`_dkv_kernel`, through `jax.vjp` of `flash_attention` in interpret mode), and
the autograd Function around the kernels. The CUDA kernels themselves are held
against the same plain versions on the card (tests/test_torch_port_cuda.py,
chip_smoke.py)."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difashion_tpu.nn.pallas.flash_attention import flash_attention as jax_flash
from difashion_tpu_torch.nn import kernels
from difashion_tpu_torch.nn.attention import sdpa
from difashion_tpu_torch.nn.kernels.flash_attention import (
    BWD_HEAD_DIMS,
    F32_SOURCE,
    FlashAttention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)

SHAPES = [
    (1, 2, 256, 256, 64),    # aligned self-attention
    (1, 2, 256, 77, 64),     # cross-attention: ragged KV
    (1, 1, 100, 50, 32),     # both dims ragged
    (1, 2, 64, 64, 64),      # the mid level's short self-attention
    (1, 2, 77, 77, 64),
    (2, 3, 130, 77, 16),     # the tiny config's head dim
    (1, 2, 200, 77, 40),     # sd15's head dims
    (2, 1, 130, 150, 80),
]


def _inputs(b, h, sq, skv, d, seed=0):
    """q, k, v and a random cotangent (never all ones: a constant cotangent
    makes dO V^T - D vanish along rows and hides errors in dS)."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d), (b, h, sq, d))]


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
def test_plain_backward_matches_pallas_vjp(b, h, sq, skv, d):
    q, k, v, do = _inputs(b, h, sq, skv, d)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, block_q=128, block_kv=128,
                                               interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo)
    # fp32 throughout; the bound of tests/test_flash_attention.py's backward test
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    kernels.reset_launches()
    for g, w in zip(flash_attention_bwd(tq, tk, tv, o, lse, tdo), got):
        assert torch.equal(g, w)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("plain", [False, True])
def test_function_matches_autograd_of_the_plain_forward(plain):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 2, 70, 77, 16, seed=1))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FlashAttention.apply(*leaves, 0.3, plain)
    out.backward(do)
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_ref(*refs, scale=0.3)[0].backward(do)
    assert torch.equal(out, flash_attention_ref(q, k, v, scale=0.3)[0])
    for a, r in zip(leaves, refs):
        torch.testing.assert_close(a.grad, r.grad, rtol=1e-5, atol=1e-6)


def test_sdpa_records_only_under_autograd():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 2, 40, 77, 16, seed=2))
    with torch.no_grad():
        assert sdpa(q.requires_grad_(), k, v).grad_fn is None
    with torch.inference_mode():
        assert sdpa(q, k, v).grad_fn is None
    out = sdpa(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(do)
    assert q.grad is not None and q.grad.shape == q.shape


def test_backward_kernel_sources_cover_the_wrapper_head_dims():
    """Each backward kernel's source instantiates the head dims the wrapper
    admits, names the TPU kernel it replaces, and is built with the others."""
    for name, tpu in (("flash_attention_dq", "_dq_kernel"),
                      ("flash_attention_dkv", "_dkv_kernel")):
        assert name in kernels.KERNELS and name in kernels.LAUNCHES
        src = open(os.path.join(kernels.CSRC_DIR, f"{name}.cu")).read()
        cases = tuple(int(c) for c in re.findall(r"case (\d+): return launch", src))
        assert cases == BWD_HEAD_DIMS
        assert f"flash_attention.py::{tpu}" in src
        assert f'extern "C" int {name}' in src
    # the fp32 forward, dQ and dK/dV: one source, built with the others, each
    # kernel counted under its own name
    assert F32_SOURCE in kernels.KERNELS
    src = open(os.path.join(kernels.CSRC_DIR, f"{F32_SOURCE}.cu")).read()
    for name, tpu in (("flash_attention_fwd", "_fwd_kernel"), ("flash_attention_dq", "_dq_kernel"),
                      ("flash_attention_dkv", "_dkv_kernel")):
        assert f"{name}_f32" in kernels.LAUNCHES and f"{tpu}" in src
        assert f'extern "C" int {name}_f32(' in src

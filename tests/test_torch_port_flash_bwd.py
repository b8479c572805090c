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
    DKV_TILES,
    F32_SOURCE,
    FWD_HEAD_DIMS,
    MAX_HEAD_DIM,
    SM_COUNT,
    SPLIT_MIN_Q_TILES,
    FlashAttention,
    dkv_splits,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
    kernel_head_dim,
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
    """Each backward kernel's source instantiates the padded head dims the
    wrapper's head dims land on (its TMA boxes pad every multiple of 8 up to
    128 to 64 or 128, as the forward's do), names the TPU kernel it replaces,
    is built with the others and sums without atomics; the dK/dV source
    builds the tiles the split plan assumes and has the split entry."""
    for name, tpu in (("flash_attention_dq", "_dq_kernel"),
                      ("flash_attention_dkv", "_dkv_kernel")):
        assert name in kernels.KERNELS and name in kernels.LAUNCHES
        src = open(os.path.join(kernels.CSRC_DIR, f"{name}.cu")).read()
        cases = tuple(int(c) for c in re.findall(r"case (\d+): return launch<T, \d+,", src))
        assert cases == FWD_HEAD_DIMS
        assert "const int dp = a.D <= 64 ? 64 : 128;" in src
        assert f"flash_attention.py::{tpu}" in src
        assert f'extern "C" int {name}(' in src
        assert '#include "hopper_common.cuh"' in src and "wgmma_rs_cols" in src
        assert "atomic" not in src.lower().replace("no atomics", "")
    src = open(os.path.join(kernels.CSRC_DIR, "flash_attention_dkv.cu")).read()
    for dp, (nc, bq) in DKV_TILES.items():
        built = re.search(rf"kTile{dp}\[4\] = \{{(\d+), (\d+), (\d+), ([01])\}}", src).groups()
        assert (int(built[0]), int(built[1])) == (nc, bq)
    assert 'extern "C" int flash_attention_dkv_split(' in src
    # the fp32 forward, dQ and dK/dV: one source, built with the others, each
    # kernel counted under its own name
    assert F32_SOURCE in kernels.KERNELS
    src = open(os.path.join(kernels.CSRC_DIR, f"{F32_SOURCE}.cu")).read()
    for name, tpu in (("flash_attention_fwd", "_fwd_kernel"), ("flash_attention_dq", "_dq_kernel"),
                      ("flash_attention_dkv", "_dkv_kernel")):
        assert f"{name}_f32" in kernels.LAUNCHES and f"{tpu}" in src
        assert f'extern "C" int {name}_f32(' in src


def test_backward_head_dim_rule_is_the_forward_rule():
    """The dQ and dK/dV kernels are handed what the forward is handed, for
    every head dim up to 128: d itself where d % 8 == 0 (no padded copy),
    else the next multiple of 8; fp32 always d."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for d in range(1, MAX_HEAD_DIM + 1):
            dp = kernel_head_dim(d, dtype, backward=True)
            assert dp == kernel_head_dim(d, dtype)
            assert dp == (d if dtype == torch.float32 or d % 8 == 0 else -(-d // 8) * 8)


# (B, H, Sq, Skv, d) of the training UNet's attentions at the recipe's 8 rows
# (sd2_base: 5 / 10 / 20 / 20 heads at 4096 / 1024 / 256 / 64 tokens) and of
# sd15's (8 heads, d = 40 and 80)
TRAIN_SITES = {
    "self_4096": (8, 5, 4096, 4096, 64), "cross_4096x77": (8, 5, 4096, 77, 64),
    "self_1024": (8, 10, 1024, 1024, 64), "cross_1024x77": (8, 10, 1024, 77, 64),
    "self_256": (8, 20, 256, 256, 64), "cross_256x77": (8, 20, 256, 77, 64),
    "mid_self_64": (8, 20, 64, 64, 64), "mid_cross_64x77": (8, 20, 64, 77, 64),
    "sd15_self_4096": (8, 8, 4096, 4096, 40), "sd15_cross_4096x77": (8, 8, 4096, 77, 40),
    "sd15_self_1024": (8, 8, 1024, 1024, 80), "sd15_cross_1024x77": (8, 8, 1024, 77, 80),
}


@pytest.mark.parametrize("site", sorted(TRAIN_SITES))
def test_dkv_split_plan_at_the_training_sites(site):
    """The 77-token cross-attention at 4096 tokens (one KV tile a head: 40
    tiles at batch 8 and 5 heads, 64 at sd15's 8, on 132 SMs) is split into
    as many parts as one wave takes; every other site of the training step
    is not: self-attention fills the card with KV tiles, and the shorter
    cross-attentions have too few Q tiles for a part to pay for its
    workspace pass."""
    b, h, sq, skv, d = TRAIN_SITES[site]
    splits = dkv_splits(b, h, sq, skv, d)
    assert splits == {"cross_4096x77": 3, "sd15_cross_4096x77": 2}.get(site, 1)


def test_dkv_split_plan_never_makes_an_empty_part():
    """The kernel cuts the Q tiles into parts of ceil(q_tiles / splits) each:
    every one of the plan's parts gets at least SPLIT_MIN_Q_TILES Q tiles
    but the last (at least one), and a split plan fills at most one wave of
    SMs."""
    for b in (1, 2, 8):
        for h in (1, 5, 8, 20):
            for sq in (1, 63, 64, 77, 100, 300, 1000, 4096, 8192):
                for skv in (1, 77, 100, 300, 4096):
                    for d in (16, 64, 80, 128):
                        nc, bq = DKV_TILES[64 if d <= 64 else 128]
                        splits = dkv_splits(b, h, sq, skv, d)
                        q_tiles = -(-sq // bq)
                        per = -(-q_tiles // splits)
                        assert splits >= 1 and (splits - 1) * per < q_tiles
                        if splits > 1:
                            assert per >= SPLIT_MIN_Q_TILES
                            assert -(-skv // (64 * nc)) * b * h * splits <= SM_COUNT

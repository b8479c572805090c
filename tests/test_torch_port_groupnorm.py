"""The GroupNorm(+SiLU) kernel's plain version and its autograd Function, which
the port runs on the CPU, against the JAX package: `group_norm_act` with the
Pallas kernel in interpret mode, `jax.grad` through its custom VJP, the
reference `_gn_silu_ref` in bf16, and the committed torch-oracle fixture
`prim_pallas_gn_silu.npz`. The CUDA kernel itself is held against the same
plain version on the card (tests/test_torch_port_cuda.py, chip_smoke.py).

Tolerances: fp32 1e-5 (sums in another order). bf16: the GroupNorm within one
unit in the last place of the reference's rounding; after SiLU the port is
within one unit of SiLU on the reference's rounded y, and within two of the
reference's own bf16 SiLU, which rounds the sigmoid before its product."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from difashion_tpu.nn.pallas.groupnorm import _gn_silu_ref, group_norm_act
from difashion_tpu_torch.nn import kernels
from difashion_tpu_torch.nn.kernels.groupnorm import (
    GroupNormSiLU,
    chunking,
    group_norm_silu,
    group_norm_silu_ref,
    tile_elements,
)
from difashion_tpu_torch.nn.layers import GroupNorm

from golden_oracle import oracle

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = [  # NHWC shape, groups: C in {32, 96, 960}, groups 8 and 32
    ((2, 4, 4, 32), 8),
    ((1, 6, 6, 96), 32),
    ((1, 2, 2, 960), 32),
    ((2, 5, 5, 64), 8),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed=0, offset=0.5):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + offset).astype(np.float32)
    return x, (rng.randn(c) * 0.5 + 1).astype(np.float32), (rng.randn(c) * 0.5).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _ulp_bf16(v):
    """One unit in the last place of bf16 values (8 significant bits)."""
    v = np.abs(np.asarray(v, np.float32))
    e = np.floor(np.log2(np.where(v > 0, v, 1.0)))
    return np.where(v > 0, 2.0 ** (e - 7), 2.0 ** -133)


@pytest.mark.parametrize("shape,groups", CASES)
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("act", [None, "silu"])
def test_plain_version_matches_pallas_kernel(shape, groups, eps, act):
    x, s, b = _inputs(shape)
    want = np.asarray(group_norm_act(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                     groups=groups, eps=eps, act=act, interpret=True))
    got = group_norm_silu_ref(nchw(x), torch.from_numpy(s), torch.from_numpy(b),
                              groups, eps, act)
    np.testing.assert_allclose(nhwc(got), want, **TOL)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    kernels.reset_launches()
    same = group_norm_silu(nchw(x), torch.from_numpy(s), torch.from_numpy(b), groups, eps, act)
    assert torch.equal(same, got) and not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("shape,groups", CASES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_plain_version_bf16_matches_reference_rounding(shape, groups, act):
    x, s, b = _inputs(shape, seed=1)
    bsz, c = shape[0], shape[-1]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = lambda a: np.asarray(_gn_silu_ref(xb.reshape(bsz, -1, c), jnp.asarray(s),
                                            jnp.asarray(b), groups, 1e-6, a)
                               .reshape(shape).astype(jnp.float32))
    pre, want = ref("none"), ref(act or "none")
    xt = nchw(np.asarray(xb.astype(jnp.float32))).bfloat16()
    got_t = group_norm_silu_ref(xt, torch.from_numpy(s), torch.from_numpy(b), groups, 1e-6, act)
    assert got_t.dtype == torch.bfloat16
    got = nhwc(got_t)
    if act is None:
        assert (np.abs(got - want) <= _ulp_bf16(want)).all()
        return
    # SiLU of the reference's rounded y, computed once in fp32 and rounded
    on_ref = nhwc(F.silu(nchw(pre).bfloat16()))
    assert (np.abs(got - on_ref) <= _ulp_bf16(on_ref)).all()
    assert (np.abs(got - want) <= 2 * _ulp_bf16(want)).all()


def test_plain_version_matches_torch_oracle_fixture():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 6, 64).astype(np.float32)
    s = rng.randn(64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)

    def missing():
        raise AssertionError("committed fixture prim_pallas_gn_silu is missing")

    ref = oracle("prim_pallas_gn_silu", missing)["ref"]
    got = group_norm_silu_ref(nchw(x), torch.from_numpy(s), torch.from_numpy(b), 8, 1e-5,
                              "silu")
    np.testing.assert_allclose(nhwc(got), ref, **TOL)


@pytest.mark.parametrize("shape,groups", CASES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_function_matches_jax_custom_vjp(shape, groups, act):
    """GroupNormSiLU's forward and backward (the plain version on the CPU,
    the backward recomputed through it) against jax.grad through the
    `_gn_silu` custom VJP, with a random cotangent."""
    x, s, b = _inputs(shape, seed=2)
    ct = np.random.RandomState(3).randn(*shape).astype(np.float32)

    def loss(x, s, b):
        y = group_norm_act(x, s, b, groups=groups, eps=1e-5, act=act, interpret=True)
        return jnp.sum(y * jnp.asarray(ct)), y

    (_, want_y), want_g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    leaves = [t.requires_grad_() for t in (nchw(x), torch.from_numpy(s), torch.from_numpy(b))]
    y = GroupNormSiLU.apply(*leaves, groups, 1e-5, act)
    y.backward(nchw(ct))
    np.testing.assert_allclose(nhwc(y), np.asarray(want_y), **TOL)
    got_g = (nhwc(leaves[0].grad), leaves[1].grad.numpy(), leaves[2].grad.numpy())
    for got, want in zip(got_g, want_g):
        want = np.asarray(want)
        # the scale and bias gradients sum over every element of the channel
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_function_backward_dtypes_follow_the_plain_version():
    """bf16 x with fp32 scale and bias (the autocast case), with and without
    CPU autocast: the gradients come back in the dtype of each input."""
    x, s, b = _inputs((2, 4, 4, 32), seed=4)
    for autocast in (False, True):
        leaves = [nchw(x).bfloat16().requires_grad_(), torch.from_numpy(s).requires_grad_(),
                  torch.from_numpy(b).requires_grad_()]
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
            y = GroupNormSiLU.apply(*leaves, 8, 1e-5, "silu")
            y.float().sum().backward()
        assert y.dtype == torch.bfloat16
        assert [t.grad.dtype for t in leaves] == [torch.bfloat16, torch.float32, torch.float32]


def test_large_offset_input():
    """|mean| >> std (x ~ 100 +- 2): the port's plain version keeps fp32
    accuracy against float64. The JAX reference takes E[x^2] - E[x]^2 in
    fp32, which cancels here; its distance is printed beside, not held."""
    x, s, b = _inputs((2, 8, 8, 64), seed=5, offset=100.0)
    want = F.group_norm(nchw(x).double(), 8, torch.from_numpy(s).double(),
                        torch.from_numpy(b).double(), 1e-5)
    got = group_norm_silu_ref(nchw(x), torch.from_numpy(s), torch.from_numpy(b), 8, 1e-5)
    # y = x * a + b cancels products of about 50: their fp32 rounding, 3e-6
    # each, is the floor
    assert (got.double() - want).abs().max().item() <= 1e-5
    jax_y = np.asarray(group_norm_act(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                      groups=8, eps=1e-5, interpret=True))
    print("JAX kernel (interpret) vs float64 at offset 100:",
          np.abs(jax_y - nhwc(want)).max())


def test_module_routes_and_switch():
    """On the CPU the module computes the plain version, launching nothing,
    with or without the plain switch and autograd; contiguous or not."""
    x, s, b = _inputs((2, 4, 4, 32), seed=6)
    gn = GroupNorm(8, 32, eps=1e-6, act="silu")
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(s))
        gn.bias.copy_(torch.from_numpy(b))
    xt = nchw(x)
    want = group_norm_silu_ref(xt, gn.weight, gn.bias, 8, 1e-6, "silu")
    kernels.reset_launches()
    with torch.no_grad():
        assert torch.equal(gn(xt), want)
        assert torch.equal(gn(xt.to(memory_format=torch.channels_last)), want)
    assert torch.allclose(gn(xt), want)
    assert gn(xt).grad_fn is not None
    with kernels.plain_versions():
        assert kernels.plain_active()
        assert torch.allclose(gn(xt), want)
    assert not kernels.plain_active()
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError):
        GroupNorm(8, 32, act="gelu")


@pytest.mark.parametrize("span,n_groups,dtype", [
    (122_880, 16 * 32, torch.bfloat16),    # UNet 64x64 up-level norm over 960 channels
    (1_048_576, 64 * 32, torch.bfloat16),  # VAE 512x512 level at the precompute batch
    (1_048_576, 4 * 32, torch.float32),    # VAE decode at batch 4
    (2_560, 16 * 32, torch.bfloat16),      # UNet 8x8 level: one partial tile
    (2, 2, torch.float16),                 # one element per channel
])
def test_chunking_covers_every_group(span, n_groups, dtype):
    chunks, per_chunk = chunking(span, n_groups, dtype)
    tile = tile_elements(dtype)
    tiles = -(-span // tile)
    assert 1 <= chunks <= 65535 and per_chunk >= 1
    # every chunk starts inside the span, and together they cover it
    assert (chunks - 1) * per_chunk < tiles <= chunks * per_chunk
    assert tile == 256 * 2 * 16 // dtype.itemsize
    if n_groups * tiles >= 2048:
        assert n_groups * chunks >= min(2048, n_groups * tiles) // 2


def test_kernel_source_and_registry():
    src = open(os.path.join(kernels.CSRC_DIR, "group_norm_silu.cu")).read()
    assert "groupnorm.py::_gn_silu_kernel" in src
    assert 'extern "C" int group_norm_silu' in src
    assert "group_norm_silu" in kernels.KERNELS and "group_norm_silu" in kernels.LAUNCHES

"""The port's layers and attention modules against the JAX package's, in fp32 on
the CPU, with the same weights (the JAX module's params through
`core/importer.py::export_params`, loaded strictly) and the same numpy inputs.
Where the JAX package has a committed torch-oracle fixture for the primitive,
the port is held against it too. Tolerance 1e-4 / 1e-4: fp32 sums in another
order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difashion_tpu.core.importer import export_params
from difashion_tpu.nn import attention as ja
from difashion_tpu.nn import layers as jl
from difashion_tpu_torch.nn import attention as ta
from difashion_tpu_torch.nn import layers as tl

from golden_oracle import oracle

TOL = dict(rtol=1e-4, atol=1e-4)


def _fixture(name):
    def missing():
        raise AssertionError(f"committed fixture {name} is missing")
    return oracle(name, missing)["ref"]


def _jax(module, *args, key=0):
    """Init the flax module on `args` (numpy), apply it; (params, numpy out)."""
    jargs = [jnp.asarray(a) for a in args]
    params = jax.jit(module.init)(jax.random.PRNGKey(key), *jargs)["params"]
    out = jax.jit(module.apply)({"params": params}, *jargs)
    return params, np.asarray(out)


def _port(module, params):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_params(params, "unet").items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_timestep_embedding_and_mlp():
    t = np.array([0, 1, 17, 500, 999], np.int32)
    want = np.asarray(jl.get_timestep_embedding(jnp.asarray(t), 32))
    got = tl.get_timestep_embedding(torch.from_numpy(t), 32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    params, want = _jax(jl.TimestepEmbedding(64), want)
    got = _port(tl.TimestepEmbedding(32, 64), params)(torch.from_numpy(got))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_groupnorm(eps):
    x = np.random.RandomState(3).randn(2, 4, 4, 8).astype(np.float32)
    params, want = _jax(jl.GroupNorm(num_groups=4, epsilon=eps), x)
    got = nhwc(_port(tl.GroupNorm(4, 8, eps=eps), params)(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _fixture(f"prim_groupnorm_{eps}"), **TOL)


def test_groupnorm_silu_with_affine():
    rng = np.random.RandomState(13)
    x = (rng.randn(2, 6, 6, 16) * 3 + 1).astype(np.float32)
    m = jl.GroupNorm(num_groups=4, epsilon=1e-6, act="silu")
    params = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)
    want = np.asarray(jax.jit(m.apply)({"params": params}, jnp.asarray(x)))
    got = nhwc(_port(tl.GroupNorm(4, 16, eps=1e-6, act="silu"), params)(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stride,k", [(1, 3), (1, 1), (2, 3)])
def test_conv2d(stride, k):
    x = np.random.RandomState(0).randn(2, 8, 8, 4).astype(np.float32)
    params, want = _jax(jl.Conv2d(features=6, kernel_size=k, strides=stride), x)
    conv = torch.nn.Conv2d(4, 6, k, stride=stride, padding=(k - 1) // 2)
    got = nhwc(_port(conv, params)(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _fixture(f"prim_conv2d_s{stride}_k{k}"), **TOL)
    if stride == 1:
        assert isinstance(tl.conv2d(4, 6, k), torch.nn.Conv2d)
        assert tl.conv2d(4, 6, k).padding == ((k - 1) // 2,) * 2


def test_resnet_block():
    rng = np.random.RandomState(7)
    x = rng.randn(1, 4, 4, 8).astype(np.float32)
    temb = rng.randn(1, 16).astype(np.float32)
    params, want = _jax(jl.ResnetBlock2D(out_channels=12, groups=4), x, temb)
    block = _port(tl.ResnetBlock2D(8, 12, 16, groups=4), params)
    got = nhwc(block(nchw(x), torch.from_numpy(temb)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _fixture("prim_resnet_block"), **TOL)


def test_resnet_block_on_a_skip_concat():
    """The UNet's up path: the JAX block runs norm1/conv1/shortcut in split
    form over (h, skip); the port runs it on torch.cat([h, skip], 1)."""
    rng = np.random.RandomState(17)
    h = rng.randn(2, 4, 4, 8).astype(np.float32)
    skip = rng.randn(2, 4, 4, 4).astype(np.float32)
    temb = rng.randn(2, 16).astype(np.float32)
    m = jl.ResnetBlock2D(out_channels=8, groups=4)
    args = (jnp.asarray(h), jnp.asarray(temb), jnp.asarray(skip))
    params = jax.jit(lambda key, x, t, s: m.init(key, x, t, True, s))(
        jax.random.PRNGKey(1), *args)["params"]
    want = np.asarray(jax.jit(lambda p, x, t, s: m.apply({"params": p}, x, t, True, s))(
        params, *args))
    block = _port(tl.ResnetBlock2D(12, 8, 16, groups=4), params)
    got = nhwc(block(torch.cat([nchw(h), nchw(skip)], 1), torch.from_numpy(temb)))
    np.testing.assert_allclose(got, want, **TOL)


def test_downsample_and_upsample():
    x = np.random.RandomState(1).randn(1, 8, 8, 4).astype(np.float32)
    params, want = _jax(jl.Downsample2D(out_channels=4), x)
    got = nhwc(_port(tl.Downsample2D(4), params)(nchw(x)))
    assert got.shape == (1, 4, 4, 4)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _fixture("prim_downsample"), **TOL)

    x = np.random.RandomState(2).randn(1, 4, 4, 4).astype(np.float32)
    params, want = _jax(jl.Upsample2D(out_channels=4), x)
    got = nhwc(_port(tl.Upsample2D(4), params)(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _fixture("prim_upsample"), **TOL)


def test_geglu_and_feedforward():
    x = np.random.RandomState(4).randn(2, 5, 8).astype(np.float32)
    params, want = _jax(jl.GEGLU(dim_out=16), x)
    got = _port(tl.GEGLU(8, 16), params)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _fixture("prim_geglu"), **TOL)

    params, want = _jax(jl.FeedForward(dim=8), x)
    got = _port(tl.FeedForward(8), params)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_sdpa_fixture():
    rng = np.random.RandomState(5)
    q = rng.randn(2, 3, 16, 8).astype(np.float32)
    k = rng.randn(2, 3, 12, 8).astype(np.float32)
    v = rng.randn(2, 3, 12, 8).astype(np.float32)
    got = ta.sdpa(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, _fixture("prim_sdpa"), **TOL)


def test_cross_attention():
    rng = np.random.RandomState(6)
    x = rng.randn(1, 10, 16).astype(np.float32)
    ctx = rng.randn(1, 7, 16).astype(np.float32)
    params, want = _jax(ja.CrossAttention(query_dim=16, heads=2, head_dim=8,
                                          context_dim=16), x, ctx)
    m = _port(ta.CrossAttention(16, 2, 8, 16), params)
    got = m(torch.from_numpy(x), torch.from_numpy(ctx)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _fixture("prim_cross_attention"), **TOL)


def test_basic_transformer_block():
    rng = np.random.RandomState(9)
    x = (rng.randn(1, 6, 16) * 1e-3).astype(np.float32)
    ctx = rng.randn(1, 4, 16).astype(np.float32)
    params, want = _jax(ja.BasicTransformerBlock(16, 2, 8, 16), x, ctx)
    m = _port(ta.BasicTransformerBlock(16, 2, 8, 16), params)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(m(xt, torch.from_numpy(ctx)).detach().numpy(), want, **TOL)
    # LayerNorm eps 1e-5 (a 1e-6 eps is visible at this input scale)
    np.testing.assert_allclose(m.norm1(xt).detach().numpy(),
                               _fixture("prim_transformer_ln_eps"), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("linear", [True, False])
def test_transformer2d(linear):
    rng = np.random.RandomState(10)
    x = rng.randn(2, 4, 4, 16).astype(np.float32)
    ctx = rng.randn(2, 7, 12).astype(np.float32)
    params, want = _jax(ja.Transformer2D(2, 8, 1, 12, use_linear_projection=linear,
                                         norm_num_groups=4), x, ctx)
    m = _port(ta.Transformer2D(2, 8, 16, 1, 12, linear, 4), params)
    got = nhwc(m(nchw(x), torch.from_numpy(ctx)))
    np.testing.assert_allclose(got, want, **TOL)


def test_vae_attention():
    x = np.random.RandomState(11).randn(2, 4, 4, 32).astype(np.float32)
    params, want = _jax(ja.VAEAttention(32, 8), x)
    got = nhwc(_port(ta.VAEAttention(32, 8), params)(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)

"""The GroupNorm(+SiLU) kernel's plain version and its autograd Function, which
the port runs on the CPU, against the JAX package: `group_norm_act` with the
Pallas kernel in interpret mode, `jax.grad` through its custom VJP, the
reference `_gn_silu_ref` in bf16, and the committed torch-oracle fixture
`prim_pallas_gn_silu.npz`; on contiguous and on channels-last input (the
layout the kernel and the models use). The kernel's plan (`gn_plan`) at the
sd2_base towers' GroupNorm shapes. The CUDA kernel itself is held against the
same plain version on the card (tests/test_torch_port_cuda.py, chip_smoke.py).

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

from difashion_tpu.nn.pallas.groupnorm import _gn_silu_ref, _pallas_gn_silu, group_norm_act
from difashion_tpu_torch.config import ModelConfig
from difashion_tpu_torch.models.difashion import DiFashion
from difashion_tpu_torch.nn import kernels
from difashion_tpu_torch.nn.kernels.groupnorm import (
    ONE_READ_MIN_ROW_BYTES,
    ONE_READ_TIERS,
    GroupNormSiLU,
    channels_last,
    gn_plan,
    group_norm_silu,
    group_norm_silu_grads,
    group_norm_silu_ref,
    is_channels_last,
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


def cl(x):
    """NHWC numpy -> the channels-last [B, C, H, W] view of the same memory."""
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("offset", [0.5, 100.0])
def test_written_out_backward_matches_autograd(dtype, act, offset):
    """`group_norm_silu_grads` (GroupNormSiLU's backward) against autograd
    through the plain version, on channels-last x: fp32 within 1e-5 of the
    largest gradient; in bf16 dx within one unit in its last place (both
    round the same fp32 value), dscale and dbias (fp32) within 1e-5. Also at
    |mean| >> std, where x * rstd - mean * rstd would cancel."""
    x, s, b = _inputs((2, 6, 5, 40), seed=8, offset=offset)
    ct = np.random.RandomState(9).randn(2, 6, 5, 40).astype(np.float32)
    leaves = [cl(x).to(dtype).requires_grad_(), torch.from_numpy(s).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    dy = cl(ct).to(dtype)
    group_norm_silu_ref(*leaves, 8, 1e-5, act).backward(dy)
    got = group_norm_silu_grads(*(t.detach() for t in leaves), dy, 8, 1e-5, act)
    assert is_channels_last(got[0])
    for g, t in zip(got, leaves):
        want = t.grad
        assert g.dtype == want.dtype and g.shape == want.shape
        diff = (g.float() - want.float()).abs()
        tol = 1e-5 * want.float().abs().max()
        if g.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * want.float().abs()
        assert (diff <= tol).all(), (diff.max(), tol.max() if tol.dim() else tol)


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


GN_PATHS = ("sampler_unet", 16), ("train_unet", 8), ("vae_decode", 4), ("vae_encode", 64)


def _sd2_sites(path, batch):
    """{(shape, groups)} of the GroupNorm calls of one sd2_base path, from a
    forward on the meta device (shapes only)."""
    cfg = ModelConfig.sd2_base()
    with torch.device("meta"):
        model = DiFashion(cfg)
    sites = set()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: sites.add((tuple(args[0].shape), mod.num_groups)))
        for m in model.modules() if isinstance(m, GroupNorm)]
    u, v = cfg.unet, cfg.vae
    meta = lambda *shape: torch.empty(*shape, device="meta")
    with torch.no_grad(), kernels.plain_versions():
        if path.endswith("unet"):
            model.unet(meta(batch, u.in_channels, u.sample_size, u.sample_size),
                       torch.zeros(batch, dtype=torch.long, device="meta"),
                       meta(batch, 77, u.cross_attention_dim))
        elif path == "vae_decode":
            model.vae.decode(meta(batch, v.latent_channels, u.sample_size, u.sample_size))
        else:
            model.vae.encode(meta(batch, v.in_channels, v.sample_size, v.sample_size))
    for h in hooks:
        h.remove()
    return sorted(sites)


def _covers(plan, shape, groups):
    """The plan's units tile x: every row of S in exactly one CTA or chunk."""
    s = int(np.prod(shape[2:]))
    assert (plan.n - 1) * plan.rows < s <= plan.n * plan.rows
    assert groups % plan.k == 0


@pytest.mark.parametrize("path,batch", GN_PATHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_at_the_sd2_base_sites(path, batch, dtype):
    """Every UNet GroupNorm is one read: a band of k groups whose channels
    make a multiple of 16 bytes (the smallest such k), in TMA boxes of at
    most 256 rows, in a cluster of at most 16 CTAs whose slices fit two to an
    SM. A VAE level is one read where its band rows hold at least
    ONE_READ_MIN_ROW_BYTES and its band fits 16 such slices (in bf16 the
    64x64 and 128x128 levels at 512 channels); two passes otherwise (the
    512x512 levels: 4 MB a band; the 256x256 ones)."""
    item = dtype.itemsize
    largest = max(b for _, b in ONE_READ_TIERS)
    for shape, groups in _sd2_sites(path, batch):
        plan = gn_plan(shape, groups, dtype)
        cg = shape[1] // groups
        _covers(plan, shape, groups)
        k = 16 // np.gcd(cg * item, 16)
        row_bytes = k * cg * item
        fits = row_bytes >= ONE_READ_MIN_ROW_BYTES and shape[2] * shape[3] * row_bytes <= 16 * largest
        assert plan.route == ("one_read" if fits else "two_pass"), (shape, plan)
        if path.endswith("unet") or (dtype == torch.bfloat16 and shape[1] == 512
                                     and shape[2] <= 128):
            assert plan.route == "one_read", (shape, plan)
        if shape[2] == 512:
            assert plan.route == "two_pass", (shape, plan)
        if plan.route == "two_pass":
            assert plan.vector and plan.k == groups         # whole rows, 16-byte vectors
            continue
        assert plan.k == k and row_bytes % 16 == 0 and plan.k * cg <= 256
        assert 1 <= plan.n <= 16 and plan.box_rows <= 256 and plan.box_rows % 8 == 0
        assert plan.rows % plan.box_rows == 0
        assert plan.slice_bytes(cg, item) <= largest


@pytest.mark.parametrize("shape,groups,dtype,aligned,want", [
    ((2, 33, 5, 7), 3, torch.bfloat16, True, ("two_pass", False)),   # 66-byte rows: no TMA
    ((2, 36, 5, 7), 3, torch.bfloat16, True, ("two_pass", False)),   # 72-byte rows: no TMA
    ((2, 64, 16, 16), 8, torch.bfloat16, False, ("two_pass", False)),  # x not 16-byte aligned
    ((2, 96, 7, 7), 32, torch.float16, True, ("one_read", True)),    # cg 3: k 8, S ragged
    ((2, 4, 1, 1), 2, torch.float32, True, ("two_pass", True)),      # 16-byte band rows
    ((2, 16, 1, 1), 2, torch.float32, True, ("one_read", True)),     # one element per channel
    ((1, 2048, 4, 4), 1, torch.bfloat16, True, ("two_pass", True)),  # a group beyond a band
])
def test_plan_routes(shape, groups, dtype, aligned, want):
    plan = gn_plan(shape, groups, dtype, aligned=aligned)
    assert (plan.route, plan.vector) == want
    _covers(plan, shape, groups)
    vec = 16 // dtype.itemsize if plan.vector else 1
    assert (plan.k * (shape[1] // groups)) % vec == 0


def test_plan_refuses_a_band_beyond_the_block():
    with pytest.raises(ValueError):
        gn_plan((1, 4097, 2, 2), 1, torch.bfloat16)   # 4097 scalar channels in one group


@pytest.mark.parametrize("cg,groups", [(4, 8), (10, 32), (30, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_plain_version_channels_last_matches_pallas_kernel(cg, groups, dtype, act):
    """The plain version on a channels-last view of [B, S, C] numbers against
    `_pallas_gn_silu` (interpret mode) and `_gn_silu_ref` on the same [B, S, C]
    array, and against itself on a contiguous copy. fp32 within 1e-5. bf16:
    without SiLU within one unit in the last place of either. With SiLU the
    orders differ (the Pallas kernel rounds once after an fp32 SiLU of the
    unrounded y, `_gn_silu_ref` rounds the sigmoid; the port rounds y, then
    SiLU): within one unit of SiLU on the Pallas kernel's rounded y, and
    within two of `_gn_silu_ref`'s own bf16 SiLU."""
    c = cg * groups
    x, s, b = _inputs((2, 5, 6, c), seed=7)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    x = np.asarray(xj.astype(jnp.float32))
    flat = xj.reshape(2, 30, c)
    act_name = act or "none"
    want_k = np.asarray(_pallas_gn_silu(flat, jnp.asarray(s), jnp.asarray(b), groups, 1e-6,
                                        act_name, interpret=True).astype(jnp.float32))
    want_r = np.asarray(_gn_silu_ref(flat, jnp.asarray(s), jnp.asarray(b), groups, 1e-6,
                                     act_name).astype(jnp.float32))
    xt = cl(x).to(getattr(torch, dtype))
    assert is_channels_last(xt) and not xt.is_contiguous()
    got_t = group_norm_silu_ref(xt, torch.from_numpy(s), torch.from_numpy(b), groups, 1e-6, act)
    assert is_channels_last(got_t) and got_t.dtype == xt.dtype
    again = group_norm_silu_ref(xt.contiguous(), torch.from_numpy(s), torch.from_numpy(b),
                                groups, 1e-6, act)
    assert torch.equal(got_t, again)
    got = got_t.float().permute(0, 2, 3, 1).reshape(2, 30, c).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want_k, **TOL)
        np.testing.assert_allclose(got, want_r, **TOL)
        return
    if act is not None:
        pre_k = _pallas_gn_silu(flat, jnp.asarray(s), jnp.asarray(b), groups, 1e-6, "none",
                                interpret=True)
        want_k = F.silu(torch.from_numpy(np.asarray(pre_k.astype(jnp.float32))).bfloat16())
        want_k = want_k.float().numpy()
    assert (np.abs(got - want_k) <= _ulp_bf16(want_k)).all()
    assert (np.abs(got - want_r) <= (1 if act is None else 2) * _ulp_bf16(want_r)).all()


def test_channels_last_helpers():
    x = torch.randn(2, 8, 3, 5)
    y = channels_last(x)
    assert is_channels_last(y) and torch.equal(x, y)
    assert y.stride() == x.contiguous(memory_format=torch.channels_last).stride()
    assert channels_last(y) is y and not is_channels_last(x)
    v = torch.randn(2, 6, 7)                      # [B, C, L]: channels innermost
    assert is_channels_last(channels_last(v)) and torch.equal(channels_last(v), v)


def test_kernel_source_and_registry():
    src = open(os.path.join(kernels.CSRC_DIR, "group_norm_silu.cu")).read()
    assert "groupnorm.py::_gn_silu_kernel" in src
    assert 'extern "C" int group_norm_silu' in src
    # the one-read route: clusters, DSMEM and TMA
    for needle in ("cudaLaunchAttributeClusterDimension", "ld_dsmem_f32", "tma_load_3d",
                   "tma_store_3d"):
        assert needle in src
    assert "group_norm_silu" in kernels.KERNELS and "group_norm_silu" in kernels.LAUNCHES

"""The fused GEGLU kernel's plain version and `nn.layers.GEGLU`'s route, on
the CPU: `geglu_matmul_ref` against the JAX package's GEGLU and FeedForward
at the tiny config's widths in fp32, and in bf16 against the four roundings
written out independently; the route at each of its conditions; the
wrapper's refusals; a tiny UNet forward through the fused path against the
unfused one. The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_port_cuda.py, scripts/geglu_matmul.py,
chip_smoke.py).

Tolerances: fp32 1e-5 (sums of at most 64 products in another order, erf in
another implementation). bf16 on inputs whose fp32 sums are exact: equal
bit for bit, save an element whose fp32 gelu and fp64 gelu fall on either
side of a bf16 rounding boundary (at most 1 in 10,000, one unit in the last
place)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from difashion_tpu.nn import layers as jlayers
from difashion_tpu_torch.config import ModelConfig
from difashion_tpu_torch.models.difashion import create_difashion
from difashion_tpu_torch.nn import kernels, layers
from difashion_tpu_torch.nn.kernels import geglu_matmul as gg
from difashion_tpu_torch.nn.layers import GEGLU, Dense, FeedForward

from test_torch_port_models import one_torch_thread  # noqa: F401  (autouse fixture)

TOL32 = dict(rtol=1e-5, atol=1e-5)
# the tiny UNet's transformer widths (C = 32, 64: F = 4C = 128, 256)
TINY_WIDTHS = sorted({c for c in ModelConfig.tiny().unet.block_out_channels})


def _np(t):
    return np.asarray(t, dtype=np.float32)


def _jax_params(module, dim, seed):
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, dim)))["params"]
    return jax.tree_util.tree_map(_np, params)


def _linear(p):
    """A flax Dense's kernel [K, N] and bias as nn.Linear's weight [N, K] and bias."""
    return torch.from_numpy(p["kernel"].T.copy()), torch.from_numpy(p["bias"].copy())


@pytest.mark.parametrize("dim", TINY_WIDTHS)
def test_plain_version_matches_jax_geglu(dim):
    """geglu_matmul_ref in fp32 against the JAX GEGLU (flax Dense, split,
    exact gelu, product) at the tiny UNet's widths; a CPU tensor takes it."""
    module = jlayers.GEGLU(4 * dim)
    params = _jax_params(module, dim, seed=dim)
    x = np.random.RandomState(dim).randn(2, 64, dim).astype(np.float32)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    w, b = _linear(params["proj"])
    x2 = torch.from_numpy(x).reshape(-1, dim)
    got = gg.geglu_matmul_ref(x2, w, b)
    assert got.dtype == torch.float32 and got.shape == (128, 4 * dim)
    assert torch.equal(gg.geglu_matmul(x2, w, b), got)
    np.testing.assert_allclose(got.numpy(), want.reshape(-1, 4 * dim), **TOL32)


@pytest.mark.parametrize("dim", TINY_WIDTHS)
def test_feedforward_through_the_fused_path_matches_jax(monkeypatch, dim):
    """The port's FeedForward with the route forced open on the CPU (where
    `geglu_matmul` computes the plain version) against the JAX FeedForward,
    and against its own unfused path."""
    module = jlayers.FeedForward(dim)
    params = _jax_params(module, dim, seed=10 + dim)
    x = np.random.RandomState(dim).randn(2, 64, dim).astype(np.float32)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    ff = FeedForward(dim).eval()
    with torch.no_grad():
        for lin, p in ((ff.net[0].proj, params["net_0"]["proj"]), (ff.net[2], params["net_2"])):
            w, b = _linear(p)
            lin.weight.copy_(w)
            lin.bias.copy_(b)
    calls = []
    fused = layers.geglu_matmul

    def recorded(*args):
        calls.append(args[0].shape)
        return fused(*args)

    tx = torch.from_numpy(x)
    with torch.no_grad():
        unfused = ff(tx)
        monkeypatch.setattr(layers, "geglu_route", gg.geglu_gate)
        monkeypatch.setattr(layers, "geglu_matmul", recorded)
        assert ff(tx).shape == (2, 64, dim) and not calls   # fp32: the gate stays closed
        monkeypatch.setattr(gg, "KERNEL_DTYPES", (torch.float32,))
        got = ff(tx)
    assert calls == [(128, dim)]
    np.testing.assert_allclose(got.numpy(), want, **TOL32)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), **TOL32)


def _exact_inputs(m, k, f, seed):
    """x, w and a bias on grids whose products and sums over K are exact in
    fp32 and fp64 alike (multiples of 2^-9 below 2^8), bf16-representable."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-8, 9, (m, k)) / 8.0
    w = rng.randint(-8, 9, (2 * f, k)) / 64.0
    b = rng.randint(-64, 65, (2 * f,)) / 32.0
    return x, w, b


def _bf16(a):
    """An fp64 array rounded to bf16 (round to nearest even), back in fp64."""
    return torch.from_numpy(np.asarray(a, np.float64)).to(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_version_rounds_as_written_out_in_bf16(with_bias):
    """The four roundings, written out here in fp64 numpy with math.erf
    (the sums are exact, so only the roundings can differ): the product
    rounded, then the bias sum rounded, the gelu rounded, the product of h
    and g rounded."""
    m, k, f = 512, 64, 128
    x, w, b = _exact_inputs(m, k, f, seed=3 if with_bias else 4)
    p = _bf16(x @ w.T)
    y = _bf16(p + b) if with_bias else p
    h, gate = y[:, :f], y[:, f:]
    erf = np.vectorize(math.erf)
    g = _bf16(gate * 0.5 * (1.0 + erf(gate * math.sqrt(0.5))))
    want = _bf16(h * g)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = gg.geglu_matmul_ref(tb(x), tb(w), tb(b) if with_bias else None)
    assert got.dtype == torch.bfloat16 and got.shape == (m, f)
    got = got.double().numpy()
    apart = got != want
    assert apart.sum() <= m * f // 10000, int(apart.sum())
    # one unit in the last place of the output at most (2^-7 of the value)
    assert (np.abs(got - want)[apart] <= 2.0 ** -7 * np.abs(want[apart])).all()
    # the roundings are where the difference is: without the first one the
    # bias sums move many elements
    unrounded = _bf16(x @ w.T + b) if with_bias else _bf16(x @ w.T)
    assert (unrounded != y).mean() > 0.01 or not with_bias


def test_gelu_erf_is_torch_gelu():
    """The written-out gelu is PyTorch's exact gelu in fp32, within the
    error of two fp32 erf implementations (the CPU's vectorised one in
    F.gelu, torch.erf's): a few units in the last place, and in absolute
    terms below x = -4, where 1 + erf cancels. Not the tanh form, which
    is 1e-4 away at x = -2."""
    v = torch.linspace(-8, 8, 10001)
    got, want = gg.gelu_erf(v).numpy(), F.gelu(v).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-6)
    tanh = F.gelu(v, approximate="tanh").numpy()
    assert np.abs(got - tanh).max() > 1e-4


def test_route_conditions_on_cpu_tensors():
    """`geglu_gate` at each condition, on CPU tensors; `geglu_route` adds
    the device, so the CPU never routes."""
    x = torch.zeros(2, 64, 320, dtype=torch.bfloat16)
    w = torch.zeros(2560, 320, dtype=torch.bfloat16)
    b = torch.zeros(2560, dtype=torch.bfloat16)
    assert gg.geglu_gate(x, w, b)                                     # bf16, no grad
    assert gg.geglu_gate(x.half(), w.half(), b.half())               # fp16
    assert not gg.geglu_route(x, w, b)                                # the CPU
    assert not gg.geglu_gate(x.float(), w.float(), b.float())        # fp32
    assert not gg.geglu_gate(x, w.float(), b)                         # mixed dtypes
    assert not gg.geglu_gate(x, w[:2432], b[:2432])                   # F = 1216: not 128k
    assert not gg.geglu_gate(x[..., :160], w, b)                      # K mismatch
    wr = w.clone().requires_grad_()
    assert not gg.geglu_gate(x, wr, b)                                # autograd records
    with torch.no_grad():
        assert gg.geglu_gate(x, wr, b)                                # ... not under no_grad
    with torch.inference_mode():
        assert gg.geglu_gate(x, wr, b)
    with torch.autocast("cpu", dtype=torch.bfloat16), torch.no_grad():
        assert gg.geglu_gate(x.float(), w.float(), b.float())        # autocast's dtype


def test_geglu_forward_takes_each_path(monkeypatch):
    """GEGLU.forward with the device check lifted (`geglu_route` = the gate):
    the fused kernel's wrapper for a bf16 no-grad product of an aligned x,
    its plain version inside `plain_versions()`, and the unfused path (the
    Dense projection) under autograd, in fp32 and for an x the kernel cannot
    read (K % 8 != 0)."""
    monkeypatch.setattr(layers, "geglu_route", gg.geglu_gate)
    seen = []
    monkeypatch.setattr(layers, "geglu_matmul",
                        lambda *a: seen.append("kernel") or gg.geglu_matmul_ref(*a))
    monkeypatch.setattr(layers, "geglu_matmul_ref",
                        lambda *a: seen.append("plain") or gg.geglu_matmul_ref(*a))
    monkeypatch.setattr(Dense, "forward",
                        lambda self, x: seen.append("dense") or F.linear(x, self.weight,
                                                                         self.bias))

    def path(module, x, grad=False):
        seen.clear()
        with torch.set_grad_enabled(grad):
            y = module(x)
        assert y.shape == x.shape[:-1] + (module.proj.out_features // 2,)
        return seen[:]

    torch.manual_seed(0)
    geglu = GEGLU(64, 128)
    x = torch.randn(2, 40, 64)
    assert path(geglu, x, grad=True) == ["dense"]                     # fp32, recording
    assert path(geglu, x) == ["dense"]                                # fp32
    geglu16 = GEGLU(64, 128).bfloat16()
    assert path(geglu16, x.bfloat16()) == ["kernel"]
    with kernels.plain_versions():
        assert path(geglu16, x.bfloat16()) == ["plain"]
    assert path(geglu16, x.bfloat16(), grad=True) == ["dense"]        # autograd records
    odd = GEGLU(36, 128).bfloat16()
    assert path(odd, torch.randn(2, 40, 36).bfloat16()) == ["dense"]  # K % 8: not aligned
    assert path(GEGLU(64, 96).bfloat16(), x.bfloat16()) == ["dense"]  # F = 96


def test_fused_path_matches_unfused_in_bf16(monkeypatch):
    """The fused path (its plain version, on the CPU) against the unfused
    one in bf16: they differ where the unfused path rounds once (F.linear
    adds the bias before rounding), by what one unit of the sums carries
    to the output (`rounding_gap_bound`)."""
    torch.manual_seed(1)
    geglu = GEGLU(64, 256).bfloat16()
    with torch.no_grad():
        geglu.proj.bias.normal_()
    x = torch.randn(4, 64, 64).bfloat16()
    with torch.no_grad():
        unfused = geglu(x)
        monkeypatch.setattr(layers, "geglu_route", gg.geglu_gate)
        fused = geglu(x)
    assert fused.dtype == unfused.dtype == torch.bfloat16
    gap = (fused.float() - unfused.float()).abs().reshape(-1, 256)
    w, b = geglu.proj.weight, geglu.proj.bias
    assert (gap <= gg.rounding_gap_bound(x.reshape(-1, 64), w, b)).all()
    assert gap.mean() <= 2.0 ** -7 * unfused.float().abs().mean()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The CUDA wrapper's checks: the device, then (`check_operands`, run on
    CPU tensors) the dtypes, shapes and layout."""
    x = torch.zeros(512, 64, dtype=torch.bfloat16)
    w = torch.zeros(256, 64, dtype=torch.bfloat16)
    b = torch.zeros(256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        gg._check(x, w, b)
    check = gg.check_operands
    check(x, w, b)                                                    # what it takes
    check(x, w, None)                                                 # without a bias
    check(x.half(), w.half(), b.half())                               # fp16
    with pytest.raises(TypeError):
        check(x.float(), w.float(), b.float())                        # fp32
    with pytest.raises(TypeError):
        check(x, w, b.float())                                        # bias dtype
    with pytest.raises(ValueError, match="multiple of 128"):
        check(x, w[:192], b[:192])                                    # F = 96
    with pytest.raises(ValueError):
        check(x, w[:, :32], b)                                        # K mismatch
    with pytest.raises(ValueError):
        check(x, w, b[:128])                                          # bias length
    with pytest.raises(ValueError, match="K % 8"):
        check(x[:, :60], w[:, :60].contiguous(), b)                   # K % 8
    with pytest.raises(ValueError, match="K % 8"):
        check(x.t().contiguous().t(), w, b)                           # not unit stride along K
    with pytest.raises(ValueError, match="contiguous"):
        check(x, w.t().contiguous().t(), b)                           # w not contiguous
    with pytest.raises(ValueError, match="empty"):
        check(x[:0], w, b)


def test_kernel_is_built_and_counted_apart():
    """The fused kernel has a source of its own, built with the others, and
    a counter of its own: nothing of it counts as the skinny-N kernel's."""
    assert gg.NAME in kernels.KERNELS and gg.NAME in kernels.LAUNCHES
    assert "skinny" not in gg.NAME
    src = (kernels.CSRC_DIR / f"{gg.NAME}.cu").read_text()
    assert "geglu_matmul_kernel" in src and "skinny_matmul_kernel" not in src
    for k, f in ((320, 1280), (640, 2560), (1280, 5120), (32, 128), (64, 256)):
        bn = gg.tile_width(k)
        assert bn in gg.TILE_WIDTHS and gg.TILE_F % bn == 0 and f % bn == 0
    assert [gg.tile_width(k) for k in (320, 640, 1280)] == [64, 64, 128]


def test_tiny_unet_through_the_fused_path_matches_unfused(monkeypatch):
    """A tiny UNet forward in fp32 with every GEGLU on the fused path (the
    route forced open, fp32 let through, the plain version on the CPU)
    against the same forward on the unfused path."""
    cfg = ModelConfig.tiny()
    model = create_difashion(cfg, seed=0, device="cpu")
    u = cfg.unet
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, u.in_channels, u.sample_size, u.sample_size, generator=g)
    t = torch.tensor([3, 700])
    ctx = torch.randn(2, 77, u.cross_attention_dim, generator=g)
    n = sum(isinstance(m, GEGLU) for m in model.unet.modules())
    calls = []
    fused = layers.geglu_matmul
    with torch.no_grad():
        want = model.unet(x, t, ctx)
        monkeypatch.setattr(layers, "geglu_route", gg.geglu_gate)
        monkeypatch.setattr(gg, "KERNEL_DTYPES", (torch.float32,))
        monkeypatch.setattr(layers, "geglu_matmul", lambda *a: calls.append(1) or fused(*a))
        got = model.unet(x, t, ctx)
    assert n > 0 and len(calls) == n
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)

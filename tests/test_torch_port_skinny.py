"""The skinny-N matmul kernel's plain version, its autograd Function and the
Dense layers' gate, which the port runs on the CPU, against the JAX package's
`tools/pallas_skinny_matmul.py`: `matmul_2d` with the Pallas kernel in
interpret mode, `jax.grad` through its `_matmul` custom VJP, and
`pallas_dense_dot`'s gate over every Dense product of the sd2_base towers, in
bf16 and fp32; and the fp32 kernel's plain 3xTF32 version
(`skinny_matmul_3xtf32_ref`, its custom VJP) against the same and an fp64
product. The CUDA kernels themselves are held against these plain versions
on the card (tests/test_torch_port_cuda.py, chip_smoke.py,
scripts/skinny_matmul_f32.py).

Tolerances: fp32 1e-5 (sums of at most 320 products in another order). bf16:
both sides sum in fp32 and round once, so they differ by at most one unit in
the last place where the two sums straddle a rounding boundary (2^-7 of the
value); with a bias, added to the rounded product and rounded again, by that
unit of the product plus one of the result."""
import contextlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from difashion_tpu_torch.config import ModelConfig
from difashion_tpu_torch.models.difashion import DiFashion
from difashion_tpu_torch.nn import kernels, layers
from difashion_tpu_torch.nn.kernels import skinny_matmul as sm
from difashion_tpu_torch.nn.kernels.tf32 import tf32_split
from difashion_tpu_torch.nn.layers import Dense

from test_torch_port_models import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL32 = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = dict(rtol=2.0 ** -7, atol=1e-6)


def _load_jax_module():
    """tools/ is no package: load the Pallas module by its path."""
    spec = importlib.util.spec_from_file_location(
        "pallas_skinny_matmul", os.path.join(REPO, "tools", "pallas_skinny_matmul.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jmm():
    return _load_jax_module()


def _xw(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)   # JAX layout [K, N]
    return x, w


SHAPES = [(512, 64, 32), (1000, 96, 64), (2048, 320, 320), (2560, 128, 160)]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_kernel(jmm, m, k, n, dtype):
    x, w = _xw(m, k, n)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jmm.matmul_2d(jnp.asarray(x, jd), jnp.asarray(w, jd), interpret=True)
                      .astype(jnp.float32))
    tx, tw = torch.from_numpy(x).to(td), torch.from_numpy(w.T.copy()).to(td)
    got = sm.skinny_matmul_ref(tx, tw)
    assert got.dtype == td and got.shape == (m, n)
    # a CPU tensor takes the plain version
    assert torch.equal(sm.skinny_matmul(tx, tw), got)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(TOL32 if dtype == "float32" else TOL_BF16))


def _bias(n, seed=3):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _close_after_bias(got, want, prod, dtype):
    """fp32: 1e-5. bf16: both round the fp32 sum once (one unit in the last
    place of the product apart at most, where the two sums straddle a
    rounding boundary) and round the sum with the bias once more (a unit of
    the result's)."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL32)
    else:
        assert (np.abs(got - want) <= 2.0 ** -7 * (np.abs(prod) + np.abs(want)) + 1e-6).all()


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_kn", [False, True])
def test_plain_version_with_bias_matches_jax_kernel(jmm, m, k, n, dtype, w_kn):
    """The plain version with a bias, the weight as [N, K] or as [K, N]
    (`w_kn`, the backward's dx layout), against the Pallas kernel in
    interpret mode plus the bias added as flax's Dense adds it: to the
    product in the compute dtype."""
    x, w = _xw(m, k, n, seed=4)
    b = _bias(n)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    prod = jmm.matmul_2d(jnp.asarray(x, jd), jnp.asarray(w, jd), interpret=True)
    want = np.asarray((prod + jnp.asarray(b, jd)).astype(jnp.float32))
    tx, tb = torch.from_numpy(x).to(td), torch.from_numpy(b).to(td)
    tw = torch.from_numpy(w if w_kn else w.T.copy()).to(td)
    got = sm.skinny_matmul_ref(tx, tw, tb, w_kn=w_kn)
    assert got.dtype == td and got.shape == (m, n)
    assert torch.equal(sm.skinny_matmul(tx, tw, tb, w_kn=w_kn), got)
    _close_after_bias(got.float().numpy(), want, np.asarray(prod.astype(jnp.float32)), dtype)
    # without a bias, the [K, N] layout is the same product
    np.testing.assert_array_equal(
        sm.skinny_matmul_ref(tx, tw, w_kn=w_kn).float().numpy(),
        sm.skinny_matmul_ref(tx, tw.t().contiguous(), w_kn=not w_kn).float().numpy())


@pytest.mark.parametrize("m,k,n", [(512, 64, 32), (1000, 96, 64)])
@pytest.mark.parametrize("plain", [True, False])
def test_gradients_with_bias_match_jax_custom_vjp(jmm, m, k, n, plain):
    """`SkinnyMatmul` with a bias against `jax.grad` through the `_matmul`
    custom VJP plus the bias add: dx, dw and db, fp32."""
    x, w = _xw(m, k, n, seed=5)
    b = _bias(n, seed=6)
    g = np.random.RandomState(7).randn(m, n).astype(np.float32)
    loss = lambda x, w, b: jnp.sum((jmm.matmul_2d(x, w, interpret=True) + b) * g)
    jdx, jdw, jdb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                                       jnp.asarray(b))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = sm.SkinnyMatmul.apply(tx, tw, plain, tb)
    np.testing.assert_allclose(out.detach().numpy(), x @ w + b, **TOL32)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL32)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw).T, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), rtol=1e-5, atol=1e-4)
    # the bias alone (a frozen x and weight)
    tb.grad = None
    sm.SkinnyMatmul.apply(tx.detach(), tw.detach(), plain, tb).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), rtol=1e-5, atol=1e-4)


def test_bias_in_the_function_matches_autograd_through_the_add():
    """In bf16 the bias inside `SkinnyMatmul` gives bit for bit what the
    product followed by `y + bias` gave under autograd: the same output, dx,
    dw, and db = g summed over rows in g's dtype."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2048, 96).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(64, 96).astype(np.float32) / 10).bfloat16()
    b = torch.from_numpy(rng.randn(64).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.randn(2048, 64).astype(np.float32)).bfloat16()

    def run(inside):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        if inside:
            y = sm.SkinnyMatmul.apply(leaves[0], leaves[1], True, leaves[2])
        else:
            y = sm.SkinnyMatmul.apply(leaves[0], leaves[1], True) + leaves[2]
        y.backward(g)
        return [y.detach()] + [t.grad for t in leaves]

    for got, want in zip(run(True), run(False)):
        assert got.dtype == want.dtype == torch.bfloat16 and torch.equal(got, want)


def test_fp32_kernel_is_built_and_counted():
    """The fp32 kernel has a source of its own, built with the others, and a
    launch counter of its own beside the 16-bit kernel's."""
    assert sm.NAME_F32 in kernels.KERNELS and sm.NAME_F32 in kernels.LAUNCHES
    assert sm.NAME in kernels.KERNELS and sm.NAME in kernels.LAUNCHES
    assert os.path.exists(os.path.join(kernels.CSRC_DIR, f"{sm.NAME_F32}.cu"))


def test_tile_widths():
    """The tile width is one the kernel is built for, at every N the gate
    passes, in both layouts; the routed N take the measured table."""
    for n in range(8, sm.MAX_N + 1, 8):
        for w_kn in (False, True):
            assert sm.tile_n(n, w_kn) in sm.TILE_WIDTHS
    assert [sm.tile_n(n) for n in (320, 640, 1280, 512)] == [160, 160, 160, 128]
    assert [sm.tile_n(n, True) for n in (320, 640, 1280, 2560)] == [128, 160, 160, 128]


@pytest.mark.parametrize("m,k,n", [(512, 64, 32), (1000, 96, 64)])
def test_gradients_match_jax_custom_vjp(jmm, m, k, n):
    x, w = _xw(m, k, n, seed=1)
    g = np.random.RandomState(2).randn(m, n).astype(np.float32)   # not all ones
    loss = lambda x, w: jnp.sum(jmm.matmul_2d(x, w, interpret=True) * g)
    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    out = sm.SkinnyMatmul.apply(tx, tw, True)
    np.testing.assert_allclose(out.detach().numpy(), x @ w, **TOL32)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL32)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw).T, rtol=1e-5, atol=1e-4)
    # dx alone (a frozen weight)
    tx.grad = None
    sm.SkinnyMatmul.apply(tx, tw.detach(), False).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL32)


def _dense_products(cfg, batch):
    """{(rows, K, N)} of every Dense call of the sd2_base towers at `batch`
    rows: a UNet forward, a VAE decode and encode, the text tower and the
    MutualEncoder, run on the meta device (shapes only)."""
    with torch.device("meta"):
        model = DiFashion(cfg)
    seen = set()

    def record(mod, args):
        x = args[0]
        seen.add((int(np.prod(x.shape[:-1])), mod.in_features, mod.out_features))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, Dense)]
    u, v = cfg.unet, cfg.vae
    meta = lambda *shape: torch.empty(*shape, device="meta")
    s = u.sample_size
    with torch.no_grad(), kernels.plain_versions():
        model.unet(meta(batch, u.in_channels, s, s),
                   torch.zeros(batch, dtype=torch.long, device="meta"),
                   meta(batch, 77, u.cross_attention_dim))
        model.vae.decode(meta(batch, v.latent_channels, s, s))
        model.vae.encode(meta(batch, v.in_channels, v.sample_size, v.sample_size))
        model.text_encoder(torch.zeros(batch, 77, dtype=torch.long, device="meta"))
        model.fashion_encoder(meta(batch, v.latent_channels, s, s))
    for h in hooks:
        h.remove()
    return seen


def _gate_against_jax(jmm, monkeypatch, dtype):
    """The routed products of the sd2_base towers at the batches the paths
    use, by `gate` in `dtype` and by `pallas_dense_dot` itself (traced
    abstractly, on a TPU as far as the gate can tell): asserts they are the
    same set, and returns it."""
    monkeypatch.setattr(jmm, "_on_tpu", lambda: True)
    calls = []

    def record(x, w, **_):
        calls.append(x.shape)
        return jnp.zeros((x.shape[0], w.shape[1]), x.dtype)

    monkeypatch.setattr(jmm, "matmul_2d", record)

    def jax_routes(rows, k, n):
        calls.clear()
        jax.eval_shape(lambda a, b: jmm.pallas_dense_dot(a, b, (((1,), (0,)), ((), ()))),
                       jax.ShapeDtypeStruct((rows, k), getattr(jnp, dtype)),
                       jax.ShapeDtypeStruct((k, n), getattr(jnp, dtype)))
        return bool(calls)

    cfg = ModelConfig.sd2_base()
    products = set()
    for batch in (1, 4, 8, 16, 64):
        products |= _dense_products(cfg, batch)
    td = getattr(torch, dtype)
    routed = {(m, k, n) for m, k, n in products if sm.gate(m, n, k, td, td)}
    assert routed == {p for p in products if jax_routes(*p)}
    return routed


def test_dense_route_matches_jax_gate(jmm, monkeypatch):
    """`gate` against `pallas_dense_dot` itself at every Dense product of the
    sd2_base towers at the batches the paths use, in bf16."""
    routed = _gate_against_jax(jmm, monkeypatch, "bfloat16")
    # what the gate takes: the 64x64 and 32x32 levels, the 16x16 level from 8
    # rows, the mid level at 64, net_2 up to C = 640, the VAE mid attention
    assert (16 * 4096, 320, 320) in routed and (16 * 1024, 2560, 640) in routed
    assert (8 * 256, 1280, 1280) in routed and (64 * 64, 1280, 1280) in routed
    assert (16 * 64, 1280, 1280) not in routed            # M = 1024
    assert (16 * 4096, 1280, 320) in routed               # net_2 at C = 320
    assert (16 * 256, 5120, 1280) not in routed           # net_2 at C = 1280: 13 MB
    assert (16 * 4096, 320, 2560) not in routed           # GEGLU: N = 8C
    assert (16 * 77, 1024, 320) not in routed             # cross-attention k/v
    assert (4 * 4096, 512, 512) in routed                 # VAE mid attention


def test_dense_route_matches_jax_gate_in_fp32(jmm, monkeypatch):
    """The same in fp32 (an fp32 model's products): the 8 MiB rule counts the
    weight in fp32 bytes and still takes the products it takes in bf16
    (net_2 at C = 640 is 6.5 MB), and leaves out the same ones."""
    routed = _gate_against_jax(jmm, monkeypatch, "float32")
    assert routed == _gate_against_jax(jmm, monkeypatch, "bfloat16")
    assert (16 * 1024, 2560, 640) in routed and (4 * 4096, 512, 512) in routed
    assert (16 * 256, 5120, 1280) not in routed           # 26 MB in fp32


def test_dense_route_stays_off_the_cpu_and_fp32():
    """The route stays off the CPU (F.linear there, in every dtype) and off a
    product of mixed dtypes (JAX's rule: x and the weight of one dtype); an
    fp32 product is gated like a bf16 one, for the fp32 kernel, on CUDA."""
    x = torch.zeros(4096, 320)
    w = torch.zeros(320, 320)
    assert not sm.dense_route(x, w)                       # the CPU: F.linear
    assert not sm.dense_route(x.bfloat16(), w.bfloat16())
    assert sm.gate(4096, 320, 320, torch.bfloat16, torch.bfloat16)
    assert sm.gate(4096, 320, 320, torch.float32, torch.float32)      # the fp32 kernel
    assert not sm.gate(4096, 320, 320, torch.bfloat16, torch.float32)  # JAX's dtype rule
    assert not sm.gate(4096, 320, 320, torch.float64, torch.float64)   # no kernel's dtype
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert sm.compute_dtypes(x, w) == (torch.bfloat16, torch.bfloat16)
    assert sm.compute_dtypes(x.bfloat16(), w) == (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("autocast", [False, True])
def test_dense_kernel_route_matches_linear(monkeypatch, bias, autocast):
    """Dense's route with the gate forced open on the CPU (where the kernel's
    wrapper computes the plain version): the cast, the reshape, the bias and
    the gradients, against F.linear."""
    torch.manual_seed(0)
    dense = Dense(96, 64, bias=bias)
    if bias:
        torch.nn.init.normal_(dense.bias)
    x = torch.randn(2, 300, 96, requires_grad=True)
    g = torch.randn(2, 300, 64)

    def run(route):
        monkeypatch.setattr(layers, "dense_route", lambda *_: route)
        x.grad = dense.weight.grad = None
        if bias:
            dense.bias.grad = None
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
            y = dense(x)
        y.backward(g.to(y.dtype))
        grads = [t.grad.clone() for t in (x, dense.weight, dense.bias) if t is not None]
        return y.detach(), grads

    got, got_grads = run(True)
    want, want_grads = run(False)
    assert got.dtype == want.dtype == (torch.bfloat16 if autocast else torch.float32)
    assert got.shape == (2, 300, 64)
    got, want = got.float().numpy(), want.float().numpy()
    if autocast:
        # F.linear adds the bias before its one rounding to bf16, the route
        # after it (as flax's Dense does): half a unit of the product's
        # magnitude more, and a unit of the result's
        prod = np.abs(x.detach().bfloat16().float().numpy()
                      @ dense.weight.detach().bfloat16().float().numpy().T)
        assert (np.abs(got - want) <= 2.0 ** -8 * prod + 2.0 ** -7 * np.abs(want) + 1e-6).all()
    else:
        np.testing.assert_allclose(got, want, **TOL32)
    for a, b in zip(got_grads, want_grads):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2 if autocast else 1e-5,
                                   atol=2e-2 if autocast else 1e-4)


@pytest.mark.parametrize("autocast", [False, True])
def test_dense_plain_versions_match_the_kernel_route(monkeypatch, autocast):
    """With the gate forced open, Dense under `kernels.plain_versions()`
    (the plain version inside `SkinnyMatmul`) gives what its kernel route
    gives on the CPU, where the wrapper computes the plain version: the same
    output and gradients, bias included."""
    torch.manual_seed(1)
    dense = Dense(96, 64)
    torch.nn.init.normal_(dense.bias)
    x = torch.randn(2, 1024, 96, requires_grad=True)
    g = torch.randn(2, 1024, 64)
    monkeypatch.setattr(layers, "dense_route", lambda *_: True)

    def run(plain):
        x.grad = dense.weight.grad = dense.bias.grad = None
        with kernels.plain_versions() if plain else contextlib.nullcontext():
            with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
                y = dense(x)
            y.backward(g.to(y.dtype))
        return [y.detach()] + [t.grad.clone() for t in (x, dense.weight, dense.bias)]

    for got, want in zip(run(False), run(True)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_every_linear_is_dense():
    with torch.device("meta"):
        model = DiFashion(ModelConfig.tiny())
    linears = [m for m in model.modules() if isinstance(m, torch.nn.Linear)]
    assert linears and all(type(m) is Dense for m in linears)
    # the keys stay nn.Linear's
    assert set(dict(linears[0].named_parameters())) <= {"weight", "bias"}


# ---- what the kernels can read: the Dense route's alignment rule ----------------------

def _offset_base(m, k, dtype):
    """[m, k] whose base is one element past an aligned allocation."""
    return torch.zeros(m * k + 1, dtype=dtype)[1:].view(m, k)


@pytest.mark.parametrize("make,dtype,want", [
    (lambda d: torch.zeros(2048, 64, dtype=d), torch.bfloat16, True),
    (lambda d: torch.zeros(2048, 64, dtype=d), torch.float32, True),
    (lambda d: torch.zeros(2048, 30, dtype=d), torch.bfloat16, False),     # K = 30
    (lambda d: torch.zeros(2048, 30, dtype=d), torch.float32, False),
    (lambda d: torch.zeros(2048, 100, dtype=d), torch.bfloat16, False),    # K % 8
    (lambda d: torch.zeros(2048, 100, dtype=d), torch.float32, True),      # K % 4 == 0
    (lambda d: torch.zeros(2048, 65, dtype=d)[:, :64], torch.bfloat16, False),  # row stride
    (lambda d: torch.zeros(2048, 65, dtype=d)[:, :64], torch.float32, False),
    (lambda d: torch.zeros(2048, 72, dtype=d)[:, :64], torch.bfloat16, True),   # stride 72
    (lambda d: _offset_base(2048, 64, d), torch.bfloat16, False),         # offset base
    (lambda d: _offset_base(2048, 64, d), torch.float32, False),
    (lambda d: torch.zeros(64, 2048, dtype=d).t(), torch.float32, False),  # K not unit stride
])
def test_aligned_is_the_kernels_rule_on_x(make, dtype, want):
    """`aligned` gives what the wrapper's `_check` takes of x: on the card a
    product it refuses raises there, and the Dense route sends it to
    F.linear instead."""
    assert sm.aligned(make(dtype)) is want


def test_dense_sends_what_the_kernel_cannot_read_to_linear(monkeypatch):
    """With the gate forced open on the CPU: Dense(30, 100) (K = 30) and a
    strided x whose row stride is off take F.linear, never the kernel's
    wrapper; bf16 Dense(64, 100) takes the kernel forward and a plain dx
    (N = 100 is no multiple of 8), fp32 Dense(64, 100) the kernel for both.
    Each against F.linear and its autograd."""
    calls = []
    wrapper = sm.skinny_matmul

    def counted(x, w, bias=None, *, w_kn=False):
        calls.append("dx" if w_kn else "fwd")
        return wrapper(x, w, bias, w_kn=w_kn)

    monkeypatch.setattr(sm, "skinny_matmul", counted)
    monkeypatch.setattr(layers, "skinny_matmul", counted)
    monkeypatch.setattr(layers, "dense_route", lambda *_: True)
    torch.manual_seed(3)

    def run(k, n, autocast, strided=False):
        calls.clear()
        dense = Dense(k, n)
        base = torch.randn(2, 1024, k + (1 if strided else 0))
        x = (base[..., :k] if strided else base).requires_grad_()
        g = torch.randn(2, 1024, n)
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
            y = dense(x)
        y.backward(g.to(y.dtype))
        got = [y.detach().float(), x.grad.clone(), dense.weight.grad.clone()]
        x.grad = dense.weight.grad = dense.bias.grad = None
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
            y = F.linear(x, dense.weight, dense.bias)
        y.backward(g.to(y.dtype))
        want = [y.detach().float(), x.grad.clone(), dense.weight.grad.clone()]
        tol = dict(rtol=3e-2, atol=3e-2) if autocast else TOL32
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
        return list(calls)

    assert run(30, 100, True) == [] and run(30, 100, False) == []
    assert run(64, 64, False, strided=True) == []
    assert run(64, 100, True) == ["fwd"]              # dx through torch.matmul
    assert run(64, 100, False) == ["fwd", "dx"]


def _gated_inputs(cfg, dtype):
    """(gated, aligned) counts over every Dense input of the towers' forwards
    at the batches the paths run (meta device: shapes, strides, offsets),
    each input cast and reshaped as `Dense.forward` does."""
    with torch.device("meta"):
        model = DiFashion(cfg)
    seen = {"gated": 0, "aligned": 0}

    def record(mod, args):
        x2 = args[0].to(dtype).reshape(-1, args[0].shape[-1])
        if sm.gate(x2.shape[0], mod.out_features, mod.in_features, dtype, dtype):
            seen["gated"] += 1
            seen["aligned"] += sm.aligned(x2)

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, Dense)]
    u, v = cfg.unet, cfg.vae
    meta = lambda *shape: torch.empty(*shape, device="meta")
    with torch.no_grad(), kernels.plain_versions():
        for b in (4, 8, 16, 64):
            model.unet(meta(b, u.in_channels, u.sample_size, u.sample_size),
                       torch.zeros(b, dtype=torch.long, device="meta"),
                       meta(b, 77, u.cross_attention_dim))
            model.vae.decode(meta(b, v.latent_channels, u.sample_size, u.sample_size))
        model.vae.encode(meta(64, v.in_channels, v.sample_size, v.sample_size))
    for h in hooks:
        h.remove()
    return seen


@pytest.mark.parametrize("preset", ["tiny", "sd2_base", "sd15"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_preset_dense_keeps_its_route(preset, dtype):
    """Every product of the presets that the gate takes is one the kernels
    can read as the Dense passes it: the alignment rule moves no product of
    tiny, sd2_base or sd15 off the kernel (the launch counts stay)."""
    seen = _gated_inputs(getattr(ModelConfig, preset)(), dtype)
    assert seen["aligned"] == seen["gated"]
    if preset != "tiny":
        assert seen["gated"] > 0


# ---- the fp32 kernel's plain 3xTF32 version ----------------------------------------

@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("w_kn", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_3xtf32_plain_version_matches_jax_kernel(jmm, m, k, n, w_kn, bias):
    """`skinny_matmul_3xtf32_ref` on fp32 inputs, with and without a bias,
    the weight as [N, K] or [K, N], against the Pallas kernel in interpret
    mode (plus flax's bias add): 1e-5."""
    x, w = _xw(m, k, n, seed=9)
    b = _bias(n, seed=10)
    prod = jmm.matmul_2d(jnp.asarray(x), jnp.asarray(w), interpret=True)
    want = np.asarray(prod + jnp.asarray(b) if bias else prod)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b) if bias else None
    tw = torch.from_numpy(w if w_kn else w.T.copy())
    got = sm.skinny_matmul_3xtf32_ref(tx, tw, tb, w_kn=w_kn)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL32)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("w_kn", [False, True])
def test_3xtf32_plain_version_matches_fp64(m, k, n, w_kn):
    """Against an fp64 product of the same inputs: within 1e-5, and far
    closer than one TF32 pass (hi * hi alone, 2^-11 of an operand): the lo
    terms are there, and only lo * lo (2^-22) is dropped."""
    x, w = _xw(m, k, n, seed=11)
    b = _bias(n, seed=12)
    want = x.astype(np.float64) @ w.astype(np.float64) + b
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    tw = torch.from_numpy(w if w_kn else w.T.copy())
    got = sm.skinny_matmul_3xtf32_ref(tx, tw, tb, w_kn=w_kn).double().numpy()
    np.testing.assert_allclose(got, want, **TOL32)
    (xh, _), (wh, _) = tf32_split(tx), tf32_split(torch.from_numpy(w))
    one_pass = (xh.double() @ wh.double()).numpy() + b
    assert np.abs(got - want).max() < np.abs(one_pass - want).max() / 50


def test_3xtf32_plain_version_takes_fp32_only():
    x, w = torch.zeros(4, 8), torch.zeros(2, 8)
    for args in ((x.bfloat16(), w), (x, w.double()), (x, w, torch.zeros(2).half())):
        with pytest.raises(TypeError):
            sm.skinny_matmul_3xtf32_ref(*args)


@pytest.mark.parametrize("m,k,n", [(512, 64, 32), (1000, 96, 64), (2048, 320, 320)])
def test_3xtf32_custom_vjp_matches_jax(jmm, monkeypatch, m, k, n):
    """`SkinnyMatmul` computing what the fp32 kernel computes (its wrapper
    replaced by `skinny_matmul_3xtf32_ref`, as on the card: the forward and
    dx = g . w on the stored weight read as [K, N]; dw and db plain) against
    `jax.grad` through the `_matmul` custom VJP plus the bias add: dx, dw
    and db, fp32."""
    x, w = _xw(m, k, n, seed=13)
    b = _bias(n, seed=14)
    g = np.random.RandomState(15).randn(m, n).astype(np.float32)
    loss = lambda x, w, b: jnp.sum((jmm.matmul_2d(x, w, interpret=True) + b) * g)
    jdx, jdw, jdb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                                       jnp.asarray(b))
    calls = []

    def kernel(*args, **kw):
        calls.append(kw.get("w_kn", False))
        return sm.skinny_matmul_3xtf32_ref(*args, **kw)

    monkeypatch.setattr(sm, "skinny_matmul", kernel)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = sm.SkinnyMatmul.apply(tx, tw, False, tb)
    np.testing.assert_allclose(out.detach().numpy(), x @ w + b, **TOL32)
    out.backward(torch.from_numpy(g))
    assert calls == [False, True]                          # the forward, then dx as [K, N]
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL32)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw).T, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), rtol=1e-5, atol=1e-4)

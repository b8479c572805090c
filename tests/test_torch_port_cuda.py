"""The CUDA kernels (flash-attention forward, dQ, dK/dV in 16 bits and in fp32;
GroupNorm + SiLU; the skinny-N matmul) against their plain versions, on the
card, with TF32 off.

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
    attention_delta,
    flash_attention,
    flash_attention_dkv,
    flash_attention_dkv_ref,
    flash_attention_dq,
    flash_attention_dq_ref,
    flash_attention_ref,
)
from difashion_tpu_torch.nn.kernels.groupnorm import group_norm_silu, group_norm_silu_ref
from difashion_tpu_torch.nn.kernels.skinny_matmul import (
    SkinnyMatmul,
    skinny_matmul,
    skinny_matmul_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    (1, 2, 200, 77, 40),     # sd15's head dims: every kernel pads them by TMA's
    (2, 1, 130, 300, 80),    # zero fill, no padded copy
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


def _proj(b, s, h, d, dtype, dev, seed):
    """The [B, H, S, D] view of a [B, S, H*D] projection, as the UNet's
    attention hands it over."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, s, h * d, generator=g, device=dev).to(dtype)
    return x.view(b, s, h, d).transpose(1, 2)


@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sq,skv", [(200, 77), (333, 130)])
def test_forward_head_dims_on_strided_views(dev, d, dtype, sq, skv):
    """Every head dim the forward takes (d % 8 == 0 read in place, the kernel
    padding to 64 or 128 with TMA's zero fill), ragged Sq and Skv, the
    projections' strided views: against the plain version, O laid out as
    [B, S, H, D], the scale that of the unpadded d."""
    b, h = 2, 3
    q, k, v = (_proj(b, s, h, d, dtype, dev, seed) for s, seed in ((sq, 1), (skv, 2), (skv, 3)))
    kernels.reset_launches()
    o, lse = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    ro, rlse = flash_attention_ref(q, k, v)
    err = (o.float() - ro.float()).abs()
    assert err.max().item() <= 3e-2 and err.mean().item() <= 3e-3
    np.testing.assert_allclose(lse.cpu().numpy(), rlse.cpu().numpy(), rtol=1e-4, atol=1e-4)
    assert o.dtype == dtype and o.shape == (b, h, sq, d) and o.transpose(1, 2).is_contiguous()


def test_forward_head_dim_not_a_multiple_of_8(dev):
    """d = 20 goes through the wrapper's zero-padded copy to 24."""
    q, k, v = _qkv(2, 3, 100, 77, 20, torch.bfloat16, dev, seed=6)
    o, lse = flash_attention(q, k, v)
    ro, rlse = flash_attention_ref(q, k, v)
    assert (o.float() - ro.float()).abs().max().item() <= 3e-2
    assert (lse - rlse).abs().max().item() <= 1e-4
    assert o.shape == q.shape and o.transpose(1, 2).is_contiguous()


def test_sdpa_routes(dev):
    q, k, v = _qkv(2, 2, 128, 77, 64, torch.bfloat16, dev)
    kernels.reset_launches()
    out = sdpa(q, k, v)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    with kernels.plain_versions():
        ref = sdpa(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    # d > 128 (the VAE mid-attention) takes the plain path
    wq, wk, wv = _qkv(1, 1, 64, 64, 512, torch.bfloat16, dev)
    sdpa(wq, wk, wv)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    # fp32 goes to the fp32 kernel, sd15's d = 80 to the forward kernel
    sdpa(q.float(), k.float(), v.float())
    assert kernels.LAUNCHES["flash_attention_fwd_f32"] == 1
    fq, fk, fv = _qkv(1, 1, 64, 64, 80, torch.bfloat16, dev)
    sdpa(fq, fk, fv)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 2
    assert kernels.LAUNCHES["flash_attention_fwd_f32"] == 1


def test_wrapper_rejects(dev):
    q, k, v = _qkv(1, 1, 64, 64, 64, torch.bfloat16, dev)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention(q, k.float(), v)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :, :32], v)
    wq, wk, wv = _qkv(1, 1, 64, 64, 136, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        flash_attention(wq, wk, wv)                       # head dim above 128
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), k, v)          # last dim not contiguous
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :, 4:60], k[:, :, :, 4:60], v[:, :, :, 4:60])  # 8-byte base


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_backward_kernels_match_plain(dev, b, h, sq, skv, d, dtype):
    q, k, v = _qkv(b, h, sq, skv, d, dtype, dev, seed=2)
    g = torch.Generator(device=dev).manual_seed(3)
    do = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)  # random cotangent
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    scale = d ** -0.5
    dq = flash_attention_dq(q, k, v, do, lse, delta, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    rdq = flash_attention_dq_ref(q, k, v, do, lse, delta, scale)
    rdk, rdv = flash_attention_dkv_ref(q, k, v, do, lse, delta, scale)
    # the plain versions round P and dS to the input dtype where the kernels
    # do; what is left is the order of the fp32 sums, ex2.approx, and the odd
    # 16-bit rounding of P or dS that falls the other way
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == dtype and got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= 1e-2


def test_backward_layout_and_launch_counts(dev):
    b, s, h, d = 2, 300, 5, 64
    g = torch.Generator(device=dev).manual_seed(4)
    proj = torch.randn(4, b, s, h * d, generator=g, device=dev).bfloat16()
    q, k, v, do = (t.view(b, s, h, d).transpose(1, 2) for t in proj)
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    kernels.reset_launches()
    dq = flash_attention_dq(q, k, v, do, lse, delta, d ** -0.5)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, d ** -0.5)
    assert kernels.LAUNCHES["flash_attention_dq"] == 1
    assert kernels.LAUNCHES["flash_attention_dkv"] == 1
    # gradients are laid out as [B, S, H, D]: the projections' backward reads
    # them without a copy
    for t in (dq, dk, dv):
        assert t.transpose(1, 2).is_contiguous()
    # a contiguous dO gives the same result as the strided one; and the same
    # result again (no atomics)
    dq2 = flash_attention_dq(q, k, v, do.contiguous(), lse, delta, d ** -0.5)
    dk2, dv2 = flash_attention_dkv(q, k, v, do.contiguous(), lse, delta, d ** -0.5)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)



@pytest.mark.parametrize("sq", [77, 100, 300])
@pytest.mark.parametrize("skv", [77, 100, 300])
@pytest.mark.parametrize("d", [64, 40, 80])
def test_backward_kernels_ragged_lengths(dev, sq, skv, d):
    """Ragged query and key lengths on both sides of the tiles: zero-filled Q
    and dO rows past Sq (P = 1 there, harmless only through the masking),
    zero-filled K columns past Skv (masked in dQ), an LSE and D row that
    does not meet TMA's 16-byte stride rule (Sq = 77, 100)."""
    b, h = 2, 3
    q, k, v = _qkv(b, h, sq, skv, d, torch.bfloat16, dev, seed=sq + skv + d)
    do = torch.randn(b, h, sq, d, generator=torch.Generator(device=dev).manual_seed(7),
                     device=dev).bfloat16()
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, d ** -0.5)
    got = (flash_attention_dq(*args),) + flash_attention_dkv(*args)
    torch.cuda.synchronize()
    want = (flash_attention_dq_ref(*args),) + flash_attention_dkv_ref(*args)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all()) and g.shape == w.shape
        assert _rel(g, w) <= 1e-2


@pytest.mark.parametrize("d", [40, 80])
def test_backward_reads_sd15_head_dims_in_place(dev, d, monkeypatch):
    """sd15's d = 40 and 80 reach the backward kernels as they are: no padded
    copy of q, k, v or dO, no [.., dp] output sliced back; the gradients
    match the plain versions."""
    from difashion_tpu_torch.nn.kernels import flash_attention as fa

    padded = []
    real_pad, real_empty = fa.pad_head_dim, fa._empty_bshd

    def pad(t, dp):
        padded.append((t.shape[-1], dp))
        return real_pad(t, dp)

    def empty(b, h, s, dd, like):
        padded.append((d, dd))
        return real_empty(b, h, s, dd, like)

    monkeypatch.setattr(fa, "pad_head_dim", pad)
    monkeypatch.setattr(fa, "_empty_bshd", empty)
    b, h, sq, skv = 2, 8, 256, 77
    proj = torch.randn(4, b, sq, h * d, generator=torch.Generator(device=dev).manual_seed(d),
                       device=dev).bfloat16()
    q, do = (t.view(b, sq, h, d).transpose(1, 2) for t in proj[::3])
    k, v = (t[:, :skv].view(b, skv, h, d).transpose(1, 2) for t in proj[1:3])
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, d ** -0.5)
    kernels.reset_launches()
    got = (flash_attention_dq(*args),) + flash_attention_dkv(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_dq"] == 1
    assert kernels.LAUNCHES["flash_attention_dkv"] == 1
    assert padded and all(have == dp for have, dp in padded)
    want = (flash_attention_dq_ref(*args),) + flash_attention_dkv_ref(*args)
    for g, w in zip(got, want):
        assert g.shape == (b, h, g.shape[2], d) and g.transpose(1, 2).is_contiguous()
        assert _rel(g, w) <= 1e-2


@pytest.mark.parametrize("b,h,sq,d", [(8, 5, 4096, 64), (2, 5, 1024, 64), (2, 8, 1024, 80),
                                      (1, 2, 1000, 40)])
def test_dkv_split_path_is_deterministic(dev, b, h, sq, d):
    """The 77-token cross-attention's dK/dV through the split path (the
    query range in parts, their fp32 partial sums added in split order by a
    second kernel of the same launch): one counted launch a call, the plain
    version's result, and the same bits on a second call."""
    from difashion_tpu_torch.nn.kernels.flash_attention import dkv_splits

    skv = 77
    assert dkv_splits(b, h, sq, skv, d) > 1
    q, k, v = _qkv(b, h, sq, skv, d, torch.bfloat16, dev, seed=11)
    do = torch.randn(b, h, sq, d, generator=torch.Generator(device=dev).manual_seed(12),
                     device=dev).bfloat16()
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, d ** -0.5)
    kernels.reset_launches()
    dk, dv = flash_attention_dkv(*args)
    dk2, dv2 = flash_attention_dkv(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_dkv"] == 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    rdk, rdv = flash_attention_dkv_ref(*args)
    assert _rel(dk, rdk) <= 1e-2 and _rel(dv, rdv) <= 1e-2


def test_sdpa_autograd_routes_through_the_kernels(dev):
    q, k, v = (t.requires_grad_() for t in _qkv(2, 5, 256, 77, 64, torch.bfloat16, dev,
                                                 seed=5))
    do = torch.randn(2, 5, 256, 64, device=dev).bfloat16()
    kernels.reset_launches()
    out = sdpa(q, k, v)
    out.backward(do)
    assert dict(kernels.LAUNCHES) == {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                                      "flash_attention_dkv": 1, "flash_attention_fwd_f32": 0,
                                      "flash_attention_dq_f32": 0, "flash_attention_dkv_f32": 0,
                                      "group_norm_silu": 0, "skinny_matmul": 0}
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    with kernels.plain_versions():
        sdpa(q, k, v).backward(do)
    assert kernels.LAUNCHES["flash_attention_fwd"] == 1
    for got, t in zip(grads, (q, k, v)):
        assert _rel(got, t.grad) <= 2e-2
    # without autograd the forward kernel runs alone and saves nothing
    with torch.no_grad():
        assert sdpa(q, k, v).grad_fn is None
    assert kernels.LAUNCHES["flash_attention_dq"] == 1


# ---- fp32 flash attention ----------------------------------------------------

F32_SHAPES = [
    (1, 2, 256, 256, 64),
    (1, 2, 256, 77, 64),     # ragged cross-attention KV
    (1, 1, 100, 50, 32),     # both dims ragged
    (2, 3, 130, 77, 16),     # the tiny config's head dim
    (1, 2, 200, 77, 40),     # sd15's
    (2, 1, 130, 300, 80),
    (1, 2, 200, 300, 128),
    (1, 1, 70, 90, 20),      # any d
]


@pytest.mark.parametrize("b,h,sq,skv,d", F32_SHAPES)
def test_f32_kernels_match_plain(dev, b, h, sq, skv, d):
    """The fp32 forward, dQ and dK/dV kernels within 2e-5 of the fp32 plain
    versions (fp32 sums in another order, exp2f for exp), on the projections'
    strided views; counted under their own names."""
    q, k, v, do = (_proj(b, s, h, d, torch.float32, dev, seed)
                   for s, seed in ((sq, 1), (skv, 2), (skv, 3), (sq, 4)))
    scale = d ** -0.5
    kernels.reset_launches()
    o, lse = flash_attention(q, k, v)
    delta = attention_delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        "flash_attention_fwd_f32": 1, "flash_attention_dq_f32": 1, "flash_attention_dkv_f32": 1}
    ro, rlse = flash_attention_ref(q, k, v)
    rdq = flash_attention_dq_ref(q, k, v, do, rlse, delta, scale)
    rdk, rdv = flash_attention_dkv_ref(q, k, v, do, rlse, delta, scale)
    for got, want in ((o, ro), (lse, rlse), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for t in (o, dq, dk, dv):
        assert t.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_sdpa_at_sd15_head_dims(dev, d, dtype):
    """sd15's head dims (8 heads over 320, 640 and 1280 channels) through sdpa
    with autograd, self- and cross-attention: no exception, the kernels of
    the dtype launched for d <= 128 (none for 160), forward and gradients
    against the plain versions."""
    b, h = 2, 8
    f32 = dtype == torch.float32
    for skv in (256, 77):
        q, k, v = (_proj(b, s, h, d, dtype, dev, seed).requires_grad_()
                   for s, seed in ((256, 1), (skv, 2), (skv, 3)))
        do = _proj(b, 256, h, d, dtype, dev, 4)
        kernels.reset_launches()
        out = sdpa(q, k, v)
        out.backward(do)
        torch.cuda.synchronize()
        suffix = "_f32" if f32 else ""
        want = 1 if d <= 128 else 0
        for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
            assert kernels.LAUNCHES[name + suffix] == want
        grads = [t.grad.clone() for t in (q, k, v)]
        for t in (q, k, v):
            t.grad = None
        with kernels.plain_versions():
            ref = sdpa(q, k, v)
            ref.backward(do)
        tol = 2e-5 if f32 else 2e-2
        assert out.dtype == dtype and _rel(out, ref) <= tol
        for got, t in zip(grads, (q, k, v)):
            assert bool(torch.isfinite(got).all()) and _rel(got, t.grad) <= tol


def _tiny_inputs(model, dev, F=4):
    """One GOR outfit at the tiny config (chip_smoke.py's gor_inputs)."""
    from difashion_tpu_torch.engine.generate import GenerationInputs

    cfg = model.config
    s, C = cfg.unet.sample_size, cfg.vae.latent_channels
    g = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=g).to(dev)
    ids = torch.randint(0, cfg.text.vocab_size, (F, 77), generator=g).to(dev)
    with torch.inference_mode():
        cate_text = model.encode_text(ids)
        null_text = model.encode_text(torch.zeros_like(ids[:1]))[0]
    return GenerationInputs(
        init_latents=rand(F, s, s, C), outfit_idx=torch.zeros(F, dtype=torch.long, device=dev),
        known_latents=rand(1, F, s, s, C) * 0.2,
        gen_mask=torch.ones(1, F, dtype=torch.bool, device=dev),
        gen_index=torch.arange(F, device=dev).view(1, F), hist_latents=rand(F, s, s, C) * 0.2,
        cate_text=cate_text, null_text=null_text, null_latent=rand(s, s, C) * 0.05)


def test_tiny_sampler_in_fp32(dev):
    """mixed_precision other than "bf16" builds an fp32 model: `build_sampler`
    at the tiny config runs every UNet attention on the fp32 kernel and
    matches the CPU's fp32 run."""
    import copy

    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.engine.generate import build_sampler, make_guidance_spec
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn.attention import CrossAttention
    from difashion_tpu_torch.nn.layers import GroupNorm

    cpu = create_difashion(ModelConfig.tiny(), seed=0, device="cpu")
    cuda = copy.deepcopy(cpu).to(dev)
    n_attn = sum(isinstance(m, CrossAttention) for m in cpu.unet.modules())
    n_gn = sum(isinstance(m, GroupNorm) for m in cpu.unet.modules())
    out = {}
    for name, model, where in (("cpu", cpu, "cpu"), ("cuda", cuda, dev)):
        sampler = build_sampler(model, num_inference_steps=5,
                                spec=make_guidance_spec(12.0, 4.0, 5.0), eta=0.1)
        kernels.reset_launches()
        out[name] = sampler(_tiny_inputs(model, where)).cpu()
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        "flash_attention_fwd_f32": 6 * n_attn, "group_norm_silu": 6 * n_gn}
    assert bool(torch.isfinite(out["cuda"]).all())
    assert _rel(out["cuda"], out["cpu"]) <= 1e-4


def test_fp32_train_step(dev):
    """One train step of the tiny config with mixed_precision="no" (autocast
    off, fp32 throughout): the fp32 forward, dQ and dK/dV kernels under every
    UNet attention, a finite loss and moved parameters."""
    from difashion_tpu_torch.config import ModelConfig, TrainConfig
    from difashion_tpu_torch.engine.train import TrainBatch, build_train_step
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn.attention import CrossAttention

    cfg, tc = ModelConfig.tiny(), TrainConfig(mixed_precision="no")
    model = create_difashion(cfg, seed=0, device=dev)
    n_attn = sum(isinstance(m, CrossAttention) for m in model.unet.modules())
    step, init = build_train_step(model, tc)
    state = init()
    before = [p.detach().clone() for p in state.params]
    g = torch.Generator(device=dev).manual_seed(1)
    B, olen, s, C = tc.train_batch_size, 4, cfg.unet.sample_size, cfg.vae.latent_channels
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    batch = TrainBatch(images=None, latent_mean=r(B, olen, s, s, C),
                       latent_logvar=r(B, olen, s, s, C) - 6.0,
                       input_ids=torch.randint(0, cfg.text.vocab_size, (B, olen, 77),
                                               generator=g, device=dev),
                       hist_latents=r(B, olen, s, s, C) * 0.3)
    with torch.no_grad():
        null_text = model.encode_text(torch.zeros(1, 77, dtype=torch.long, device=dev))[0]
    kernels.reset_launches()
    state, metrics = step(state, batch, r(s, s, C) * 0.05, null_text, g)
    torch.cuda.synchronize()
    launches = {n: c for n, c in kernels.LAUNCHES.items() if c and "flash" in n}
    assert launches == {"flash_attention_fwd_f32": n_attn, "flash_attention_dq_f32": n_attn,
                        "flash_attention_dkv_f32": n_attn}
    assert np.isfinite(float(metrics["loss"])) and not bool(metrics["update_skipped"])
    assert any(not torch.equal(a, p) for a, p in zip(before, state.params))


# ---- GroupNorm (+ SiLU) ------------------------------------------------------

GN_SHAPES = [  # (B, C, H, W, groups): vector and scalar paths, one and many chunks
    (2, 64, 8, 8, 32),
    (3, 64, 4, 4, 8),          # the tiny config's groups; HW = 16
    (1, 96, 7, 7, 32),         # HW = 49: the scalar path
    (2, 960, 16, 16, 32),      # C/G = 30, the UNet's widest up-level norm
    (1, 128, 128, 128, 32),    # a VAE level: many chunks per group
    (2, 4, 1, 1, 2),           # one element per channel
]


def _gn_inputs(shape, groups, dtype, dev, seed=0, offset=0.0):
    b, c = shape[:2]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 2 + offset).to(dtype)
    scale = torch.randn(c, generator=g, device=dev) * 0.5 + 1
    bias = torch.randn(c, generator=g, device=dev) * 0.5
    return x, scale, bias


def _gn_close(got, want, pre, dtype):
    """fp32: 1e-5. 16-bit types: one unit in the last place of the plain
    version's rounding, of y or (after SiLU) of the y it was computed from
    (2^-7 of the value for bf16, 2^-10 for fp16), plus 1e-5 for the fp32
    rounding of y = x * a + b near zero."""
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return bool((diff <= 1e-5 + 1e-5 * want.abs()).all())
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    return bool((diff <= rel * (want.float().abs() + pre.float().abs()) + 1e-5).all())


@pytest.mark.parametrize("b,c,h,w,groups", GN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_kernel_matches_plain(dev, b, c, h, w, groups, dtype, act):
    x, scale, bias = _gn_inputs((b, c, h, w), groups, dtype, dev)
    kernels.reset_launches()
    y = group_norm_silu(x, scale, bias, groups, 1e-6, act)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["group_norm_silu"] == 1
    pre = group_norm_silu_ref(x, scale, bias, groups, 1e-6)
    want = group_norm_silu_ref(x, scale, bias, groups, 1e-6, act)
    assert y.dtype == dtype and y.shape == x.shape and y.is_contiguous()
    assert bool(torch.isfinite(y).all())
    assert _gn_close(y, want, pre, dtype)
    # deterministic: no atomics
    assert torch.equal(y, group_norm_silu(x, scale, bias, groups, 1e-6, act))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_kernel_large_offset(dev, dtype):
    """|mean| >> std: the (count, mean, M2) merge does not cancel."""
    x, scale, bias = _gn_inputs((2, 64, 32, 32), 8, dtype, dev, seed=1, offset=100.0)
    y = group_norm_silu(x, scale, bias, 8, 1e-5)
    if dtype == torch.bfloat16:
        pre = group_norm_silu_ref(x, scale, bias, 8, 1e-5)
        assert _gn_close(y, pre, pre, dtype)
        return
    ref = torch.nn.functional.group_norm(x.double(), 8, scale.double(), bias.double(), 1e-5)
    # y = x * a + b cancels products of about 50 (x ~ 100, a ~ 0.5), whose fp32
    # rounding (50 * 2^-24 = 3e-6 each) is the floor here; a variance taken as
    # E[x^2] - E[x]^2 in fp32 would be off by ~2.5e-4 of itself and move y by ~1e-4
    assert (y.double() - ref).abs().max().item() <= 4e-5


def test_group_norm_kernel_beyond_2_31_elements(dev):
    """65 x 128 x 512 x 512 bf16 (2^31 + 2^25 elements, the VAE encoder's
    first level one image past the precompute batch): 64-bit offsets."""
    b, c, s, groups = 65, 128, 512, 32
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(b, c, s, s, generator=g, device=dev, dtype=torch.bfloat16)
    assert x.numel() > 2 ** 31
    scale = torch.rand(c, generator=g, device=dev) + 0.5
    bias = torch.randn(c, generator=g, device=dev) * 0.1
    y = group_norm_silu(x, scale, bias, groups, 1e-6, "silu")
    torch.cuda.synchronize()
    for i in (0, b - 1):
        pre = group_norm_silu_ref(x[i:i + 1], scale, bias, groups, 1e-6)
        want = group_norm_silu_ref(x[i:i + 1], scale, bias, groups, 1e-6, "silu")
        assert _gn_close(y[i:i + 1], want, pre, torch.bfloat16)
    del x, y
    torch.cuda.empty_cache()


def test_group_norm_wrapper_rejects(dev):
    x, scale, bias = _gn_inputs((2, 64, 8, 8), 8, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        group_norm_silu(x.transpose(2, 3), scale, bias, 8, 1e-5)      # not contiguous
    with pytest.raises(ValueError):
        group_norm_silu(x, scale, bias, 6, 1e-5)                      # 64 % 6
    with pytest.raises(TypeError):
        group_norm_silu(x.double(), scale, bias, 8, 1e-5)
    with pytest.raises(ValueError):
        group_norm_silu(x, scale.cpu(), bias, 8, 1e-5)
    with pytest.raises(ValueError):
        group_norm_silu(x, scale, bias, 8, 1e-5, act="gelu")


def test_group_norm_module_routes_through_the_kernel(dev):
    from difashion_tpu_torch.nn.layers import GroupNorm

    gn = GroupNorm(8, 64, eps=1e-5, act="silu").to(dev)
    with torch.no_grad():
        gn.weight.normal_()
        gn.bias.normal_()
    x = torch.randn(2, 64, 16, 16, device=dev).bfloat16().requires_grad_()
    dy = torch.randn(2, 64, 16, 16, device=dev).bfloat16()
    kernels.reset_launches()
    with torch.inference_mode():
        gn(x.detach())
    # a channels-last input is made contiguous for the kernel
    gn(x.detach().to(memory_format=torch.channels_last))
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = gn(x)
    y.backward(dy)
    assert kernels.LAUNCHES["group_norm_silu"] == 3
    grads = [t.grad.clone() for t in (x, gn.weight, gn.bias)]
    for t in (x, gn.weight, gn.bias):
        t.grad = None
    with kernels.plain_versions(), torch.autocast("cuda", dtype=torch.bfloat16):
        y_plain = gn(x)
        y_plain.backward(dy)
    assert kernels.LAUNCHES["group_norm_silu"] == 3
    assert y.dtype == y_plain.dtype == torch.bfloat16
    pre = group_norm_silu_ref(x.detach(), gn.weight, gn.bias, 8, 1e-5)
    assert _gn_close(y, y_plain, pre, torch.bfloat16)
    # the backward recomputes the plain version: the same gradients, but for
    # the order of the CUDA backward's sums
    for got, t in zip(grads, (x, gn.weight, gn.bias)):
        assert got.dtype == t.dtype and _rel(got, t.grad) <= 1e-3


# ---- skinny-N matmul ---------------------------------------------------------------

MM_SHAPES = [  # (M, K, N): the route's shapes, both tile widths, ragged edges
    (8192, 320, 320),
    (4096, 640, 640),
    (2048, 1280, 1280),
    (4096, 1280, 320),         # net_2 at C = 320
    (2048, 640, 2560),         # dx of net_2 at C = 640
    (1000, 96, 200),           # M, N and the last K chunk ragged
    (130, 40, 24),
]


def _mm_inputs(m, k, n, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = (torch.randn(n, k, generator=g, device=dev) / k ** 0.5).to(dtype)
    return x, w


def _mm_close(got, want, dtype):
    """Both sum in fp32 and round once: at most one unit in the last place
    apart (2^-7 of the value in bf16, 2^-10 in fp16), plus the fp32 sums'
    order near zero."""
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    diff = (got.float() - want.float()).abs()
    return bool((diff <= rel * want.float().abs() + 1e-3).all())


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_skinny_matmul_kernel_matches_plain(dev, m, k, n, dtype):
    x, w = _mm_inputs(m, k, n, dtype, dev)
    kernels.reset_launches()
    o = skinny_matmul(x, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["skinny_matmul"] == 1
    assert o.dtype == dtype and o.shape == (m, n) and o.is_contiguous()
    assert _mm_close(o, skinny_matmul_ref(x, w), dtype)
    # a row stride wider than K (a view into a wider tensor) reads in place
    wide = torch.zeros(m, k + 8, dtype=dtype, device=dev)
    wide[:, :k] = x
    assert torch.equal(skinny_matmul(wide[:, :k], w), o)


def _mm_close_after_bias(got, want, prod, dtype):
    """Kernel vs plain with a bias: the products may round one unit in the
    last place apart (as `_mm_close`), and the sums with the bias round once
    more (a unit of the result's)."""
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    diff = (got.float() - want.float()).abs()
    return bool((diff <= rel * (prod.float().abs() + want.float().abs()) + 1e-3).all())


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("w_kn", [False, True])
def test_skinny_matmul_bias_and_layout_match_plain(dev, m, k, n, dtype, w_kn):
    """The kernel with a bias, and with the weight given as [K, N] (`w_kn`,
    the backward's dx layout), against the plain version; the [K, N] form of
    a weight gives what its [N, K] form gives."""
    x, w = _mm_inputs(m, k, n, dtype, dev, seed=1)
    b = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(2), device=dev).to(dtype)
    wl = w.t().contiguous() if w_kn else w
    kernels.reset_launches()
    o = skinny_matmul(x, wl, b, w_kn=w_kn)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["skinny_matmul"] == 1
    assert o.dtype == dtype and o.shape == (m, n) and o.is_contiguous()
    prod = skinny_matmul_ref(x, wl, w_kn=w_kn)
    assert _mm_close_after_bias(o, skinny_matmul_ref(x, wl, b, w_kn=w_kn), prod, dtype)
    no_bias = skinny_matmul(x, wl, w_kn=w_kn)
    assert _mm_close(no_bias, prod, dtype) and _mm_close(no_bias, skinny_matmul(x, w), dtype)


@pytest.mark.parametrize("m,k,n", [(512, 64, 30), (2048, 320, 1001)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_skinny_matmul_odd_n_matches_plain(dev, m, k, n, dtype):
    """N % 8 != 0: rows of o are not 16-byte multiples, so the epilogue
    stores from registers instead of through TMA."""
    x, w = _mm_inputs(m, k, n, dtype, dev, seed=5)
    b = torch.randn(n, device=dev).to(dtype)
    for bias in (None, b):
        o = skinny_matmul(x, w, bias)
        torch.cuda.synchronize()
        prod = skinny_matmul_ref(x, w)
        assert o.shape == (m, n) and o.is_contiguous()
        assert _mm_close_after_bias(o, skinny_matmul_ref(x, w, bias), prod, dtype)


def test_skinny_matmul_wrapper_rejects_bias_and_layout(dev):
    x, w = _mm_inputs(512, 64, 64, torch.bfloat16, dev)
    b = torch.zeros(64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        skinny_matmul(x, w, b.float())                       # bias dtype
    with pytest.raises(ValueError):
        skinny_matmul(x, w, b[:32])                          # bias length
    with pytest.raises(ValueError):
        skinny_matmul(x, w, b.cpu())
    with pytest.raises(ValueError):
        skinny_matmul(x, w[:60].t().contiguous(), w_kn=True)  # [K, N] with N % 8
    with pytest.raises(ValueError):
        skinny_matmul(x, w[:32], w_kn=True)                  # [K, N] with K != x's


def test_skinny_matmul_wrapper_rejects(dev):
    x, w = _mm_inputs(512, 64, 64, torch.bfloat16, dev)
    with pytest.raises(TypeError):
        skinny_matmul(x.float(), w.float())
    with pytest.raises(ValueError):
        skinny_matmul(x[:, :60], w[:, :60])                  # K % 8
    with pytest.raises(ValueError):
        skinny_matmul(x.t(), w)                              # not unit stride along K
    with pytest.raises(ValueError):
        skinny_matmul(x, w.cpu())


def test_dense_routes_through_the_kernel(dev):
    from difashion_tpu_torch.nn.layers import Dense

    dense = Dense(320, 640).to(dev)
    with torch.no_grad():
        dense.bias.normal_()
    x = torch.randn(2, 2048, 320, device=dev).requires_grad_()
    dy = torch.randn(2, 2048, 640, device=dev).bfloat16()
    kernels.reset_launches()
    with torch.inference_mode():
        dense(x.detach())                                    # fp32: F.linear
    assert kernels.LAUNCHES["skinny_matmul"] == 0
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = dense(x)                                          # fp32 master weight, bf16 compute
    y.backward(dy)
    assert kernels.LAUNCHES["skinny_matmul"] == 2            # forward and dx
    assert y.dtype == torch.bfloat16 and y.shape == (2, 2048, 640)
    grads = [t.grad.clone() for t in (x, dense.weight, dense.bias)]
    for t in (x, dense.weight, dense.bias):
        t.grad = None
    with kernels.plain_versions(), torch.autocast("cuda", dtype=torch.bfloat16):
        y_plain = dense(x)
        y_plain.backward(dy)
    assert kernels.LAUNCHES["skinny_matmul"] == 2
    assert _rel(y, y_plain) <= 1e-2
    for got, t in zip(grads, (x, dense.weight, dense.bias)):
        assert got.dtype == t.dtype == torch.float32 and _rel(got, t.grad) <= 1e-2
    # M = 1024 is outside the gate: F.linear
    with torch.autocast("cuda", dtype=torch.bfloat16), torch.no_grad():
        dense(x[:, :512])
    assert kernels.LAUNCHES["skinny_matmul"] == 2


def test_skinny_matmul_autograd_with_bias_matches_plain(dev):
    """Forward with the bias in the epilogue, dx through the kernel on the
    stored weight (no transposed copy), dw and db plain: against the plain
    Function."""
    x, w = _mm_inputs(4096, 320, 640, torch.bfloat16, dev, seed=4)
    b = torch.randn(640, device=dev).bfloat16()
    for t in (x, w, b):
        t.requires_grad_()
    g = torch.randn(4096, 640, device=dev).bfloat16()
    kernels.reset_launches()
    y = SkinnyMatmul.apply(x, w, False, b)
    y.backward(g)
    assert kernels.LAUNCHES["skinny_matmul"] == 2
    grads = [t.grad.clone() for t in (x, w, b)]
    for t in (x, w, b):
        t.grad = None
    y_plain = SkinnyMatmul.apply(x, w, True, b)
    y_plain.backward(g)
    assert _mm_close_after_bias(y, y_plain, skinny_matmul_ref(x, w), torch.bfloat16)
    assert _mm_close(grads[0], x.grad, torch.bfloat16)
    assert torch.equal(grads[1], w.grad) and torch.equal(grads[2], b.grad)
    assert grads[2].dtype == torch.bfloat16


def test_skinny_matmul_autograd_matches_plain(dev):
    x, w = _mm_inputs(4096, 320, 640, torch.bfloat16, dev, seed=3)
    x.requires_grad_()
    w.requires_grad_()
    g = torch.randn(4096, 640, device=dev).bfloat16()
    kernels.reset_launches()
    SkinnyMatmul.apply(x, w, False).backward(g)
    assert kernels.LAUNCHES["skinny_matmul"] == 2
    dx, dw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    SkinnyMatmul.apply(x, w, True).backward(g)
    assert _mm_close(dx, x.grad, torch.bfloat16) and torch.equal(dw, w.grad)

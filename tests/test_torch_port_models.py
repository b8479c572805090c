"""The port's config, weight loading and four towers against the JAX package,
in fp32 on the CPU at the tiny config. Weights come from the JAX package's
own init (`create_difashion`, `init_unet`, `init_vae`) through
`core/importer.py::export_params` and load into the port strictly; inputs are
numpy arrays from fixed seeds. Where a committed torch-oracle fixture exists
(`unet_tiny_forward`, `vae_tiny_encode`, `hf_clip_text_*`) the port is held
against it too. Tolerance 1e-4 / 1e-4: fp32 sums in another order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difashion_tpu.core import config as jcfg
from difashion_tpu.core.importer import export_params
from difashion_tpu.models.difashion import create_difashion as jax_create
from difashion_tpu.models.difashion import param_count as jax_param_count
from difashion_tpu_torch import config as tcfg
from difashion_tpu_torch.models.clip_text import CLIPTextEncoder
from difashion_tpu_torch.models.difashion import create_difashion
from difashion_tpu_torch.models.unet import UNet2DCondition
from difashion_tpu_torch.models.vae import AutoencoderKL
from difashion_tpu_torch.nn import kernels
from difashion_tpu_torch.weights import BASE_TOWERS, load_difashion, load_tower, param_count

from golden_oracle import oracle
from port_config import assert_port_extends_jax

TOL = dict(rtol=1e-4, atol=1e-4)
_KINDS = {"unet": "unet", "vae": "vae", "text_encoder": "text",
          "fashion_encoder": "mutual"}


def _fixture(name):
    def missing():
        raise AssertionError(f"committed fixture {name} is missing")
    return oracle(name, missing)


def export_all(cfg, params):
    """The JAX bundle's params as the HF-layout state dicts of its towers."""
    dims = (cfg.mutual.latent_channels, cfg.mutual.latent_size)
    return {t: export_params(params[t], _KINDS[t],
                             mutual_dims=dims if t == "fashion_encoder" else None)
            for t in BASE_TOWERS}


def port_from_jax(cfg, params):
    model = create_difashion(tcfg.ModelConfig.tiny(), seed=0, device="cpu")
    load_difashion(model, export_all(cfg, params))
    return model


def jax_bundle(seed=7):
    """The JAX package's tiny bundle: (config, model, params) of
    `create_difashion(tiny, PRNGKey(seed))`."""
    cfg = jcfg.ModelConfig.tiny()
    return (cfg,) + jax_create(cfg, jax.random.PRNGKey(seed))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models' ops are far too small for torch's intra-op threads,
    which only contend with the other test workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    cfg, model, params = jax_bundle()
    return cfg, model, params, port_from_jax(cfg, params)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("preset", ["tiny", "sd2_base", "sd15"])
def test_config_presets_match_jax(preset):
    ours = dataclasses.asdict(getattr(tcfg.ModelConfig, preset)())
    theirs = dataclasses.asdict(getattr(jcfg.ModelConfig, preset)())
    assert_port_extends_jax(ours, theirs)


def test_strict_load_of_all_towers(bundle):
    cfg, _, params, port = bundle
    sds = export_all(cfg, params)
    for tower in BASE_TOWERS:
        module = getattr(port, tower)
        assert param_count(module) == jax_param_count(params[tower]), tower
        own = module.state_dict()
        assert set(own) == set(sds[tower]), tower
        for key, value in sds[tower].items():
            np.testing.assert_array_equal(own[key].numpy(), value, err_msg=key)
    # a missing key fails the strict load
    sd = dict(sds["unet"])
    sd.pop("conv_out.bias")
    with pytest.raises(RuntimeError, match="conv_out.bias"):
        load_tower(UNet2DCondition(tcfg.UNetConfig.tiny()), sd, "unet")


def test_unet_conv_in_is_zero_extended_from_4_channels(bundle):
    cfg, _, params, _ = bundle
    sd = dict(export_all(cfg, params)["unet"])
    w4 = sd["conv_in.weight"][:, :4].copy()
    sd["conv_in.weight"] = w4
    unet = UNet2DCondition(tcfg.UNetConfig.tiny())
    load_tower(unet, sd, "unet")
    w = unet.conv_in.weight.detach().numpy()
    assert w.shape[1] == 8
    np.testing.assert_array_equal(w[:, :4], w4)
    assert not w[:, 4:].any()


def test_unet_matches_jax_and_torch_oracle():
    from difashion_tpu.models.unet import init_unet

    cfg = jcfg.ModelConfig.tiny().unet
    model, params = init_unet(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    x = rng.randn(2, cfg.sample_size, cfg.sample_size, cfg.in_channels).astype(np.float32)
    tvals = np.array([17, 503], np.int64)
    ctx = rng.randn(2, 77, cfg.cross_attention_dim).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x),
                                           jnp.asarray(tvals), jnp.asarray(ctx)))

    unet = UNet2DCondition(tcfg.UNetConfig.tiny()).eval()
    load_tower(unet, export_params(params, "unet"), "unet")
    with torch.no_grad():
        got = nhwc(unet(nchw(x), torch.from_numpy(tvals), torch.from_numpy(ctx)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _fixture("unet_tiny_forward")["out"], **TOL)


def test_sd15_shaped_unet_matches_jax():
    """A tiny UNet of sd15's shape: 1x1-conv transformer projections and a
    fixed number of heads (2 over 80, 160 and 320 channels: head dims 40, 80
    and 160, as sd15's 8 heads give over 320, 640 and 1280), against the JAX
    UNet with the same weights. On the CPU d = 40 and 80 take the plain flash
    version (the kernels' on the card) and d = 160 plain matmul + softmax."""
    from difashion_tpu.models.unet import init_unet

    kw = dict(sample_size=8, block_out_channels=(80, 160, 320, 320), layers_per_block=1,
              cross_attention_dim=48, norm_num_groups=8, use_linear_projection=False,
              fixed_num_heads=2)
    model, params = init_unet(jcfg.UNetConfig(**kw), jax.random.PRNGKey(3))
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    tvals = np.array([29, 711], np.int64)
    ctx = rng.randn(2, 77, 48).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x),
                                           jnp.asarray(tvals), jnp.asarray(ctx)))
    unet = UNet2DCondition(tcfg.UNetConfig(**kw)).eval()
    load_tower(unet, export_params(params, "unet"), "unet")
    heads = {(m.heads, m.head_dim) for m in unet.modules() if hasattr(m, "head_dim")}
    assert heads == {(2, 40), (2, 80), (2, 160)}
    with torch.no_grad():
        got = nhwc(unet(nchw(x), torch.from_numpy(tvals), torch.from_numpy(ctx)))
    np.testing.assert_allclose(got, want, **TOL)


def test_vae_encode_matches_jax_and_torch_oracle():
    from difashion_tpu.models.vae import AutoencoderKL as JVAE
    from difashion_tpu.models.vae import init_vae

    cfg = jcfg.ModelConfig.tiny().vae
    model, params = init_vae(cfg, jax.random.PRNGKey(1))
    x = np.random.RandomState(2).randn(1, cfg.sample_size, cfg.sample_size, 3)
    x = (x * 0.5).astype(np.float32)
    dist = jax.jit(lambda p, x: model.apply({"params": p}, x, method=JVAE.encode))(
        params, jnp.asarray(x))

    vae = AutoencoderKL(tcfg.VAEConfig.tiny()).eval()
    load_tower(vae, export_params(params, "vae"), "vae")
    with torch.no_grad():
        got = vae.encode(nchw(x))
    ref = _fixture("vae_tiny_encode")
    for name in ("mean", "logvar"):
        ours = nhwc(getattr(got, name))
        np.testing.assert_allclose(ours, np.asarray(getattr(dist, name)), **TOL)
        np.testing.assert_allclose(ours, ref[name], **TOL)


def test_vae_decode_and_image_encode_match_jax(bundle):
    _, model, params, port = bundle
    s = 8
    rng = np.random.RandomState(3)
    lat = rng.randn(2, s, s, 4).astype(np.float32)
    want = np.asarray(jax.jit(model.decode_latents)(params, jnp.asarray(lat)))
    with torch.no_grad():
        got = nhwc(port.decode_latents(nchw(lat)))
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, **TOL)

    imgs = np.tanh(rng.randn(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.encode_images)(params, jnp.asarray(imgs)))
    with torch.no_grad():
        got = nhwc(port.encode_images(nchw(imgs)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_matches_hf_fixture(act):
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 1000, size=(3, 77)).astype(np.int64)
    ids[:, 0] = 49406 % 1000
    fix = _fixture(f"hf_clip_text_{act}")
    sd = {k[3:]: v for k, v in fix.items() if k.startswith("sd.")}
    text = CLIPTextEncoder(tcfg.CLIPTextConfig(
        vocab_size=1000, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, hidden_act=act)).eval()
    load_tower(text, sd, "text_encoder")
    with torch.no_grad():
        got = text(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, fix["ref"], **TOL)


def test_clip_text_and_mutual_match_jax(bundle):
    cfg, model, params, port = bundle
    rng = np.random.RandomState(4)
    ids = rng.randint(0, cfg.text.vocab_size, size=(3, 77)).astype(np.int32)
    want = np.asarray(jax.jit(model.encode_text)(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = port.encode_text(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    s = cfg.mutual.latent_size
    emb = (rng.randn(5, s, s, 4) * 2).astype(np.float32)
    want = np.asarray(jax.jit(model.apply_mutual)(params, jnp.asarray(emb)))
    with torch.no_grad():
        got = nhwc(port.apply_mutual(nchw(emb)))
    np.testing.assert_allclose(got, want, **TOL)


def test_bundle_unet_matches_jax(bundle):
    cfg, model, params, port = bundle
    rng = np.random.RandomState(5)
    s = cfg.unet.sample_size
    x = rng.randn(3, s, s, 8).astype(np.float32)
    t = np.array([1, 481, 981], np.int32)
    ctx = rng.randn(3, 77, cfg.unet.cross_attention_dim).astype(np.float32)
    want = np.asarray(jax.jit(model.apply_unet)(params, jnp.asarray(x), jnp.asarray(t),
                                                jnp.asarray(ctx)))
    with torch.no_grad():
        got = nhwc(port.apply_unet(nchw(x), torch.from_numpy(t).long(),
                                   torch.from_numpy(ctx)))
        with kernels.plain_versions():
            plain = nhwc(port.apply_unet(nchw(x), torch.from_numpy(t).long(),
                                         torch.from_numpy(ctx)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, plain)


def test_create_difashion_is_seeded():
    a = create_difashion(tcfg.ModelConfig.tiny(), seed=3, device="cpu")
    b = create_difashion(tcfg.ModelConfig.tiny(), seed=3, device="cpu")
    c = create_difashion(tcfg.ModelConfig.tiny(), seed=4, device="cpu")
    w = "unet.conv_in.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    assert not a.training and a.unet.dtype == torch.float32
    half = create_difashion(tcfg.ModelConfig.tiny(), seed=3, device="cpu",
                            dtype=torch.bfloat16)
    assert {p.dtype for p in half.parameters()} == {torch.bfloat16}

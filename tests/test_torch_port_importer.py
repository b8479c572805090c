"""The port's diffusers-directory importer (`core/importer.py`) against the
JAX package's, on the CPU at the tiny config. A diffusers directory is
written from the JAX package's own weights (`export_params`, the UNet's
conv_in cut to SD's 4 input channels, the text encoder with HF's
`position_ids` buffer) in three forms: plain safetensors; sharded
`*.safetensors.index.json` (the VAE in fp16); and torch `.bin` files in a
{"state_dict": ...} wrapper with the VAE's legacy attention names. Both
importers read each form; the towers must hold the same weights, and the
port's UNet must give the JAX UNet's output (tolerance 1e-4, as in
`test_torch_port_models.py`). The port's safetensors reader is held against
the `safetensors` package, which the tests use only to write and to
cross-check. Also `extract-features --pretrained_dir` against the JAX
package's `import_sd_checkpoint` + `encode_catalog` (tolerance 1e-5, as in
`test_torch_port_precompute.py`)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import load_file as load_torch
from safetensors.torch import save_file as save_torch

from difashion_tpu.core import importer as jimp
from difashion_tpu.data import precompute as jpre
from difashion_tpu_torch import config as tcfg
from difashion_tpu_torch.__main__ import main as port_main
from difashion_tpu_torch.cli.extract_features import make_item_loader
from difashion_tpu_torch.core import importer as timp
from difashion_tpu_torch.data import precompute as tpre
from difashion_tpu_torch.models.difashion import create_difashion

from test_torch_port_models import export_all, jax_bundle, nchw, nhwc

TOL = dict(rtol=1e-4, atol=1e-4)
ENCODE_TOL = dict(rtol=1e-5, atol=1e-5)
FILES = {"unet": "diffusion_pytorch_model", "vae": "diffusion_pytorch_model",
         "text_encoder": "model"}
LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    """The JAX tiny bundle and the SD towers' state dicts of its weights."""
    cfg, model, params = jax_bundle(seed=11)
    sds = export_all(cfg, params)
    unet = dict(sds["unet"])
    unet["conv_in.weight"] = np.ascontiguousarray(unet["conv_in.weight"][:, :4])
    text = dict(sds["text_encoder"])
    text["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    # contiguous: safetensors' numpy writer stores an array's memory, not its
    # logical order
    towers = {"unet": unet, "vae": sds["vae"], "text_encoder": text}
    return cfg, model, params, {t: {k: np.ascontiguousarray(v) for k, v in sd.items()}
                                for t, sd in towers.items()}


@pytest.fixture(scope="module")
def jax_unet(bundle):
    """The JAX UNet forward, compiled once for every form."""
    return jax.jit(bundle[1].apply_unet)


def _legacy_vae(sd):
    out = {}
    for k, v in sd.items():
        for new, old in LEGACY.items():
            if f".attentions.0.{new}." in k:
                k = k.replace(f".{new}.", f".{old}.")
        out[k] = v
    return out


def write_diffusers_dir(root, sds, form):
    for tower, sd in sds.items():
        d = os.path.join(root, tower)
        os.makedirs(d, exist_ok=True)
        stem = os.path.join(d, FILES[tower])
        if form == "safetensors":
            save_numpy(sd, stem + ".safetensors", metadata={"format": "pt"})
        elif form == "sharded":
            if tower == "vae":
                sd = {k: (v.astype(np.float16) if v.dtype == np.float32 else v)
                      for k, v in sd.items()}
            keys = sorted(sd)
            weight_map = {}
            for i, part in enumerate((keys[::2], keys[1::2])):
                name = f"{FILES[tower]}-0000{i + 1}-of-00002.safetensors"
                save_numpy({k: sd[k] for k in part}, os.path.join(d, name))
                weight_map.update({k: name for k in part})
            with open(stem + ".safetensors.index.json", "w") as f:
                json.dump({"metadata": {}, "weight_map": weight_map}, f)
        else:
            if tower == "vae":
                sd = _legacy_vae(sd)
            wrapped = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
            wrapped["version"] = 1
            name = "pytorch_model.bin" if tower == "text_encoder" else FILES[tower] + ".bin"
            torch.save({"state_dict": wrapped}, os.path.join(d, name))
    return str(root)


def test_read_safetensors_matches_the_package(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f64": torch.randn(3, 2, generator=g, dtype=torch.float64),
        "f32": torch.randn(5, 7, generator=g),
        "f16": torch.randn(4, 3, 2, generator=g).half(),
        "bf16": torch.randn(33, generator=g).bfloat16(),
        "i64": torch.arange(-5, 7, dtype=torch.int64).reshape(3, 4),
        "i32": torch.tensor([-(2**31), 2**31 - 1, 0], dtype=torch.int32),
        "i16": torch.tensor([[-7, 300]], dtype=torch.int16),
        "i8": torch.tensor([-128, 127, 3], dtype=torch.int8),
        "u8": torch.tensor([0, 255, 9], dtype=torch.uint8),
        "u16": torch.tensor([0, 65535, 9], dtype=torch.uint16),
        "u32": torch.tensor([2**32 - 1, 7], dtype=torch.uint32),
        "u64": torch.tensor([2**63 + 5, 1], dtype=torch.uint64),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 3),
    }
    path = str(tmp_path / "x.safetensors")
    save_torch(tensors, path, metadata={"format": "pt", "note": "test"})
    got, want = timp.read_safetensors(path), load_torch(path)
    assert set(got) == set(want) == set(tensors)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    assert timp.load_state_dict(path).keys() == got.keys()
    with open(path, "rb") as f:
        raw = f.read()
    (tmp_path / "cut.safetensors").write_bytes(raw[:-4])
    with pytest.raises(ValueError, match="past the end"):
        timp.read_safetensors(str(tmp_path / "cut.safetensors"))
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    header["f32"]["dtype"] = "C64"
    body = json.dumps(header).encode()
    (tmp_path / "bad.safetensors").write_bytes(len(body).to_bytes(8, "little") + body
                                               + raw[8 + n:])
    with pytest.raises(ValueError, match="unsupported dtype C64"):
        timp.read_safetensors(str(tmp_path / "bad.safetensors"))


def test_find_weights_file_matches_jax(tmp_path):
    d = tmp_path / "unet"
    d.mkdir()
    for fn in (timp.find_weights_file, jimp.find_weights_file):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path), "unet")
    (d / "b.safetensors.index.json").write_text("{}")
    (d / "a.safetensors.index.json").write_text("{}")
    assert timp.find_weights_file(str(tmp_path), "unet").endswith("a.safetensors.index.json")
    for name in reversed(timp.WEIGHT_NAMES):
        (d / name).write_bytes(b"")
        got = timp.find_weights_file(str(tmp_path), "unet")
        assert got == jimp.find_weights_file(str(tmp_path), "unet")
        assert os.path.basename(got) == name


@pytest.mark.parametrize("form", ["safetensors", "sharded", "bin"])
def test_import_sd_checkpoint_matches_jax(bundle, jax_unet, tmp_path, form):
    cfg, _, params, sds = bundle
    root = write_diffusers_dir(tmp_path / "sd", sds, form)
    assert os.path.basename(timp.find_weights_file(root, "vae")) == {
        "safetensors": "diffusion_pytorch_model.safetensors",
        "sharded": "diffusion_pytorch_model.safetensors.index.json",
        "bin": "diffusion_pytorch_model.bin"}[form]
    jparams = jimp.import_sd_checkpoint(root, params)
    port = create_difashion(tcfg.ModelConfig.tiny(), seed=3, device="cpu")
    fashion = {k: v.clone() for k, v in port.fashion_encoder.state_dict().items()}
    assert timp.import_sd_checkpoint(root, port) is port
    # the same weights as the JAX importer's, tower by tower
    want = export_all(cfg, jparams)
    for tower in ("unet", "vae", "text_encoder"):
        own = getattr(port, tower).state_dict()
        assert set(own) == set(want[tower]), tower
        for k, v in want[tower].items():
            np.testing.assert_array_equal(own[k].numpy(), v, err_msg=f"{tower} {k}")
    w = port.unet.conv_in.weight.detach()
    assert w.shape[1] == 8 and not w[:, 4:].any()
    for k, v in port.fashion_encoder.state_dict().items():
        assert torch.equal(v, fashion[k]), k
    if form == "sharded":   # read in fp16, loaded into the fp32 tower
        assert port.vae.encoder.conv_in.weight.dtype == torch.float32
        np.testing.assert_array_equal(
            port.vae.encoder.conv_in.weight.detach().numpy(),
            sds["vae"]["encoder.conv_in.weight"].astype(np.float16).astype(np.float32))

    rng = np.random.RandomState(4)
    s = cfg.unet.sample_size
    x = rng.randn(2, s, s, cfg.unet.in_channels).astype(np.float32)
    t = np.array([17, 603], np.int64)
    ctx = rng.randn(2, 77, cfg.unet.cross_attention_dim).astype(np.float32)
    ref = np.asarray(jax_unet(jparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        got = nhwc(port.apply_unet(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx)))
    np.testing.assert_allclose(got, ref, **TOL)


def test_import_missing_keys_extras_and_shapes(bundle, caplog):
    _, _, _, sds = bundle
    port = create_difashion(tcfg.ModelConfig.tiny(), seed=3, device="cpu")
    vae = dict(sds["vae"])
    vae["encoder.extra.weight"] = np.zeros(3, np.float32)
    timp.import_tower(port.vae, vae, "vae")   # an extra key: a warning
    assert "encoder.extra.weight" in caplog.text
    np.testing.assert_array_equal(port.vae.decoder.conv_in.weight.detach().numpy(),
                                  sds["vae"]["decoder.conv_in.weight"])
    vae.pop("decoder.conv_out.bias")
    with pytest.raises(KeyError, match="decoder.conv_out.bias"):
        timp.import_tower(port.vae, vae, "vae")
    bad = dict(sds["vae"])
    bad["decoder.conv_out.bias"] = np.zeros(7, np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        timp.import_tower(port.vae, bad, "vae")


def test_extract_features_pretrained_dir_matches_jax(bundle, tmp_path):
    from PIL import Image

    cfg, model, params, sds = bundle
    root = write_diffusers_dir(tmp_path / "sd", sds, "safetensors")
    data_dir, img_dir = tmp_path / "data", tmp_path / "imgs"
    data_dir.mkdir()
    img_dir.mkdir()
    rng = np.random.RandomState(12)
    names = []
    for i in range(5):
        Image.fromarray(rng.randint(0, 255, (60, 48 + 4 * i, 3), dtype=np.uint8)).save(
            img_dir / f"item{i}.png")
        names.append(f"item{i}.png")
    paths = tmp_path / "paths.npy"
    np.save(paths, np.array(names, dtype=object))
    assert port_main(["extract-features", "--data_path", str(data_dir), "--img_folder_path",
                      str(img_dir), "--image_paths_npy", str(paths), "--stage", "vae",
                      "--tiny", "--device", "cpu", "--pretrained_dir", root]) == 0
    got = tpre.load_processed(str(data_dir), "all_item_moments")
    loader = make_item_loader(str(img_dir), names, cfg.vae.sample_size)
    want = jpre.encode_catalog(model, jimp.import_sd_checkpoint(root, params), loader, 5,
                               batch_size=8)
    for key in ("mean", "logvar"):
        assert got[key].shape == want[key].shape == (5, 8, 8, 4)
        np.testing.assert_allclose(got[key], want[key], **ENCODE_TOL)

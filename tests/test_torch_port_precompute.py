"""The port's data slice against the JAX package on the CPU: `Config` and its
JSON, the `.npy` readers, the prompts, both tokenizers, the PIL pipeline, the
catalog precompute (`encode_catalog` at the tiny config with the JAX
package's weights carried across by `core/importer.py::export_params`),
`tokenize_outfits`, the `processed/` cache file for file, and the
`extract-features --stage vae` CLI on a synthetic PNG catalog, whose cache
the JAX package's loaders read unchanged. Tolerance 1e-5 in fp32."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from difashion_tpu.core import config as jcfg
from difashion_tpu.data import datasets as jdatasets
from difashion_tpu.data import precompute as jpre
from difashion_tpu.data import preprocessing as jprep
from difashion_tpu.data import prompts as jprompts
from difashion_tpu.data import tokenizer as jtok
from difashion_tpu_torch import config as tcfg
from difashion_tpu_torch.__main__ import main as port_main
from difashion_tpu_torch.cli.extract_features import make_item_loader
from difashion_tpu_torch.data import datasets as tdatasets
from difashion_tpu_torch.data import precompute as tpre
from difashion_tpu_torch.data import preprocessing as tprep
from difashion_tpu_torch.data import prompts as tprompts
from difashion_tpu_torch.data import tokenizer as ttok
from difashion_tpu_torch.models.difashion import create_difashion
from difashion_tpu_torch.nn import kernels

from test_torch_port_models import jax_bundle, port_from_jax
from port_config import assert_port_extends_jax

TOL = dict(rtol=1e-5, atol=1e-5)
CATES = {1: "pants", 2: "shoes", 3: "earrings", 4: "t-shirt", 5: "bag"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    cfg, model, params = jax_bundle(seed=5)
    return cfg, model, params, port_from_jax(cfg, params)


def _dataset_dicts(rng, n_rows=5, n_items=12):
    def table():
        return {"uids": list(rng.randint(1, 4, n_rows)),
                "oids": list(range(100, 100 + n_rows)),
                "outfits": [list(o) for o in rng.randint(1, n_items, (n_rows, 4))],
                "category": [list(c) for c in rng.randint(1, 6, (n_rows, 4))]}
    return {"train.npy": table(), "fitb_test.npy": table(),
            "train_history.npy": {1: {2: [3, 4], 5: []}, 2: {1: [7]}},
            "test_history.npy": {3: {4: [1, 2, 9]}},
            "id_cate_dict.npy": dict(CATES),
            "test_grd.npy": {100: {"outfits": [1, 2, 3, 4], "category": [1, 2, 3, 4]}}}


def _write_dataset(path, dicts):
    os.makedirs(path, exist_ok=True)
    for name, d in dicts.items():
        np.save(os.path.join(path, name), np.array(d, dtype=object))


def test_config_matches_jax_and_reads_its_json():
    for preset in ("preset_eta01", "preset_tiny"):
        ours, theirs = getattr(tcfg.Config, preset)(), getattr(jcfg.Config, preset)()
        assert_port_extends_jax(dataclasses.asdict(ours), dataclasses.asdict(theirs))
        assert tcfg.Config.from_json(theirs.to_json()) == ours
        assert jcfg.Config.from_json(ours.to_json()) == theirs
        assert tcfg.Config.from_dict(json.loads(ours.to_json())) == ours


def test_readers_and_prompts_match_jax(tmp_path):
    _write_dataset(tmp_path, _dataset_dicts(np.random.RandomState(0)))
    ours, theirs = tdatasets.FashionData.load(str(tmp_path)), jdatasets.FashionData.load(
        str(tmp_path))
    for name in ("train", "fitb_test"):
        a, b = getattr(ours, name), getattr(theirs, name)
        for field in ("uids", "oids", "outfits", "category"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert ours.fitb_valid is None and theirs.fitb_valid is None
    assert ours.history == theirs.history and ours.id_cate_dict == theirs.id_cate_dict
    assert ours.test_grd == theirs.test_grd
    lat = np.random.RandomState(1).randn(12, 2, 2, 4).astype(np.float32)
    hist = ours.history["train"]
    a = tdatasets.HistLatentStore.from_catalog(hist, lat)
    b = jdatasets.HistLatentStore.from_catalog(hist, lat)
    uids, cats = np.array([1, 2, 9]), np.array([[2, 5, 1, 3], [1, 1, 2, 2], [4, 4, 4, 4]])
    np.testing.assert_array_equal(a.gather(uids, cats), b.gather(uids, cats))
    cids = sorted(CATES)
    assert tprompts.build_train_prompts(cids, CATES) == jprompts.build_train_prompts(cids, CATES)
    assert tprompts.build_eval_prompts(cids, CATES) == jprompts.build_eval_prompts(cids, CATES)


def test_tokenizers_match_jax(tmp_path):
    texts = [jprompts.train_prompt(c) for c in CATES.values()] + ["", "a " * 90,
                                                                   "Ünïcode  words\tand 42"]
    np.testing.assert_array_equal(ttok.HashTokenizer()(texts), jtok.HashTokenizer()(texts))
    np.testing.assert_array_equal(ttok.HashTokenizer(vocab_size=100)(texts, max_length=16),
                                  jtok.HashTokenizer(vocab_size=100)(texts, max_length=16))
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "l": 2, "o": 3, "w": 4, "w</w>": 5,
             "lo": 6, "low</w>": 7, "o</w>": 8, "a</w>": 9, "a": 10}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nl o\nlo w</w>\n")
    ours = ttok.load_tokenizer(str(tmp_path))
    theirs = jtok.load_tokenizer(str(tmp_path))
    assert isinstance(ours, ttok.CLIPBPETokenizer)
    words = ["low", "loo", "low low a", "a " * 40, "<|startoftext|>low<|endoftext|>"]
    np.testing.assert_array_equal(ours(words), theirs(words))
    np.testing.assert_array_equal(ours(words, max_length=5), theirs(words, max_length=5))
    assert isinstance(ttok.load_tokenizer(None, vocab_size=100), ttok.HashTokenizer)
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer(str(tmp_path / "missing"), strict=True)


def test_image_pipeline_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(2)
    rgba = Image.fromarray(rng.randint(0, 255, (40, 70, 4), dtype=np.uint8), "RGBA")
    rgb = Image.fromarray(rng.randint(0, 255, (90, 60, 3), dtype=np.uint8))
    same = lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for img in (rgba, rgb):
        same(tprep.composite_on_white(img), jprep.composite_on_white(img))
        same(tprep.pad_to_square_white(img.convert("RGB")),
             jprep.pad_to_square_white(img.convert("RGB")))
        same(tprep.prepare_catalog_image(img, 64), jprep.prepare_catalog_image(img, 64))
        for crop in ("center", "random"):
            np.testing.assert_array_equal(
                tprep.to_model_input(img.convert("RGB"), 32, crop, np.random.RandomState(3)),
                jprep.to_model_input(img.convert("RGB"), 32, crop, np.random.RandomState(3)))
    rgb.save(tmp_path / "x.png")
    np.testing.assert_array_equal(tprep.load_catalog_image(str(tmp_path / "x.png"), 48),
                                  jprep.load_catalog_image(str(tmp_path / "x.png"), 48))
    np.testing.assert_array_equal(tprep.make_null_image(16), jprep.make_null_image(16))
    v = rng.rand(2, 4, 4, 3) * 1.2 - 0.1
    np.testing.assert_array_equal(tprep.denormalize_to_uint8(v), jprep.denormalize_to_uint8(v))


@pytest.mark.parametrize("batch_size", [4, 10])
def test_encode_catalog_matches_jax(bundle, batch_size):
    cfg, model, params, port = bundle
    s = cfg.vae.sample_size
    imgs = (np.random.RandomState(4).rand(10, s, s, 3) * 2 - 1).astype(np.float32)
    want = jpre.encode_catalog(model, params, lambda i: imgs[i], 10, batch_size=batch_size)
    kernels.reset_launches()
    got = tpre.encode_catalog(port, lambda i: imgs[i], 10, batch_size=batch_size,
                              device="cpu")
    assert not any(kernels.LAUNCHES.values())
    lat = s // cfg.vae.scale_factor
    for key in ("mean", "logvar"):
        assert got[key].shape == (10, lat, lat, cfg.vae.latent_channels)
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], **TOL)
    np.testing.assert_array_equal(tpre.moments_to_scaled_modes(got, 0.5), got["mean"] * 0.5)


def test_tokenize_outfits_ids_equal_jax():
    rng = np.random.RandomState(5)
    table = tdatasets.OutfitTable.from_dict(_dataset_dicts(rng)["train.npy"])
    jtable = jdatasets.OutfitTable(table.uids, table.oids, table.outfits, table.category)
    got = tpre.tokenize_outfits(table, CATES, ttok.HashTokenizer())
    want = jpre.tokenize_outfits(jtable, CATES, jtok.HashTokenizer())
    assert got.dtype == want.dtype == np.int32 and got.shape == (5, 4, 77)
    np.testing.assert_array_equal(got, want)
    empty = tdatasets.OutfitTable(*(np.zeros((0,) + a.shape[1:], np.int64)
                                    for a in (table.uids, table.oids, table.outfits,
                                              table.category)))
    assert tpre.tokenize_outfits(empty, CATES, ttok.HashTokenizer()).shape == (0, 4, 77)


def _same_file(a, b):
    if a.endswith(".npz"):
        with np.load(a, allow_pickle=True) as za, np.load(b, allow_pickle=True) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, k
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
        return
    va, vb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert va.dtype == vb.dtype and va.shape == vb.shape
    if va.dtype != object:
        np.testing.assert_array_equal(va, vb)
        return
    da, db = va.item(), vb.item()
    assert da.keys() == db.keys()
    np.testing.assert_array_equal(da.pop("null"), db.pop("null"))
    for uid in da:
        assert da[uid].keys() == db[uid].keys()
        for cid in da[uid]:
            assert da[uid][cid].dtype == db[uid][cid].dtype
            np.testing.assert_array_equal(da[uid][cid], db[uid][cid])


def test_build_processed_cache_equals_jax_file_for_file(tmp_path):
    rng = np.random.RandomState(6)
    data_dir = tmp_path / "data"
    _write_dataset(data_dir, _dataset_dicts(rng))
    moments = {"mean": rng.randn(12, 8, 8, 4).astype(np.float32),
               "logvar": rng.uniform(-8, -2, (12, 8, 8, 4)).astype(np.float32)}
    ours_dir, theirs_dir = tmp_path / "ours", tmp_path / "theirs"
    ours = tpre.build_processed_cache(str(ours_dir), tdatasets.FashionData.load(str(data_dir)),
                                      CATES, ttok.HashTokenizer(), moments, 0.18215)
    theirs = jpre.build_processed_cache(str(theirs_dir),
                                        jdatasets.FashionData.load(str(data_dir)),
                                        CATES, jtok.HashTokenizer(), moments, 0.18215)
    assert ours.keys() == theirs.keys()
    files = sorted(os.listdir(theirs_dir / "processed"))
    assert sorted(os.listdir(ours_dir / "processed")) == files
    assert "train_hist_latents.npy" in files and "new_fitb_test.npz" in files
    for name in files:
        _same_file(str(ours_dir / "processed" / name), str(theirs_dir / "processed" / name))
    # each package's loader reads the other's moments
    np.testing.assert_array_equal(jpre.load_processed(str(ours_dir), "all_item_moments")["mean"],
                                  tpre.load_processed(str(theirs_dir), "all_item_moments")["mean"])
    assert tpre.load_processed(str(ours_dir), "missing") is None


def test_extract_features_cli_writes_a_cache_the_jax_package_reads(tmp_path):
    from PIL import Image

    n_items = 10   # the histories of _dataset_dicts point at items up to 9
    rng = np.random.RandomState(7)
    data_dir, img_dir = tmp_path / "data", tmp_path / "imgs"
    _write_dataset(data_dir, _dataset_dicts(rng, n_items=n_items))
    img_dir.mkdir()
    names = []
    for i in range(n_items):
        mode, ch = ("RGBA", 4) if i % 2 else ("RGB", 3)
        arr = rng.randint(0, 255, size=(50 + 3 * i, 40, ch), dtype=np.uint8)
        Image.fromarray(arr, mode).save(img_dir / f"item{i}.png")
        names.append(f"item{i}.png")
    paths = tmp_path / "all_item_image_paths.npy"
    np.save(paths, np.array(names, dtype=object))
    args = ["extract-features", "--data_path", str(data_dir), "--img_folder_path",
            str(img_dir), "--image_paths_npy", str(paths), "--stage", "vae", "--tiny",
            "--batch_size", "3", "--device", "cpu"]
    assert port_main(args) == 0

    cfg = tcfg.Config.preset_tiny().model
    loader = make_item_loader(str(img_dir), names, cfg.vae.sample_size)
    # the item loader is the JAX command's: the native catalog pipeline where
    # the library builds (tests/test_torch_port_native.py), else PIL's
    from difashion_tpu.cli.extract_features import make_item_loader as jax_make_item_loader

    jax_loader = jax_make_item_loader(str(img_dir), names, 64)
    for i in (0, 1):
        np.testing.assert_array_equal(loader(i), jax_loader(i))
    model = create_difashion(cfg, seed=0, device="cpu")
    want = tpre.encode_catalog(model, loader, n_items, batch_size=4, device="cpu")
    got = jpre.load_processed(str(data_dir), "all_item_moments")
    lat = cfg.vae.sample_size // cfg.vae.scale_factor
    for key in ("mean", "logvar"):
        assert got[key].shape == (n_items, lat, lat, 4) and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], **TOL)
    latents = np.load(data_dir / "processed" / "all_item_latents.npy")
    np.testing.assert_allclose(latents, got["mean"] * cfg.vae.scaling_factor, rtol=1e-6)
    # the JAX package's history store takes the port's latents as they are
    store = jdatasets.HistLatentStore.from_catalog({1: {2: [3, 4]}}, latents)
    np.testing.assert_allclose(store.lookup(1, 2), (latents[3] + latents[4]) / 2, rtol=1e-6)

    # the CLIP stage writes the catalog's CLIP features and the history means
    # (held against the JAX command in tests/test_torch_port_eval.py)
    assert port_main(args + ["--stage", "clip"]) == 0
    feats = np.load(data_dir / "processed" / "cnn_features_clip.npy")
    assert feats.shape == (n_items, 16) and np.isfinite(feats).all()
    hist = np.load(data_dir / "processed" / "test_history_clipembs.npy", allow_pickle=True).item()
    np.testing.assert_allclose(hist[3][4], feats[[1, 2, 9]].mean(0), rtol=1e-6)
    # --pretrained_dir reads a diffusers directory (test_torch_port_importer.py)
    with pytest.raises(FileNotFoundError, match="no weights file"):
        port_main(args + ["--pretrained_dir", str(tmp_path / "no-such-dir")])
    assert port_main(["no-such-command"]) == 2

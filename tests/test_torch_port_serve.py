"""The port's serving path on the CPU at the tiny config: the generation
pipeline against the JAX package's (`prepare_batch` field by field, the
images of `generate_batch` given the same initial latents), its own
properties (batch-grouping invariance, the manifests and JPEG tree of `run`,
the idempotent skip, a bit-identical crash-resume), the checkpoint store
(save and load, retention, the async write's error, the three EMA cases) and
`load_model_for_inference`, the generation service and its HTTP layer (as
tests/test_serve.py holds the JAX one), and the `generate` and `serve`
commands with `--tiny --device cpu`.

The port draws each fill's initial noise from a torch.Generator seeded by
(seed, uid, oid, slot), JAX from a threefry key folded from the same: the
comparisons with JAX inject JAX's initial latents. Tolerances: the text
table 1e-4 (fp32 sums in another order); images within one uint8 level, on
at most 1 % of the values (a fp32 sum in another order moves a value across
a rounding boundary now and then)."""
import argparse
import base64
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from difashion_tpu.core.config import Config as JConfig
from difashion_tpu.data import HashTokenizer as JHashTokenizer
from difashion_tpu.data import HistLatentStore as JHistLatentStore
from difashion_tpu.engine.pipeline import GenerationPipeline as JPipeline
from difashion_tpu.models import create_difashion as jax_create
from difashion_tpu_torch import checkpoint as ckpt
from difashion_tpu_torch.checkpoint import CheckpointStore
from difashion_tpu_torch.cli import serve
from difashion_tpu_torch.cli.generate import load_model_for_inference, run_name
from difashion_tpu_torch.config import Config, TrainConfig
from difashion_tpu_torch.data.datasets import HistLatentStore, OutfitTable
from difashion_tpu_torch.data.precompute import save_processed
from difashion_tpu_torch.data.tokenizer import HashTokenizer
from difashion_tpu_torch.engine.pipeline import (
    GenerationPipeline,
    fill_noise,
    merge_images_grid,
)
from difashion_tpu_torch.engine.train import build_train_step
from difashion_tpu_torch.models.difashion import create_difashion

from test_torch_port_models import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_port_models import port_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATES = {c: f"cate{c}" for c in range(1, 6)}


def _tiny(cfg, **gen):
    gen = dict(dict(num_inference_steps=2, fitb_batch_size=3, gor_batch_size=2), **gen)
    return dataclasses.replace(cfg, generation=dataclasses.replace(cfg.generation, **gen))


def _catalog(cfg):
    h, C = cfg.model.unet.sample_size, cfg.model.vae.latent_channels
    return np.random.RandomState(0).randn(20, h, h, C).astype(np.float32) * 0.2


@pytest.fixture(scope="module")
def both():
    """The JAX pipeline and the port's over the same weights, catalog latents
    and history."""
    jcfg, cfg = _tiny(JConfig.preset_tiny()), _tiny(Config.preset_tiny())
    model, params = jax_create(jcfg.model, jax.random.PRNGKey(0))
    lat = _catalog(cfg)
    history = {1: {2: [3, 4]}}
    jpipe = JPipeline(model, params, jcfg, CATES, JHashTokenizer(jcfg.model.text.vocab_size),
                      JHistLatentStore.from_catalog(history, lat), item_latents=lat)
    port = port_from_jax(jcfg.model, params)
    pipe = GenerationPipeline(port, cfg, CATES, HashTokenizer(cfg.model.text.vocab_size),
                              HistLatentStore.from_catalog(history, lat), item_latents=lat)
    return jpipe, pipe


@pytest.fixture(scope="module")
def pipe(both):
    return both[1]


def _table(n=4, seed=1):
    rng = np.random.RandomState(seed)
    outfits = rng.randint(1, 20, size=(n, 4))
    outfits[np.arange(n), rng.randint(0, 4, n)] = 0   # one blank per outfit
    return OutfitTable(uids=np.arange(1, n + 1), oids=np.arange(100, 100 + n),
                       outfits=outfits, category=rng.randint(1, 6, size=(n, 4)))


def _batch(table, rows=None):
    sl = slice(None) if rows is None else np.asarray(rows)
    return {"uids": table.uids[sl], "oids": table.oids[sl], "outfits": table.outfits[sl],
            "category": table.category[sl]}


def _ragged():
    """3 outfits with 1 / 2 / 1 blanks."""
    t = _table(3)
    t.outfits[1, :2] = 0
    return t


# ---- the pipeline against JAX's ----------------------------------------------

@pytest.mark.parametrize("task,pad_to,pad_outfits", [("FITB", 6, 4), ("GOR", 16, None)])
def test_prepare_batch_matches_jax(both, task, pad_to, pad_outfits):
    jpipe, pipe = both
    batch = _batch(_ragged())
    want = jpipe.prepare_batch(batch, task, jax.random.PRNGKey(3), pad_to=pad_to,
                               pad_outfits=pad_outfits)
    got = pipe.prepare_batch(batch, task, 3, pad_to=pad_to, pad_outfits=pad_outfits)
    for name in ("fill_uids", "fill_oids", "fill_cate", "full_cate", "olists", "valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in want.inputs._fields:
        a, b = getattr(got.inputs, name), np.asarray(getattr(want.inputs, name))
        assert tuple(a.shape) == b.shape, name
        if name == "init_latents":    # another generator: same shape, pads repeat the last
            init = a.numpy()
            np.testing.assert_array_equal(init[len(init) - 1], init[int(want.valid.sum()) - 1])
        elif name in ("cate_text", "null_text"):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_generate_batch_matches_jax_given_the_same_init_latents(both):
    jpipe, pipe = both
    batch = _batch(_ragged())
    want_prep = jpipe.prepare_batch(batch, "FITB", jax.random.PRNGKey(4), pad_to=4)
    prep = pipe.prepare_batch(batch, "FITB", 4, pad_to=4)
    prep.inputs = prep.inputs._replace(
        init_latents=torch.from_numpy(np.array(want_prep.inputs.init_latents)))
    want = jpipe.generate_batch(want_prep)
    got = pipe.generate_batch(prep)
    assert got.dtype == np.uint8 and got.shape == want.shape == (4, 64, 64, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2


def test_fill_noise_is_keyed_by_identity():
    a = fill_noise(123, [1, 2], [100, 101], [0, 3], (8, 8, 4))
    b = fill_noise(123, [2, 1], [101, 100], [3, 0], (8, 8, 4))
    np.testing.assert_array_equal(a[0], b[1])
    np.testing.assert_array_equal(a[1], b[0])
    assert not np.array_equal(a[0], fill_noise(124, [1], [100], [0], (8, 8, 4))[0])
    assert abs(float(a.std()) - 1.0) < 0.1


def _latents_by_identity(pipe, table, rows, bs, seed=123):
    out = {}
    for s in range(0, len(rows), bs):
        prep = pipe.prepare_batch(_batch(table, rows[s:s + bs]), "FITB", seed, pad_to=bs,
                                  pad_outfits=bs)
        lat = pipe.sample(prep).numpy()
        for k in np.flatnonzero(prep.valid):
            out[(int(prep.fill_uids[k]), int(prep.fill_oids[k]))] = lat[k]
    return out


def test_generation_invariant_to_batch_grouping(pipe):
    """At one batch shape the other rows cannot move a row's latents at all;
    across batch shapes they agree to the order of fp32 sums (1e-4, where
    other noise would differ by O(1))."""
    table = _table(4)
    a = _latents_by_identity(pipe, table, [0, 1, 2], 3)
    b = _latents_by_identity(pipe, table, [0, 2, 3], 3)
    shared = set(a) & set(b)
    assert len(shared) == 2
    for ident in shared:
        np.testing.assert_array_equal(a[ident], b[ident])
    c = _latents_by_identity(pipe, table, [0, 1, 2, 3], 1)
    full = _latents_by_identity(pipe, table, [0, 1, 2, 3], 3)
    assert set(c) == set(full) and len(c) == 4
    for ident in c:
        np.testing.assert_allclose(c[ident], full[ident], atol=1e-4, rtol=0)


# ---- run: manifests, skip, resume ------------------------------------------------

def test_run_manifests_and_jpeg_tree(pipe, tmp_path):
    from PIL import Image

    table = _table(4)
    grd = {int(o): {"outfits": table.outfits[i].tolist(), "category": table.category[i].tolist()}
           for i, o in enumerate(table.oids)}
    run_dir = pipe.run(table, "FITB", str(tmp_path), "FITB-ckpt-test", grd_dict=grd)
    man = np.load(run_dir + ".npy", allow_pickle=True).item()
    assert sum(len(v) for v in man.values()) == 4
    for by_oid in man.values():
        for rec in by_oid.values():
            assert len(rec["image_paths"]) == len(rec["cates"]) == 1
            assert np.asarray(Image.open(rec["image_paths"][0])).shape == (64, 64, 3)
            assert rec["full_cates"].shape == (4,) and (rec["outfits"] == 0).sum() == 1
    assert len(np.load(run_dir + "_grd.npy", allow_pickle=True).item()) == 4
    meta = json.load(open(run_dir + ".config.json"))
    assert meta["task"] == "FITB" and meta["seed"] == 123 and meta["n_rows"] == 4
    assert meta["generation"]["num_inference_steps"] == 2

    run_dir = pipe.run(_table(2), "GOR", str(tmp_path), "GOR-ckpt-test")
    for by_oid in np.load(run_dir + ".npy", allow_pickle=True).item().values():
        for rec in by_oid.values():
            assert len(rec["image_paths"]) == 4 and (rec["outfits"] == 0).all()
            grid = Image.open(os.path.join(os.path.dirname(rec["image_paths"][0]), "all.jpg"))
            assert grid.size == (128, 128)


def test_run_skips_a_complete_run(pipe, tmp_path):
    table = _table(2)
    d1 = pipe.run(table, "FITB", str(tmp_path), "FITB-again")
    mtime = os.path.getmtime(d1 + ".npy")
    assert pipe.run(table, "FITB", str(tmp_path), "FITB-again") == d1
    assert os.path.getmtime(d1 + ".npy") == mtime


def test_run_resumes_bit_identical(pipe, tmp_path):
    table = _table(5)          # batches of 3: 2 batches, the last ragged
    d1 = pipe.run(table, "FITB", str(tmp_path), "FITB-resume", max_batches=1)
    man = np.load(d1 + ".npy", allow_pickle=True).item()
    assert sum(len(v) for v in man.values()) == 3
    first = next(iter(next(iter(man.values())).values()))["image_paths"][0]
    mtime = os.path.getmtime(first)
    time.sleep(1.01)           # the mtime's resolution
    d2 = pipe.run(table, "FITB", str(tmp_path), "FITB-resume")
    man2 = np.load(d2 + ".npy", allow_pickle=True).item()
    assert d2 == d1 and sum(len(v) for v in man2.values()) == 5
    assert os.path.getmtime(first) == mtime           # batch 1 not generated again
    d3 = pipe.run(table, "FITB", str(tmp_path / "fresh"), "FITB-resume")
    for uid, by_oid in np.load(d3 + ".npy", allow_pickle=True).item().items():
        for oid, rec in by_oid.items():
            for a, b in zip(rec["image_paths"], man2[uid][oid]["image_paths"]):
                assert open(a, "rb").read() == open(b, "rb").read(), (a, b)


def test_merge_images_grid():
    imgs = np.zeros((4, 8, 8, 3), np.uint8)
    imgs[0] = 255
    grid = merge_images_grid(imgs)
    assert grid.shape == (16, 16, 3)
    assert (grid[:8, :8] == 255).all() and (grid[8:, 8:] == 0).all()
    grid3 = merge_images_grid(np.zeros((3, 8, 8, 3), np.uint8))
    assert grid3.shape == (16, 16, 3) and (grid3[8:, 8:] == 255).all()


# ---- the checkpoint store --------------------------------------------------------

def _train_state(tc=TrainConfig(), seed=0):
    model = create_difashion(Config.preset_tiny().model, seed=seed, device="cpu")
    step, init = build_train_step(model, tc)
    return model, init()


def _perturb(state, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for ts in [state.params, state.ema.params if state.ema else []] + [
                getattr(state.opt_state, f) for f in ckpt._OPT_LISTS[type(state.opt_state)]]:
            for t in ts:
                if t.is_floating_point():
                    t.add_(torch.randn(t.shape, generator=g))
                else:
                    t.copy_(torch.randint(-100, 100, t.shape, generator=g))
    state.opt_state.count, state.step = 5, 5
    if state.ema is not None:
        state.ema.step = 4


@pytest.mark.parametrize("use_8bit_adam", [False, True])
def test_checkpoint_roundtrip(tmp_path, use_8bit_adam):
    tc = TrainConfig(use_8bit_adam=use_8bit_adam)
    _, state = _train_state(tc)
    _perturb(state, 1)
    store = CheckpointStore(str(tmp_path))
    path = store.save(state, 5)
    assert sorted(os.listdir(path)) == ["ema.pt", "meta.json", "opt_state.pt", "trainable.pt"]
    assert json.load(open(os.path.join(path, "meta.json"))) == {"step": 5, "ema_step": 4}
    _, fresh = _train_state(tc, seed=1)
    back = store.load(fresh)
    assert back.step == 5 and back.ema.step == 4 and back.opt_state.count == 5
    assert back.params is fresh.params
    fields = ckpt._OPT_LISTS[type(state.opt_state)]
    for a, b in [(state.params, back.params), (state.ema.params, back.ema.params)] + [
            (getattr(state.opt_state, f), getattr(back.opt_state, f)) for f in fields]:
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="holds"):
        _, other = _train_state(TrainConfig(use_8bit_adam=not use_8bit_adam))
        store.load(other)


def test_checkpoint_retention_overwrite_and_stale_tmp(tmp_path):
    _, state = _train_state()
    store = CheckpointStore(str(tmp_path), total_limit=2)
    with pytest.raises(FileNotFoundError):
        store.load(state)
    os.makedirs(store.ckpt_path(3) + ".tmp")
    open(os.path.join(store.ckpt_path(3) + ".tmp", "stale.pt"), "w").close()
    for step in (1, 2, 3):
        state.step = step
        store.save(state, step)
    assert store.all_steps() == [2, 3] and store.latest_step() == 3
    assert "stale.pt" not in os.listdir(store.ckpt_path(3))
    state.step = 3
    with torch.no_grad():
        state.params[0].add_(1.0)
    store.save(state, 3)                       # the same step again: replaced
    _, fresh = _train_state(seed=2)
    assert torch.equal(store.load(fresh, 3).params[0], state.params[0])
    assert not [n for n in os.listdir(tmp_path) if n.endswith((".old", ".tmp"))]


def test_save_async_reraises_a_failed_write(tmp_path, monkeypatch):
    _, state = _train_state()
    store = CheckpointStore(str(tmp_path))
    store.save_async(state, 0)
    store.wait()
    assert store.all_steps() == [0]

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", broken)
    store.save_async(state, 1)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        store.wait()
    store.save_async(state, 2)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        store.save_async(state, 3)             # the next save joins and re-raises
    store.wait()


def test_checkpoint_ema_cases(tmp_path, caplog):
    _, with_ema = _train_state()
    _perturb(with_ema, 3)
    no_ema_tc = TrainConfig(use_ema=False, use_ema_fashion=False)
    _, without = _train_state(no_ema_tc)
    store_a, store_b = CheckpointStore(str(tmp_path / "a")), CheckpointStore(str(tmp_path / "b"))
    store_a.save(with_ema, 5)
    without.step = 7
    store_b.save(without, 7)
    # the checkpoint has EMA, the config wants it: restored
    _, t = _train_state(seed=4)
    assert torch.equal(store_a.load(t).ema.params[0], with_ema.ema.params[0])
    # the config wants EMA, the checkpoint has none: seeded from the params
    _, t = _train_state(seed=4)
    back = store_b.load(t)
    assert back.ema.step == 0 and torch.equal(back.ema.params[0], without.params[0])
    assert "seeding EMA" in caplog.text
    # the checkpoint has EMA, the config disables it: not restored
    _, t = _train_state(no_ema_tc, seed=4)
    assert store_a.load(t).ema is None and "disables EMA" in caplog.text


def _write_tiny_checkpoint(root, seed=0):
    """A store with one checkpoint whose EMA differs from its weights, and
    the frozen towers."""
    model, state = _train_state(seed=seed)
    _perturb(state, 5)
    store = CheckpointStore(str(root))
    store.save(state, 5)
    store.save_frozen({t: getattr(model, t).state_dict() for t in ("vae", "text_encoder")})
    return model, state


def test_load_model_for_inference(tmp_path):
    model, state = _write_tiny_checkpoint(tmp_path)
    cfg = Config.preset_tiny()
    loaded, step = load_model_for_inference(cfg, str(tmp_path), device="cpu")
    assert step == 5 and not loaded.training
    assert {p.dtype for p in loaded.parameters()} == {torch.bfloat16}   # the bf16 recipe
    named = dict(loaded.trainable_parameters())
    for name, e in zip(state.names, state.ema.params):
        assert torch.equal(named[name], e.to(torch.bfloat16)), name
    for key, value in model.vae.state_dict().items():
        assert torch.equal(loaded.vae.state_dict()[key], value.to(torch.bfloat16)), key
    no_ema, _ = load_model_for_inference(cfg, str(tmp_path), use_ema=False, device="cpu")
    assert torch.equal(dict(no_ema.trainable_parameters())[state.names[0]],
                       state.params[0].to(torch.bfloat16))


# ---- the service ---------------------------------------------------------------

@pytest.fixture(scope="module")
def service(pipe):
    return serve.GenerationService(pipe, max_batch=4)


def _req(n=2):
    rng = np.random.RandomState(1)
    outfits = rng.randint(1, 20, size=(n, 4))
    outfits[:, 0] = 0
    return {"task": "FITB", "uids": list(range(1, n + 1)), "oids": list(range(100, 100 + n)),
            "outfits": outfits.tolist(), "category": rng.randint(1, 6, size=(n, 4)).tolist(),
            "seed": 7}


def test_service_generate(service):
    prep, latents, imgs = service.generate_images(_req(2))
    assert imgs.dtype == np.uint8 and imgs.shape == (4, 64, 64, 3)     # padded to 4 fills
    assert latents.shape == (4, 8, 8, 4) and prep.valid.sum() == 2
    out = service.generate(_req(2))
    assert len(out["images"]) == 2 and out["latency_s"] > 0
    for imgs in out["images"].values():
        assert len(imgs) == 1 and base64.b64decode(imgs[0])[:2] == b"\xff\xd8"  # JPEG
    # a repeated request gives the same images
    assert np.array_equal(service.generate_images(_req(2))[2], service.generate_images(_req(2))[2])


def test_service_validates_requests(service):
    with pytest.raises(ValueError, match="too large"):
        service.generate(_req(9))
    bad = _req(2)
    bad["task"] = "gor"
    with pytest.raises(ValueError, match="task must be"):
        service.generate(bad)
    nofill = _req(2)
    nofill["outfits"] = [[1, 2, 3, 4], [5, 6, 7, 8]]
    with pytest.raises(ValueError, match="no slots to generate"):
        service.generate(nofill)
    multi = _req(4)
    multi["outfits"] = [[0, 0, 3, 4]] * 4      # 8 fills > the cap of 4
    with pytest.raises(ValueError, match="fill slots exceed"):
        service.generate(multi)


def _serve(service):
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, body: bytes, headers=None):
    r = urllib.request.Request(url + "/generate", data=body,
                               headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_roundtrip_and_error_classification(service):
    server, url = _serve(service)
    try:
        with urllib.request.urlopen(url + "/healthz") as r:
            assert json.loads(r.read()) == {"status": "ok", "devices": torch.cuda.device_count()}
        code, out = _post(url, json.dumps(_req(1)).encode())
        assert code == 200 and len(out["images"]) == 1
        assert _post(url, b"{}")[0] == 400
        assert _post(url, json.dumps({"task": "nope"}).encode())[0] == 400
        code, body = _post(url, b"not json at all")
        assert code == 400 and "bad request" in body["error"]
        code, _ = _post(url, b"{}", headers={"Content-Type": "application/json",
                                             "Content-Length": str(10 ** 9)})
        assert code == 400
        real = service.pipeline.prepare_batch
        service.pipeline.prepare_batch = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("device exploded"))
        try:
            code, body = _post(url, json.dumps(_req(1)).encode())
            assert code == 500 and "RuntimeError" in body["error"]
            assert "device exploded" not in body["error"]
        finally:
            service.pipeline.prepare_batch = real
    finally:
        server.shutdown()


def test_apply_generation_overrides():
    cfg = Config.preset_tiny()
    assert serve.apply_generation_overrides(cfg) is cfg
    out = serve.apply_generation_overrides(cfg, scheduler="dpmpp", num_inference_steps=20)
    assert out.generation.scheduler == "dpmpp" and out.generation.num_inference_steps == 20
    assert out.generation.category_guidance_scale == cfg.generation.category_guidance_scale
    assert cfg.generation.scheduler == "pndm"


def test_service_dpmpp_fast_mode(pipe):
    cfg = serve.apply_generation_overrides(pipe.config, scheduler="dpmpp", num_inference_steps=3)
    fast = GenerationPipeline(pipe.model, cfg, CATES, pipe.tokenizer, pipe.hist_store,
                              item_latents=pipe.item_latents)
    out = serve.GenerationService(fast, max_batch=4).generate(_req(2))
    assert len(out["images"]) == 2
    for imgs in out["images"].values():
        assert base64.b64decode(imgs[0])[:2] == b"\xff\xd8"


def _serve_args(**kw):
    args = dict(data_path="", ckpt_dir="", config=None, tiny=True, scheduler=None,
                num_inference_steps=None, max_batch=4, tokenizer_dir=None,
                allow_random_weights=False, device="cpu")
    return argparse.Namespace(**dict(args, **kw))


def test_serve_refuses_the_hash_tokenizer_without_override(tmp_path):
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        serve.build_service(_serve_args(data_path=str(tmp_path),
                                        ckpt_dir=str(tmp_path / "nope")))


# ---- the commands ---------------------------------------------------------------

def _dataset(root):
    os.makedirs(root, exist_ok=True)
    t = _table(2)
    table = {"uids": t.uids.tolist(), "oids": t.oids.tolist(), "outfits": t.outfits.tolist(),
             "category": t.category.tolist()}
    np.save(os.path.join(root, "fitb_test.npy"), np.array(table, dtype=object))
    np.save(os.path.join(root, "id_cate_dict.npy"), np.array(CATES, dtype=object))
    np.save(os.path.join(root, "test_history.npy"), np.array({1: {2: [3]}}, dtype=object))
    cfg = Config.preset_tiny()
    lat = _catalog(cfg) / cfg.model.vae.scaling_factor
    save_processed(str(root), "all_item_moments", mean=lat, logvar=np.zeros_like(lat))
    return t


def test_generate_and_serve_commands_on_the_cpu(tmp_path):
    from difashion_tpu_torch.__main__ import main

    data, ck, out = tmp_path / "data", tmp_path / "ckpt", tmp_path / "out"
    _dataset(str(data))
    _write_tiny_checkpoint(ck)
    common = ["--data_path", str(data), "--ckpt_dir", str(ck), "--tiny", "--device", "cpu",
              "--allow_random_weights", "--num_inference_steps", "2"]
    assert main(["generate", *common, "--output_dir", str(out)]) == 0
    name = run_name("FITB", 5, Config.preset_tiny())
    man = np.load(os.path.join(out, name + ".npy"), allow_pickle=True).item()
    assert sum(len(v) for v in man.values()) == 2

    # the service is built from the same arguments
    svc = serve.build_service(serve.parse_args(common + ["--max_batch", "2"]))
    assert svc.checkpoint_step == 5 and svc.generate_images(_req(1))[2].shape == (2, 64, 64, 3)

    proc = subprocess.Popen(
        [sys.executable, "-m", "difashion_tpu_torch", "serve", *common, "--port", "0",
         "--host", "127.0.0.1", "--max_batch", "2"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        deadline = time.time() + 120
        while "serving checkpoint-5" not in line and time.time() < deadline:
            line = proc.stderr.readline()
            assert line or proc.poll() is None, "the serve command exited"
        port = int(line.split("127.0.0.1:")[1].split()[0])
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        code, body = _post(url, json.dumps(_req(1)).encode())
        assert code == 200 and len(body["images"]) == 1
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()

"""The port's evaluation slice against the JAX package on the CPU: each tower
(tiny ViT and text towers, both Inceptions at 75 px, LPIPS at 64, the
compatibility net) fed the JAX exporters' weights through a weights
directory (`tools/export_eval_weights.py`), each wrapper of `Extractors`
against the JAX package's on the same numpy inputs, the preprocessing
resizes at the real sizes (512 -> 224 bicubic, 512 -> 299 bilinear) and at
upsamples, every metric of `eval/metrics.py`, the refusal without weights,
and `extract-features --stage clip` end to end against the JAX command.

Tolerances (fp32 on both sides, sums in another order): 2e-5 for the CLIP
towers, the compatibility net and the bilinear resize; 1e-4 for the CLIP
preprocessing (the resize's rounding divided by the CLIP std); 2e-4 for the Inceptions and
LPIPS (the JAX package's own exporter test's, `tests/test_eval_exporters.py`:
deep convolution stacks); 1e-6 relative for the metrics (the same numpy and
scipy code on the same features)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difashion_tpu.eval import extractors as jext
from difashion_tpu.eval import metrics as jmet
from difashion_tpu.eval.models import compat as jcompat
from difashion_tpu.eval.models import open_clip_vit as jvit
from difashion_tpu_torch.__main__ import main as port_main
from difashion_tpu_torch.eval import extractors as text
from difashion_tpu_torch.eval import metrics as tmet
from difashion_tpu_torch.eval.drivers import process_history_clip_embs
from difashion_tpu_torch.eval.models import compat as tcompat
from difashion_tpu_torch.eval.models import open_clip_vit as tvit

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "tools"))
from export_eval_weights import export_weights_dir  # noqa: E402

from test_torch_port_precompute import _dataset_dicts, _write_dataset  # noqa: E402

TOWER_TOL = dict(rtol=2e-5, atol=2e-5)
# the CLIP preprocessing's output is divided by the CLIP std (~0.27): the
# resize's fp32 rounding (~1e-5, weights computed in another order) grows ~4x
CLIP_PRE_TOL = dict(rtol=1e-4, atol=1e-4)
CONV_TOL = dict(rtol=2e-4, atol=2e-4)
METRIC_TOL = dict(rtol=1e-6, atol=1e-9)
NUM_CLASSES = 50   # the reference's category count, the commands' default


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("evalw"))
    export_weights_dir(out, tiny=True, seed=3, num_classes=NUM_CLASSES, n_merges=60)
    return out


@pytest.fixture(scope="module")
def both(weights_dir):
    """The JAX package's Extractors and the port's, from one weights directory."""
    jx = jext.build_extractors(weights_dir, num_classes=NUM_CLASSES, tiny=True,
                               allow_random=False, batch_size=4)
    tx = text.build_extractors(weights_dir, num_classes=NUM_CLASSES, tiny=True,
                               allow_random=False, batch_size=4, device="cpu")
    assert tx.random_towers == () and jx.random_towers == ()
    return jx, tx


def _images(n, h, w, seed=0):
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)


def test_state_dicts_are_the_exporters_keys_and_layouts(weights_dir, both):
    """Each tower's parameters are its source checkpoint's names and layouts:
    the exported files load strict (above) and state_dict() gives them back."""
    from difashion_tpu_torch.core.importer import load_state_dict

    _, tx = both
    towers = {"open_clip_vit_h14": tx.clip, "fid_inception": tx.fid_inception,
              "finetuned_inception": tx.inception, "vgg16": tx.lpips_net.vgg,
              "lpips_vgg": tx.lpips_net.heads, "ifashion_evaluator": tx.compat}
    for name, tower in towers.items():
        sd = load_state_dict(os.path.join(weights_dir, name + ".safetensors"))
        own = {k: v for k, v in tower.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        assert set(own) == set(sd), name
        for k, v in sd.items():
            assert torch.equal(own[k], v), (name, k)


@pytest.mark.parametrize("which", ["clip_image", "clip_text", "fid", "inception",
                                   "lpips", "compat"])
def test_wrappers_match_jax(both, which):
    jx, tx = both
    rng = np.random.RandomState(1)
    if which == "clip_image":
        imgs = _images(5, 40, 52)          # resized to 28 (tiny), cropped
        got, want, tol = tx.clip_image_embs(imgs), jx.clip_image_embs(imgs), TOWER_TOL
    elif which == "clip_text":
        texts = ["A photo of a pair of pants, on white background",
                 "A photo of a dress, on white background", "", "bag"]
        got, want, tol = tx.clip_text_embs(texts), jx.clip_text_embs(texts), TOWER_TOL
    elif which in ("fid", "inception"):
        imgs = _images(5, 90, 90, seed=2)  # resized to 75 (tiny)
        fn = "fid_features" if which == "fid" else "inception_probs"
        got, want, tol = getattr(tx, fn)(imgs), getattr(jx, fn)(imgs), CONV_TOL
    elif which == "lpips":
        a, b = _images(5, 80, 80, seed=3), _images(5, 64, 64, seed=4)
        got, want, tol = tx.lpips(a, b), jx.lpips(a, b), CONV_TOL
    else:
        feats = rng.randn(5, 4, 16).astype(np.float32)
        got, want, tol = tx.compat_scores(feats), jx.compat_scores(feats), TOWER_TOL
    assert got.shape == np.asarray(want).shape and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def test_towers_at_their_inputs_match_the_jax_modules(both):
    """The towers on already-preprocessed inputs (NHWC for JAX, NCHW here),
    without the wrappers' resizes: the image tower at 28 px, the causal text
    tower, the FID Inception at 75 px (average pools without the padding,
    Mixed_7c's max pool) and the finetuned one's softmax."""
    jx, tx = both
    rng = np.random.RandomState(5)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    img = rng.randn(2, 28, 28, 3).astype(np.float32)
    ids = rng.randint(0, 1000, (2, 77)).astype(np.int32)
    x = rng.uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    with torch.inference_mode():
        pairs = [(tx.clip.encode_image(nchw(img)), jx.clip_image_fn(jnp.asarray(img)), TOWER_TOL),
                 (tx.clip.encode_text(torch.from_numpy(ids).long()),
                  jx.clip_text_fn(jnp.asarray(ids)), TOWER_TOL),
                 (tx.fid_inception(nchw(x)), jx.fid_features_fn(jnp.asarray(x)), CONV_TOL),
                 (tx.inception(nchw(x)), jx.inception_probs_fn(jnp.asarray(x)), CONV_TOL)]
    for got, want, tol in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("case", ["clip_512_to_224", "clip_nonsquare", "clip_upsample",
                                  "bilinear_512_to_299", "bilinear_upsample"])
def test_resizes_match_jax_at_the_real_sizes(case):
    """preprocess_clip_image (bicubic) and _resize_bilinear against JAX: both
    antialias when they shrink (jax.image.resize does)."""
    shape = {"clip_512_to_224": (2, 512, 512), "clip_nonsquare": (2, 300, 512),
             "clip_upsample": (2, 100, 80), "bilinear_512_to_299": (2, 512, 512),
             "bilinear_upsample": (2, 64, 48)}[case]
    imgs = _images(*shape, seed=6)
    if case.startswith("clip"):
        want = jvit.preprocess_clip_image(imgs, size=224)
        got = tvit.preprocess_clip_image(imgs, size=224)
    else:
        want = jext._resize_bilinear(imgs, 299)
        got = text._resize_bilinear(imgs, 299)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **(CLIP_PRE_TOL if case.startswith("clip")
                                             else TOWER_TOL))


@pytest.mark.parametrize("mode,size", [("bilinear", 299), ("bicubic", 224)])
def test_the_torch_references_resize_without_antialias_differs(mode, size):
    """The original torch evaluation stack resizes with F.interpolate and no
    antialias; shrinking 512 px images that way is far from the JAX
    package's (and the port's) antialiased resize: a difference of the
    reference package (ROADMAP.md section 3), which the port does not take."""
    x = torch.from_numpy(_images(2, 512, 512, seed=6)).permute(0, 3, 1, 2)
    plain = torch.nn.functional.interpolate(x, size=(size, size), mode=mode,
                                            align_corners=False)
    aa = torch.nn.functional.interpolate(x, size=(size, size), mode=mode,
                                         align_corners=False, antialias=True)
    assert (plain - aa).abs().max() > 0.1


def _features(seed=7, n=40, d=12):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32), (rng.randn(n, d) * 1.3 + 0.2).astype(np.float32)


@pytest.mark.parametrize("metric", ["fid", "inception", "clip_score", "clip_image_score",
                                    "personalization_sim", "retrieval", "topn",
                                    "topn_grouped"])
def test_metrics_match_jax(metric):
    a, b = _features()
    rng = np.random.RandomState(8)
    if metric == "fid":
        got, want = tmet.fid_from_features(a, b), jmet.fid_from_features(a, b)
    elif metric == "inception":
        logits = rng.randn(30, NUM_CLASSES)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        labels = rng.randint(0, NUM_CLASSES, 30)
        got = tmet.inception_metrics(probs, labels, num_splits=3)
        want = jmet.inception_metrics(probs, labels, num_splits=3)
    elif metric == "clip_score":
        got, want = tmet.clip_score(a, b), jmet.clip_score(a, b)
    elif metric == "clip_image_score":
        got = [tmet.clip_image_score(a, b, f) for f in ("cosine", "euclidean")]
        want = [jmet.clip_image_score(a, b, f) for f in ("cosine", "euclidean")]
    elif metric == "personalization_sim":
        got, want = tmet.personalization_sim(a, b), jmet.personalization_sim(a, b)
    elif metric == "retrieval":
        cands = rng.randn(40, 5, 12).astype(np.float32)
        (got, gp), (want, wp) = tmet.retrieval_accuracy(a, cands), jmet.retrieval_accuracy(a, cands)
        np.testing.assert_array_equal(gp, wp)
    elif metric == "topn":
        iids = [rng.choice(200, 30, replace=False) for _ in range(40)]
        cands = [rng.randn(30, 12) for _ in range(40)]
        grd = [int(i[rng.randint(30)]) for i in iids]
        (gp, got), (wp, want) = (m.topn_recall(a, iids, cands, grd, (1, 5, 10))
                                 for m in (tmet, jmet))
        np.testing.assert_array_equal(gp, wp)
    else:
        feats = rng.randn(120, 12).astype(np.float32)
        pools = {c: list(range(1 + 40 * c, 40 + 40 * c)) for c in range(3)}
        cates = rng.randint(0, 3, 40)
        grd = [pools[c][rng.randint(39)] for c in cates]
        feats = np.concatenate([feats, rng.randn(10, 12).astype(np.float32)])
        (gp, got), (wp, want) = (m.topn_recall_grouped(a, cates, pools, feats, grd, (1, 5, 10))
                                 for m in (tmet, jmet))
        np.testing.assert_array_equal(gp, wp)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        got, want = [got[k] for k in sorted(want)], [want[k] for k in sorted(want)]
    np.testing.assert_allclose(got, want, **METRIC_TOL)


def test_gather_outfit_feats_matches_jax():
    rng = np.random.RandomState(9)
    feats, gen = rng.randn(20, 8).astype(np.float32), rng.randn(6, 8).astype(np.float32)
    outfits = np.array([[1, 2, 0, -3], [5, -1, -5, 7]])
    np.testing.assert_array_equal(tcompat.gather_outfit_feats(outfits, feats, gen),
                                  jcompat.gather_outfit_feats(outfits, feats, gen))
    with pytest.raises(ValueError, match="cnn_feats_gen is None"):
        tcompat.gather_outfit_feats(outfits, feats, None)


def test_build_extractors_refuses_without_weights(weights_dir, tmp_path, caplog):
    with pytest.raises(FileNotFoundError, match="Refusing"):
        text.build_extractors(None, tiny=True, allow_random=False, device="cpu")
    # a partial directory: the towers without a file are named, the others load
    import shutil

    part = tmp_path / "part"
    part.mkdir()
    for name in ("fid_inception", "ifashion_evaluator"):
        shutil.copy(os.path.join(weights_dir, name + ".safetensors"), part)
    X = text.build_extractors(str(part), tiny=True, device="cpu")
    assert X.random_towers == ("open_clip_vit_h14", "finetuned_inception", "vgg16",
                               "lpips_vgg")
    assert "meaningless" in caplog.text
    # the sources' extras that no tower has are left out before the strict load
    sd = {"logit_scale": torch.zeros(()), "visual.proj": torch.zeros(2)}
    assert text.open_clip_state(sd).keys() == {"visual.proj"}
    sd = {"model.Conv2d_1a_3x3.conv.weight": 1, "AuxLogits.fc.weight": 2, "fc.bias": 3}
    assert text.inception_state(sd, head=False).keys() == {"Conv2d_1a_3x3.conv.weight"}
    assert text.inception_state(sd, head=True).keys() == {"Conv2d_1a_3x3.conv.weight",
                                                          "fc.bias"}
    sd = {"lins.2.model.1.weight": 1, "lin0.model.1.weight": 2, "net.slice1.0.weight": 3}
    assert text.lpips_heads_state(sd).keys() == {"lin2.model.1.weight",
                                                 "lin0.model.1.weight"}


def _catalog(tmp_path, n_items=10):
    from PIL import Image

    rng = np.random.RandomState(7)
    data_dir, img_dir = tmp_path / "data", tmp_path / "imgs"
    _write_dataset(data_dir, _dataset_dicts(rng, n_items=n_items))
    img_dir.mkdir()
    names = []
    for i in range(n_items):
        arr = rng.randint(0, 255, size=(48 + 4 * i, 40, 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f"item{i}.png")
        names.append(f"item{i}.png")
    paths = tmp_path / "all_item_image_paths.npy"
    np.save(paths, np.array(names, dtype=object))
    return data_dir, img_dir, paths


def test_extract_features_clip_stage_matches_the_jax_command(weights_dir, tmp_path):
    from difashion_tpu.cli.extract_features import main as jax_main

    runs = {}
    for who in ("jax", "port"):
        data_dir, img_dir, paths = _catalog(tmp_path / who)
        args = ["--data_path", str(data_dir), "--img_folder_path", str(img_dir),
                "--image_paths_npy", str(paths), "--stage", "clip", "--tiny",
                "--weights_dir", weights_dir, "--clip_batch_size", "3"]
        os.makedirs(data_dir / "processed", exist_ok=True)
        if who == "jax":
            jax_main(args)
        else:
            assert port_main(["extract-features", *args, "--device", "cpu"]) == 0
        runs[who] = data_dir / "processed"
    feats = np.load(runs["port"] / "cnn_features_clip.npy")
    want = np.load(runs["jax"] / "cnn_features_clip.npy")
    assert feats.shape == want.shape == (10, 16) and feats.dtype == np.float32
    np.testing.assert_allclose(feats, want, **TOWER_TOL)
    for split in ("train", "test"):
        got = np.load(runs["port"] / f"{split}_history_clipembs.npy", allow_pickle=True).item()
        exp = np.load(runs["jax"] / f"{split}_history_clipembs.npy", allow_pickle=True).item()
        assert got.keys() == exp.keys()
        for uid in exp:
            assert got[uid].keys() == exp[uid].keys()
            for cid in exp[uid]:
                np.testing.assert_allclose(got[uid][cid], exp[uid][cid], **TOWER_TOL)
        assert got == {} or all(isinstance(v, dict) for v in got.values())
    # the history means are the catalog features' means
    hist = process_history_clip_embs({1: {2: [3, 4]}}, feats)
    np.testing.assert_allclose(hist[1][2], (feats[3] + feats[4]) / 2, rtol=1e-6)


# ---- the cascades and the evaluate command through the towers ------------------

@pytest.mark.parametrize("n,d", [(40, 12), (4, 64), (8, 96)])
def test_low_rank_fid_is_the_metric(n, d):
    from test_torch_port_eval_drivers import low_rank_fid

    rng = np.random.RandomState(n + d)
    a, b = rng.randn(n, d), rng.randn(n + 3, d) * 1.2 + 0.3
    np.testing.assert_allclose(low_rank_fid(a, b), tmet.fid_from_features(a, b), rtol=1e-6)


@pytest.fixture
def cheap_fid(monkeypatch):
    """Both packages' cascades compute FID by `low_rank_fid`."""
    from difashion_tpu.eval import drivers as jdrv
    from difashion_tpu_torch.eval import drivers as tdrv
    from test_torch_port_eval_drivers import low_rank_fid

    for drv in (jdrv, tdrv):
        monkeypatch.setattr(drv, "fid_from_features", low_rank_fid)


# The cascades over the exported tiny towers in each package: the CLIP scores,
# LPIPS, the Inception metrics and compat within CONV_TOL (2e-4: the towers'
# own tolerance; a mean of cosines or sigmoids does not magnify it). FID
# within 1e-3 relative and no absolute slack (the random FID tower's
# distances are ~1e-5 here): with 3-12 images against 2048 features the
# covariances have rank N - 1, and the distance is a difference of traces
# that nearly cancel, which magnifies the features' relative error; measured
# 2.6e-6.
FID_TOL = dict(rtol=1e-3, atol=0.0)


def _tower_ctx(pkg, X, items, cands):
    cnn = pkg.extract_catalog_clip_features(X, lambda i: items[i], len(items), batch_size=8)
    return pkg.EvalContext(
        extractors=X, id_cate_dict={c: f"cate{c}" for c in range(1, 6)},
        item_image_loader=lambda i: items[i], cnn_features_clip=cnn,
        history_clipembs=pkg.process_history_clip_embs({1: {1: [3, 4]}, 2: {2: [5]}}, cnn),
        retrieval_candidates=cands,
        cate_iid_dict={c: list(range(1, 30)) for c in range(1, 6)}, img_size=32)


def _assert_tower_results(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            assert got[k].keys() == w.keys()
            for kk in w:
                np.testing.assert_allclose(got[k][kk], w[kk], **CONV_TOL, err_msg=f"{k}.{kk}")
        else:
            assert type(got[k]) is type(w), k
            np.testing.assert_allclose(got[k], w, **(FID_TOL if k == "fid" else CONV_TOL),
                                       err_msg=k)


@pytest.mark.parametrize("task", ["FITB", "GOR"])
def test_cascades_through_the_towers_match_jax(both, task, tmp_path, cheap_fid):
    from difashion_tpu.eval import drivers as jdrv
    from difashion_tpu_torch.eval import drivers as tdrv
    from test_torch_port_eval_drivers import make_manifest

    jx, tx = both
    items = _images(30, 32, 32, seed=11)
    run, grd, cands = make_manifest(tmp_path, task)
    res = {}
    for pkg, X in ((jdrv, jx), (tdrv, tx)):
        cascade = pkg.evaluate_fitb if task == "FITB" else pkg.evaluate_gor
        res[pkg] = cascade(run, _tower_ctx(pkg, X, items, cands), grd,
                           out_path=str(tmp_path / f"{pkg.__name__}.npy"))
    _assert_tower_results(res[tdrv], res[jdrv])


def test_evaluate_command_matches_the_jax_command(weights_dir, tmp_path, cheap_fid):
    """`evaluate --tiny --device cpu` against the JAX package's `evaluate
    --tiny` over copies of one generated run (FITB, test split), with the
    same weights directory, catalog features and histories: the two results
    files. Then the port's command on the JAX command's file computes
    nothing."""
    import shutil

    from PIL import Image

    from difashion_tpu.cli.evaluate import main as jax_main
    from test_torch_port_eval_drivers import make_manifest

    data, imgs = tmp_path / "data", tmp_path / "imgs"
    imgs.mkdir()
    run, grd, cands = make_manifest(tmp_path / "gen", "FITB")
    _write_dataset(data, {"test_grd.npy": grd, "fitb_test_retrieval_candidates.npy": cands,
                          "valid_grd.npy": {900: grd[100]},
                          "id_cate_dict.npy": {c: f"cate{c}" for c in range(1, 6)},
                          "test_history.npy": {1: {1: [3, 4]}}})
    rng = np.random.RandomState(12)
    names = []
    for i in range(30):
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), dtype=np.uint8)).save(
            imgs / f"i{i}.png")
        names.append(f"i{i}.png")
    np.save(tmp_path / "paths.npy", np.array(names, dtype=object))
    np.save(tmp_path / "cnn.npy", rng.randn(30, 16).astype(np.float32))
    np.save(tmp_path / "hist.npy", np.array({1: {1: rng.randn(16).astype(np.float32)}},
                                            dtype=object))
    args = ["--data_path", str(data), "--task", "FITB", "--mode", "test", "--tiny",
            "--weights_dir", weights_dir, "--img_folder_path", str(imgs),
            "--image_paths_npy", str(tmp_path / "paths.npy"),
            "--cnn_features_npy", str(tmp_path / "cnn.npy"),
            "--hist_clipembs_npy", str(tmp_path / "hist.npy"), "--batch_size", "4"]
    results = {}
    for who in ("jax", "port"):
        gen = tmp_path / f"gen_{who}"
        shutil.copytree(tmp_path / "gen", gen)
        if who == "jax":
            jax_main(args + ["--gen_dir", str(gen)])
        else:
            assert port_main(["evaluate", *args, "--gen_dir", str(gen), "--device", "cpu"]) == 0
        results[who] = np.load(gen / "eval_results.npy", allow_pickle=True).item()
    assert list(results["port"]) == list(results["jax"]) == ["FITB-run"]
    _assert_tower_results(results["port"]["FITB-run"], results["jax"]["FITB-run"])
    # the JAX command's file, resumed by the port's command: nothing to compute
    from difashion_tpu_torch.eval import extractors as textr

    calls = []
    real = textr.Extractors.clip_image_embs
    textr.Extractors.clip_image_embs = lambda self, x: calls.append(len(x)) or real(self, x)
    try:
        port_main(["evaluate", *args, "--gen_dir", str(tmp_path / "gen_jax"),
                   "--device", "cpu"])
    finally:
        textr.Extractors.clip_image_embs = real
    assert calls == []
    # a run of the other split stops the command before a cascade runs
    with pytest.raises(SystemExit, match="other --mode"):
        port_main(["evaluate", *[a if a != "test" else "valid" for a in args],
                   "--gen_dir", str(tmp_path / "gen_port"), "--device", "cpu"])


# ---- the committed torch-oracle fixtures ----------------------------------------

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_oracles")


def _golden(name):
    with np.load(os.path.join(GOLDEN, name + ".npz")) as z:
        return {k: z[k] for k in z.files}


def test_compat_net_matches_the_torch_oracle():
    """`compat_evaluator.npz`: the reference's FashionEvaluator (cnn width 64)
    and its outputs on tests/test_eval.py's inputs; its state dict loads
    strict into the port's tower (the JAX test's tolerance)."""
    fix = _golden("compat_evaluator")
    net = tcompat.FashionEvaluator(64)
    net.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in fix.items()
                         if k.startswith("sd.")}, strict=True)
    x = np.random.RandomState(5).randn(3, 4, 64).astype(np.float32)
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, fix["ref"], rtol=1e-4, atol=1e-4)


def test_clip_image_tower_matches_the_hf_oracle():
    """`hf_clip_vision.npz`: transformers' CLIPVisionModel (width 64, 2
    layers, 4 heads, 28 px, exact GELU) and its pooled output; its weights
    renamed into open_clip's names (q / k / v stacked into in_proj) load
    strict into the port's image tower, with an identity projection (HF's
    pooler has none). The JAX test's tolerance."""
    fix = _golden("hf_clip_vision")
    sd = {k[len("sd.vision_model."):]: torch.from_numpy(v) for k, v in fix.items()
          if k.startswith("sd.")}
    ours = {"conv1.weight": sd["embeddings.patch_embedding.weight"],
            "class_embedding": sd["embeddings.class_embedding"],
            "positional_embedding": sd["embeddings.position_embedding.weight"],
            "proj": torch.eye(64)}
    for hf, oc in (("pre_layrnorm", "ln_pre"), ("post_layernorm", "ln_post")):
        for p in ("weight", "bias"):
            ours[f"{oc}.{p}"] = sd[f"{hf}.{p}"]
    for i in range(2):
        hf, oc = f"encoder.layers.{i}.", f"transformer.resblocks.{i}."
        for p in ("weight", "bias"):
            ours[f"{oc}attn.in_proj_{p}"] = torch.cat(
                [sd[f"{hf}self_attn.{x}_proj.{p}"] for x in "qkv"])
            for a, b in (("self_attn.out_proj", "attn.out_proj"), ("layer_norm1", "ln_1"),
                         ("layer_norm2", "ln_2"), ("mlp.fc1", "mlp.c_fc"),
                         ("mlp.fc2", "mlp.c_proj")):
                ours[f"{oc}{b}.{p}"] = sd[f"{hf}{a}.{p}"]
    tower = tvit.CLIPImageEncoder(tvit.ViTConfig(image_size=28, patch_size=14, width=64,
                                                 layers=2, heads=4, embed_dim=64))
    tower.load_state_dict(ours, strict=True)
    imgs = np.random.RandomState(2).randn(2, 28, 28, 3).astype(np.float32) * 0.5
    with torch.inference_mode():
        got = tower.eval()(torch.from_numpy(imgs).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, fix["ref"], rtol=3e-4, atol=3e-5)


def test_fid_resize_matches_the_torch_oracle():
    """`prim_fid_resize.npz`: F.interpolate bilinear (align_corners=False)
    from 64 x 48 to 299. An upsample, so the port's antialiasing changes
    nothing (tests/test_torch_parity.py's inputs and tolerance)."""
    x = np.random.RandomState(10).rand(2, 64, 48, 3).astype(np.float32)
    got = text._resize_bilinear(x, 299).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, _golden("prim_fid_resize")["ref"], rtol=1e-4, atol=1e-5)


def test_clip_scores_match_the_torch_cosine_oracle():
    """`metric_clip_cosine.npz`: 100 x the mean of torch's cosine similarity
    (tests/test_eval.py's inputs and tolerance)."""
    rng = np.random.RandomState(2)
    a, b = rng.randn(10, 32).astype(np.float32), rng.randn(10, 32).astype(np.float32)
    ref = float(_golden("metric_clip_cosine")["ref"])
    for fn in (tmet.clip_score, tmet.clip_image_score, tmet.personalization_sim):
        np.testing.assert_allclose(fn(a, b), ref, rtol=1e-5)

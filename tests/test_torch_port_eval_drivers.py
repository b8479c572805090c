"""The port's four metric cascades (`difashion_tpu_torch/eval/drivers.py`)
against the JAX package's on the CPU, with the towers held apart: one stub
extractor that both packages' cascades accept (its features are fixed numpy
functions of the images: fixed random projections of 4x4 pooled pixels), over
the same synthetic manifests and JPEGs, retrieval candidates, category pools
and histories. Then the resume rules on both sides: a cached run calls no
extractor and loads no image, the sink writes atomically, the null-history
fallback is counted into the results, a multi-blank FITB outfit scores each
image's own pointer, and a results file written by either package resumes in
the other.

Tolerance: 1e-6 relative (the same numpy and scipy metric code on the same
features; only the order of a few sums may differ). The results must also
carry the same keys with values of the same Python types, so that the files
interchange."""
import logging
import os
import zlib

import numpy as np
import pytest
import torch

from difashion_tpu.eval import drivers as jdrv
from difashion_tpu_torch.engine.pipeline import save_jpeg
from difashion_tpu_torch.eval import drivers as tdrv

IMG = 32
N_ITEMS = 30
D = 16                 # CLIP feature width of the stub
METRIC_TOL = dict(rtol=1e-6, atol=1e-9)
CASCADES = ("evaluate_fitb", "evaluate_gor", "evaluate_grounding_fitb",
            "evaluate_grounding_gor")
TASK = {"evaluate_fitb": "FITB", "evaluate_gor": "GOR", "evaluate_grounding_fitb": "FITB",
        "evaluate_grounding_gor": "GOR"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def low_rank_fid(f1, f2) -> float:
    """The Frechet distance of two feature sets in closed form for
    covariances of rank below the feature width: Tr sqrtm(S1 S2) is the sum
    of the singular values of A1 A2^T over sqrt((n1 - 1)(n2 - 1)), A the
    centered features (the nonzero eigenvalues of S1 S2 are those of the
    n1 x n1 product). The same number as `fid_from_features`, without
    scipy's sqrtm of the 2048 x 2048 product, which takes ~20 s a call on one
    core; `test_low_rank_fid_is_the_metric` holds the two together."""
    f1, f2 = np.asarray(f1, np.float64), np.asarray(f2, np.float64)
    a1, a2 = f1 - f1.mean(0), f2 - f2.mean(0)
    c1, c2 = len(f1) - 1, len(f2) - 1
    diff = f1.mean(0) - f2.mean(0)
    sv = np.linalg.svd(a1 @ a2.T, compute_uv=False)
    return float(diff @ diff + (a1 ** 2).sum() / c1 + (a2 ** 2).sum() / c2
                 - 2.0 * sv.sum() / np.sqrt(c1 * c2))


def _pooled(imgs):
    """[N, H, W, 3] -> [N, 48]: the means of a 4x4 grid of blocks."""
    imgs = np.asarray(imgs, np.float64)
    n, h, w, _ = imgs.shape
    return imgs.reshape(n, 4, h // 4, 4, w // 4, 3).mean(axis=(2, 4)).reshape(n, -1)


class StubExtractors:
    """What the cascades call of an `Extractors`, as fixed numpy functions of
    the images, with a count of the calls."""

    batch_size = 4

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        self.w_fid, self.w_cls = rng.randn(48, 8), rng.randn(48, 6)
        self.w_clip, self.w_compat = rng.randn(48, D), rng.randn(D)
        self.calls = 0

    def fid_features(self, imgs):
        self.calls += 1
        return (_pooled(imgs) @ self.w_fid).astype(np.float32)

    def inception_probs(self, imgs):
        self.calls += 1
        z = _pooled(imgs) @ self.w_cls
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)

    def clip_image_embs(self, imgs):
        self.calls += 1
        return (_pooled(imgs) @ self.w_clip).astype(np.float32)

    def clip_text_embs(self, texts):
        self.calls += 1
        return np.stack([np.random.RandomState(zlib.crc32(t.encode())).randn(D)
                         for t in texts]).astype(np.float32)

    def lpips(self, a, b):
        self.calls += 1
        return np.abs(_pooled(a) - _pooled(b)).mean(axis=1).astype(np.float32)

    def compat_scores(self, feats):
        self.calls += 1
        return 1.0 / (1.0 + np.exp(-(np.asarray(feats).mean(axis=1) @ self.w_compat)))


@pytest.fixture(scope="module")
def items():
    return np.random.RandomState(0).rand(N_ITEMS, IMG, IMG, 3).astype(np.float32)


def _ctx(pkg, items, X=None, **overrides):
    """The EvalContext of `pkg` (the JAX or the port's drivers module) over
    the catalog images `items`, with the stub's catalog features and the
    package's own history means."""
    X = X or StubExtractors()
    cnn = StubExtractors().clip_image_embs(items)
    kw = dict(extractors=X, id_cate_dict={c: f"cate{c}" for c in range(1, 6)},
              item_image_loader=lambda i: items[i], cnn_features_clip=cnn,
              history_clipembs=pkg.process_history_clip_embs({1: {1: [3, 4]}, 2: {2: [5]}},
                                                             cnn),
              retrieval_candidates=None,
              cate_iid_dict={c: list(range(1 + 5 * (c - 1), 6 + 5 * (c - 1)))
                             for c in range(1, 6)},
              img_size=IMG)
    kw.update(overrides)
    return pkg.EvalContext(**kw)


def make_manifest(root, task, n_outfits=3, seed=1):
    """JPEGs and a manifest as the pipeline writes them (the layout of
    tests/test_eval_drivers.py's); returns (run path, grd, candidates)."""
    rng = np.random.RandomState(seed)
    run = os.path.join(str(root), f"{task}-run")
    man, grd, cands = {}, {}, {}
    for i in range(n_outfits):
        uid, oid = i + 1, 100 + i
        n_gen = 1 if task == "FITB" else 4
        cates = [1 + (i + j) % 5 for j in range(n_gen)]
        full_cates = [1 + (i + j) % 5 for j in range(4)]
        outfits = np.asarray([1 + (i * 4 + j) % 20 for j in range(4)])
        paths = []
        for j in range(n_gen):
            p = os.path.join(run, "images", str(uid), str(oid), f"{j}.jpg")
            save_jpeg((rng.rand(IMG, IMG, 3) * 255).astype(np.uint8), p)
            paths.append(p)
        rec_outfits = outfits.copy()
        if task == "FITB":
            rec_outfits[0] = 0
        else:
            rec_outfits[:] = 0
        man.setdefault(uid, {})[oid] = {"cates": cates, "full_cates": np.asarray(full_cates),
                                        "outfits": rec_outfits, "image_paths": paths}
        grd[oid] = {"outfits": outfits.tolist(), "category": full_cates}
        cands.setdefault(uid, {})[oid] = [int(outfits[0]), 7, 8, 9, 10]
    np.save(run + ".npy", np.array(man, dtype=object))
    return run, grd, cands


def _run(pkg, cascade, run, items, grd, cands, out_path, X=None):
    ctx = _ctx(pkg, items, X, retrieval_candidates=cands)
    kw = {"topN": (1, 5, 10)} if cascade == "evaluate_grounding_gor" else {}
    return getattr(pkg, cascade)(run, ctx, grd, out_path=out_path, **kw), ctx


def assert_same_results(got, want):
    """The same keys, values of the same types, numbers within METRIC_TOL."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), (k, type(g), type(w))
        if isinstance(w, dict):
            assert_same_results(g, w)
        else:
            np.testing.assert_allclose(g, w, **METRIC_TOL, err_msg=k)


@pytest.mark.parametrize("cascade", CASCADES)
def test_cascade_matches_jax(cascade, items, tmp_path):
    run, grd, cands = make_manifest(tmp_path, TASK[cascade])
    got, tctx = _run(tdrv, cascade, run, items, grd, cands, str(tmp_path / "port.npy"))
    want, jctx = _run(jdrv, cascade, run, items, grd, cands, str(tmp_path / "jax.npy"))
    assert_same_results(got, want)
    assert tctx.hist_emb_fallbacks == jctx.hist_emb_fallbacks > 0
    # the files as written hold the same, under the run's name
    files = [np.load(tmp_path / f, allow_pickle=True).item() for f in ("port.npy", "jax.npy")]
    assert list(files[0]) == list(files[1]) == [os.path.basename(run)]
    assert_same_results(files[0][os.path.basename(run)], want)


@pytest.mark.parametrize("cascade", CASCADES)
def test_cached_run_calls_no_extractor(cascade, items, tmp_path, monkeypatch):
    """A second call over a fully evaluated run computes nothing: no tower,
    no image decoded (the manifest's or the catalog's)."""
    run, grd, cands = make_manifest(tmp_path, TASK[cascade])
    out = str(tmp_path / "res.npy")
    first, _ = _run(tdrv, cascade, run, items, grd, cands, out)
    loads = {"n": 0}
    real = tdrv.load_image01
    monkeypatch.setattr(tdrv, "load_image01",
                        lambda *a, **k: loads.__setitem__("n", loads["n"] + 1) or real(*a, **k))
    X = StubExtractors()
    ctx = _ctx(tdrv, items, X, retrieval_candidates=cands,
               item_image_loader=lambda i: loads.__setitem__("n", loads["n"] + 1) or items[i])
    kw = {"topN": (1, 5, 10)} if cascade == "evaluate_grounding_gor" else {}
    again = getattr(tdrv, cascade)(run, ctx, grd, out_path=out, **kw)
    assert X.calls == 0 and loads["n"] == 0
    assert again == first


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("cascade", CASCADES)
def test_results_file_resumes_across_packages(cascade, writer, items, tmp_path):
    """A results file written by one package's cascade resumes in the other's
    with no extractor call, and reads back the same metrics."""
    run, grd, cands = make_manifest(tmp_path, TASK[cascade])
    out = str(tmp_path / "res.npy")
    first, reader = (jdrv, tdrv) if writer == "jax" else (tdrv, jdrv)
    written, _ = _run(first, cascade, run, items, grd, cands, out)
    X = StubExtractors()
    again, _ = _run(reader, cascade, run, items, grd, cands, out, X=X)
    assert X.calls == 0
    assert_same_results(again, written)


def test_result_sink_atomic_write(tmp_path, monkeypatch):
    out = str(tmp_path / "eval_results.npy")
    sink = tdrv._ResultSink(out, "run-a")
    sink.put("fid", 1.25)
    assert not os.path.exists(out + ".tmp.npy")   # replaced, not left behind
    # the file is only ever replaced whole: a write that dies before the
    # rename leaves the earlier file as it was
    def dies(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tdrv.os, "replace", dies)
    with pytest.raises(OSError):
        sink.put("lpips", 0.5)
    monkeypatch.undo()
    again = tdrv._ResultSink(out, "run-a")
    assert again.results() == {"fid": 1.25}
    # the JAX package's sink reads it, and the port's reads the JAX one's
    assert jdrv._ResultSink(out, "run-a").results() == {"fid": 1.25}
    jout = str(tmp_path / "jax.npy")
    jdrv._ResultSink(jout, "run-b").put("is", {"acc": 0.5})
    assert tdrv._ResultSink(jout, "run-b").results() == {"is": {"acc": 0.5}}


def test_null_history_fallback_is_counted_logged_and_recorded(items, tmp_path, caplog):
    """The JAX package's divergence, kept: a missing (uid, cid) history uses
    the null image's embedding, WARNING-logged and counted, and the count
    lands beside personal_sim, equal to the JAX cascade's."""
    ctx = _ctx(tdrv, items)
    with caplog.at_level(logging.WARNING, logger="difashion_tpu_torch"):
        emb = ctx.hist_emb(999, 3)
    np.testing.assert_array_equal(emb, ctx.cnn_features_clip[0])
    assert ctx.hist_emb_fallbacks == 1 and any("null" in r.message for r in caplog.records)
    ctx.hist_emb(1, 1)                      # a present entry does not count
    assert ctx.hist_emb_fallbacks == 1
    with pytest.raises(KeyError):
        _ctx(tdrv, items, cnn_features_clip=None).hist_emb(999, 3)

    run, grd, _ = make_manifest(tmp_path, "FITB")
    man = np.load(run + ".npy", allow_pickle=True).item()
    np.save(run + ".npy", np.array({77: {o: r for by in man.values() for o, r in by.items()}},
                                   dtype=object))
    res = {pkg.__name__: pkg.evaluate_fitb(run, _ctx(pkg, items), grd,
                                           out_path=str(tmp_path / f"{i}.npy"))
           for i, pkg in enumerate((tdrv, jdrv))}
    got, want = res[tdrv.__name__], res[jdrv.__name__]
    assert got["personal_sim_null_fallbacks"] == want["personal_sim_null_fallbacks"] == 3
    assert type(got["personal_sim_null_fallbacks"]) is int


def test_multiblank_fitb_compat_uses_each_images_pointer(items, tmp_path, monkeypatch):
    """An outfit with two generated slots scores one compat row holding both
    generated images' pointers (0 -> the first, -1 -> the second), as the
    JAX cascade does."""
    rng = np.random.RandomState(3)
    run = os.path.join(str(tmp_path), "FITB-multiblank")
    paths = []
    for j in range(2):
        p = os.path.join(run, "images", "1", "100", f"{j}.jpg")
        save_jpeg((rng.rand(IMG, IMG, 3) * 255).astype(np.uint8), p)
        paths.append(p)
    np.save(run + ".npy", np.array({1: {100: {
        "cates": [1, 2], "full_cates": np.asarray([1, 2, 3, 4]),
        "outfits": np.asarray([0, 0, 5, 6]), "image_paths": paths}}}, dtype=object))
    grd = {100: {"outfits": [7, 8, 5, 6], "category": [1, 2, 3, 4]}}
    rows, res = {}, {}
    for pkg in (tdrv, jdrv):
        real = pkg.gather_outfit_feats

        def spy(outfits, cnn, gen, real=real, name=pkg.__name__):
            if gen is not None:               # the generated rows' gather
                rows[name] = np.asarray(outfits)
            return real(outfits, cnn, gen)

        monkeypatch.setattr(pkg, "gather_outfit_feats", spy)
        res[pkg.__name__] = pkg.evaluate_fitb(run, _ctx(pkg, items), grd,
                                              out_path=str(tmp_path / f"{pkg.__name__}.npy"))
    got = rows[tdrv.__name__]
    assert got.shape == (1, 4) and set(got[0][:2].tolist()) == {0, -1}
    np.testing.assert_array_equal(got, rows[jdrv.__name__])
    assert_same_results(res[tdrv.__name__], res[jdrv.__name__])


def test_streams_are_bounded_and_skip_when_nothing_is_wanted(items):
    """`stream_image_features` pushes chunks of `batch_size` images, loads
    nothing when no feature is wanted, and equals the JAX package's;
    `stream_lpips` likewise."""
    X = StubExtractors()
    seen = []
    loader = lambda i: seen.append(i) or items[i]
    assert tdrv.stream_image_features(X, loader, 10, []) == {} and seen == []
    got = tdrv.stream_image_features(X, loader, 10, ("fid", "probs", "clip"))
    want = jdrv.stream_image_features(StubExtractors(), lambda i: items[i], 10,
                                      ("fid", "probs", "clip"))
    assert X.calls == 3 * 3 and sorted(seen) == list(range(10))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        tdrv.stream_lpips(X, lambda i: items[i], lambda i: items[i + 10], 9, chunk=2),
        jdrv.stream_lpips(X, lambda i: items[i], lambda i: items[i + 10], 9, chunk=2))

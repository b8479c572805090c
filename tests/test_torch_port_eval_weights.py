"""The port's evaluation weights directory against the JAX tool, on the CPU at
the tiny sizes: `scripts/export_eval_weights_torch.py` (over
`eval/models/exporters.py::export_weights_dir`) against
`tools/export_eval_weights.py` for the same arguments (the same files, keys,
shapes and dtypes, the tokenizer files byte for byte), and the port's
directory loaded strict by both packages' `build_extractors`, whose
features agree.

Tolerances as in `test_torch_port_eval.py`: 2e-5 for CLIP and the
compatibility net, 2e-4 for the Inceptions and LPIPS (deep convolution
stacks summed in another order)."""
import importlib.util
import os
import sys

import numpy as np
import pytest
from safetensors.torch import load_file

from difashion_tpu.eval import extractors as jext
from difashion_tpu_torch.eval import extractors as text
from difashion_tpu_torch.eval.models.exporters import write_clip_vocab

from test_torch_port_models import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOWER_TOL = dict(rtol=2e-5, atol=2e-5)
CONV_TOL = dict(rtol=2e-4, atol=2e-4)
NUM_CLASSES = 50


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """The weights directory of `tools/export_eval_weights.py` and the port's,
    for the same arguments."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from export_eval_weights import export_weights_dir as jax_export

    root = tmp_path_factory.mktemp("evalw")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jax_export(jdir, tiny=True, seed=3, num_classes=NUM_CLASSES, n_merges=60)
    spec = importlib.util.spec_from_file_location(
        "export_eval_weights_torch",
        os.path.join(REPO, "scripts", "export_eval_weights_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    report = script.main(["--out", tdir, "--tiny", "--seed", "3", "--num_classes",
                          str(NUM_CLASSES), "--n_merges", "60"])
    return jdir, tdir, report


def test_eval_weights_dir_is_the_jax_tools(eval_dirs):
    """Same files; per file the same keys, shapes and dtypes; the tokenizer
    files byte for byte."""
    jdir, tdir, report = eval_dirs
    assert _files(tdir) == _files(jdir)
    assert sorted(report) == sorted(f for f in _files(jdir) if f.endswith(".safetensors"))
    for rel in report:
        got, want = load_file(os.path.join(tdir, rel)), load_file(os.path.join(jdir, rel))
        assert {k: (v.dtype, v.shape) for k, v in got.items()} == \
               {k: (v.dtype, v.shape) for k, v in want.items()}, rel
        assert report[rel]["bytes"] == os.path.getsize(os.path.join(tdir, rel))
    for rel in ("tokenizer/vocab.json", "tokenizer/merges.txt"):
        assert open(os.path.join(tdir, rel), "rb").read() == \
               open(os.path.join(jdir, rel), "rb").read()


@pytest.mark.parametrize("seed,n_merges", [(0, 200), (5, 17)])
def test_clip_vocab_is_the_jax_tools_byte_for_byte(tmp_path, seed, n_merges):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from export_eval_weights import write_clip_vocab as jax_vocab

    jax_vocab(str(tmp_path / "j"), n_merges=n_merges, seed=seed)
    write_clip_vocab(str(tmp_path / "t"), n_merges=n_merges, seed=seed)
    for f in ("vocab.json", "merges.txt"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


@pytest.fixture(scope="module")
def both_from_port_dir(eval_dirs):
    _, tdir, _ = eval_dirs
    jx = jext.build_extractors(tdir, num_classes=NUM_CLASSES, tiny=True, allow_random=False,
                               batch_size=4)
    tx = text.build_extractors(tdir, num_classes=NUM_CLASSES, tiny=True, allow_random=False,
                               batch_size=4, device="cpu")
    assert jx.random_towers == () and tx.random_towers == ()
    return jx, tx


@pytest.mark.parametrize("which", ["clip_image", "clip_text", "fid", "inception", "lpips",
                                   "compat"])
def test_port_weights_dir_loads_in_both_packages(both_from_port_dir, which):
    jx, tx = both_from_port_dir
    rng = np.random.RandomState(1)
    imgs = lambda n, h, seed: np.random.RandomState(seed).rand(n, h, h, 3).astype(np.float32)
    if which == "clip_image":
        x = imgs(5, 40, 0)
        got, want, tol = tx.clip_image_embs(x), jx.clip_image_embs(x), TOWER_TOL
    elif which == "clip_text":
        texts = ["A photo of a pair of pants, on white background", "", "bag"]
        got, want, tol = tx.clip_text_embs(texts), jx.clip_text_embs(texts), TOWER_TOL
    elif which in ("fid", "inception"):
        x = imgs(5, 90, 2)
        fn = "fid_features" if which == "fid" else "inception_probs"
        got, want, tol = getattr(tx, fn)(x), getattr(jx, fn)(x), CONV_TOL
    elif which == "lpips":
        got, want, tol = (tx.lpips(imgs(5, 80, 3), imgs(5, 64, 4)),
                          jx.lpips(imgs(5, 80, 3), imgs(5, 64, 4)), CONV_TOL)
    else:
        feats = rng.randn(5, 4, 16).astype(np.float32)
        got, want, tol = tx.compat_scores(feats), jx.compat_scores(feats), TOWER_TOL
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), **tol)

"""`scripts/learning_proof_cuda.py`, the port's mid-scale learning proof, on
the CPU: its fixture is `tests/test_learning_e2e.py`'s file for file, its
mid config is the JAX script's (`tools/learning_proof_tpu.py`), and a short
run at the tiny config through the port's train and generate commands
writes a report of the JAX script's structure, with the legs, launch counts
and runs the card's run is read by. The full tiny proof (300 steps, the
gates, then the four cascades over the learned generations) is the slow
test at the end."""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from difashion_tpu.core.config import Config as JaxConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


lp = _load("learning_proof_cuda", os.path.join(REPO, "scripts", "learning_proof_cuda.py"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("preset", ["tiny", "mid"])
def test_fixture_is_the_learning_tests_file_for_file(preset, tmp_path):
    from test_learning_e2e import N_ITEMS, OLEN, _write_dataset

    assert (lp.OLEN, lp.N_ITEMS) == (OLEN, N_ITEMS)
    if preset == "tiny":
        ours = lp.tiny_config("ckpt", 300)
        theirs = JaxConfig.preset_tiny()
    else:
        ours = lp.mid_config("ckpt", 64, 6000, 50)
        jmid = _load("learning_proof_tpu", os.path.join(TOOLS, "learning_proof_tpu.py"))
        theirs = jmid.mid_config("ckpt", 64, 6000, 50)
    got = lp.write_dataset(str(tmp_path / "port"), ours)
    want = _write_dataset(str(tmp_path / "jax"), theirs)
    np.testing.assert_array_equal(got, want)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax") and len(files) == 7
    for f in files:
        a, b = (np.load(tmp_path / w / f, allow_pickle=True) for w in ("port", "jax"))
        if f.endswith(".npz"):
            assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
        else:
            assert _same(a.item(), b.item()), f


def test_configs_are_the_jax_scripts_and_tests():
    """The mid config is `tools/learning_proof_tpu.py::mid_config`'s field for
    field, the tiny one `tests/test_learning_e2e.py::_fixture_config`'s (with
    its checkpoint at half the steps and the script's 2 GOR outfits a batch,
    the test's own values)."""
    from test_learning_e2e import _fixture_config

    jmid = _load("learning_proof_tpu", os.path.join(TOOLS, "learning_proof_tpu.py"))
    assert (dataclasses.asdict(lp.mid_config("out", 64, 6000, 50))
            == dataclasses.asdict(jmid.mid_config("out", 64, 6000, 50)))
    assert (dataclasses.asdict(lp.tiny_config("out", 300))
            == dataclasses.asdict(_fixture_config("out")))


def test_short_tiny_run_writes_the_report(tmp_path):
    """Four steps in two legs of two (the second resumed at step 2), the
    four generation runs (2-step PNDM), the gates (which a 4-step model
    fails: exit 1), and the report's keys; through `--plain_versions`, which
    on the CPU is the path every run takes."""
    report = tmp_path / "report.json"
    rc = lp.main(["--tiny", "--device", "cpu", "--steps", "4", "--inference_steps", "2",
                  "--report", str(report), "--workdir", str(tmp_path / "work"),
                  "--plain_versions"])
    r = json.loads(report.read_text())
    assert rc == (0 if r["all_gates_passed"] else 1)
    assert r["legs"] == [{"first_step": 0, "steps": 2, "end_step": 2},
                         {"first_step": 2, "steps": 2, "end_step": 4}]
    assert r["checkpoints"] == [2, 4]
    assert r["losses_finite"] and len(r["losses"]) == 2 and r["loss_windows_k"] == 1
    assert r["preset"]["config"] == "tiny" and r["preset"]["device"] == "cpu"
    assert r["preset"]["plain_versions"]
    launches = r["preset"]["launches"]
    # on the CPU every kernel's plain version runs: no launch, one count a step
    assert len(launches["per_train_step"]) == 1 and launches["train_steps"] == 4
    assert not any(launches["per_train_step"][0].values())
    # 3 forwards a batch (2-step PNDM); FITB 1 batch of 4 outfits, GOR 2 of 2
    assert launches["sampler_unet_forwards"] == 2 * (3 + 2 * 3)
    assert not r["preset"]["kernels_in_learned_path"]
    for name in ("FITB_ema", "FITB_raw", "GOR_ema", "GOR_raw"):
        run = r["runs"][name]
        assert run["jpegs_exist"] and run["images"] == (4 if name.startswith("FITB") else 16)
        assert run["run"].startswith(name.split("_")[0] + "-checkpoint-4-")
    for task, n in (("FITB", 4), ("GOR", 16)):
        assert r[task]["n_checked"] == n and set(r[task]["variants"]) == {"ema", "raw"}
        assert r[task]["passed"] == any(v["passed"] for v in r[task]["variants"].values())
        assert all(len(s["dists"]) == 4 for s in r[task]["slots"])
    assert {"train_wall_s", "generate_wall_s", "loss_first", "loss_last",
            "loss_fell"} <= set(r)


@pytest.mark.slow
def test_tiny_learning_proof_passes_and_the_cascades_run(tmp_path):
    """The tiny proof end to end through the port's commands: 300 steps, the
    reconstruction gates of tests/test_learning_e2e.py, then the four
    cascades over the learned generations with the tiny towers."""
    from difashion_tpu_torch.cli.generate import load_model_for_inference, run_name
    from difashion_tpu_torch.engine.generate import decode_to_uint8
    from difashion_tpu_torch.eval import drivers
    from difashion_tpu_torch.eval.extractors import build_extractors

    work = tmp_path / "work"
    report = tmp_path / "report.json"
    assert lp.main(["--tiny", "--device", "cpu", "--report", str(report),
                    "--workdir", str(work)]) == 0
    r = json.loads(report.read_text())
    assert r["loss_fell"] and r["FITB"]["passed"] and r["GOR"]["passed"]

    cfg = lp.tiny_config(str(work / "ckpt"), 300)
    model, step = load_model_for_inference(cfg, str(work / "ckpt"), device="cpu")
    latents = np.load(work / "data" / "processed" / "all_item_moments.npz")["mean"]
    with torch.inference_mode():
        imgs = decode_to_uint8(model, torch.from_numpy(
            latents * cfg.model.vae.scaling_factor)).numpy()
    loader = lambda i: imgs[i].astype(np.float32) / 255.0
    X = build_extractors(tiny=True, batch_size=4, device="cpu")
    cnn = drivers.extract_catalog_clip_features(X, loader, lp.N_ITEMS, batch_size=4)
    ctx = drivers.EvalContext(
        extractors=X, id_cate_dict={c: f"cate{c}" for c in range(1, 5)},
        item_image_loader=loader, cnn_features_clip=cnn,
        history_clipembs=drivers.process_history_clip_embs({1: {c: [c] for c in range(1, 5)}},
                                                           cnn),
        retrieval_candidates={1: {oid: [1 + (oid - 200), 2, 3, 4, 1]
                                  for oid in range(200, 204)}},
        cate_iid_dict={c: [c] for c in range(1, 5)}, img_size=imgs.shape[1])
    grd = np.load(work / "data" / "test_grd.npy", allow_pickle=True).item()
    for task, cascades in (("FITB", (drivers.evaluate_fitb, drivers.evaluate_grounding_fitb)),
                           ("GOR", (drivers.evaluate_gor, drivers.evaluate_grounding_gor))):
        run = os.path.join(str(work / "gen_ema"), run_name(task, step, cfg))
        for cascade in cascades:
            kw = {"topN": (1, 2)} if cascade is drivers.evaluate_grounding_gor else {}
            res = cascade(run, ctx, grd, **kw)
            for k in ("clip_score", "personal_sim", "compatibility"):
                assert np.isfinite(res[k]), (task, cascade.__name__, k)

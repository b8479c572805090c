"""The port's operator scripts on the CPU at the tiny sizes:
`scripts/train_soak_cuda.py --tiny` (the full recipe on the tiny preset,
three legs of the train command, the SIGKILL while stepping, the stale
`checkpoint-N.tmp`, continuity, the export and its bit-equal generation)
passes every gate, and a kill that misses fails the script;
`scripts/eval_scale_smoke_cuda.py --tiny` exits 0, and its synthetic data
directory is `tools/eval_scale_smoke.py::synth`'s for the same arguments,
file for file (the dictionaries equal, the JPEG bytes equal).

The children run with one intra-op thread each: the tiny steps gain
nothing from more and would contend with the other test workers."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOAK_STEPS = 24        # 12 steps a leg: leg 2 logs a row a step for 12 steps


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")


def test_train_soak_tiny_passes_every_gate(tmp_path, one_thread_children):
    soak = _load(os.path.join("scripts", "train_soak_cuda.py"), "train_soak_cuda")
    report_path = str(tmp_path / "report.json")
    rc = soak.main(["--tiny", "--steps", str(SOAK_STEPS),
                    "--console_every", "1", "--n_items", "200", "--gen_steps", "2",
                    "--workdir", str(tmp_path / "work"), "--report", report_path])
    with open(report_path) as f:
        r = json.load(f)
    half = SOAK_STEPS // 2
    assert rc == 0 and r["passed"]
    assert r["leg2_killed_while_stepping"]
    # the kill came after leg 2's first row past the half and before its end
    assert half < r["leg2_first_row_step"] <= r["leg2_kill_seen_at_step"] < SOAK_STEPS
    assert r["leg2_last_logged_step"] < SOAK_STEPS
    # leg 3 resumed from the half, not from the planted checkpoint-<steps>.tmp
    assert r["leg3_first_step"] == half and r["stale_tmp_ignored"]
    assert sorted(os.listdir(tmp_path / "work" / "ckpt")) == [
        f"checkpoint-{half}", f"checkpoint-{SOAK_STEPS}", "frozen.pt", "metrics.jsonl", "tb"]
    # the CPU is deterministic: the steps both legs logged agree bit for bit
    cont = r["continuity"]
    assert cont["steps_compared"] == list(range(half + 1, r["leg2_last_logged_step"] + 1))
    assert cont["max_abs_loss_diff"] == 0.0 and cont["max_abs_grad_norm_diff"] == 0.0
    assert r["all_losses_finite"] and r["update_skipped_total"] == 0.0
    assert r["steps_logged"] == [1, SOAK_STEPS]
    assert r["rows_per_leg"][0] == half and r["rows_per_leg"][2] == half
    assert r["leg_steps"] == [half, None, half]
    assert r["data"]["rows"] == 26_921 and r["data"]["users"] == 517
    assert r["reduced"] == {"n_items": "200 of 119000"}
    exp = r["export"]
    assert exp["step"] == SOAK_STEPS and exp["images_bit_equal"]
    assert sorted(exp["files"]) == sorted([
        "unet/diffusion_pytorch_model.safetensors",
        "fashion_encoder/diffusion_pytorch_model.safetensors",
        "vae/diffusion_pytorch_model.safetensors", "text_encoder/model.safetensors"])


def test_a_kill_that_misses_fails_the_soak(tmp_path):
    """Leg 2 ending before the kill, or logging no step past the half within
    the grace, stops the script: it never passes without the drill."""
    soak = _load(os.path.join("scripts", "train_soak_cuda.py"), "train_soak_cuda")
    metrics = str(tmp_path / "metrics.jsonl")
    ends = lambda _: [sys.executable, "-c", "pass"]
    with pytest.raises(SystemExit, match="before the kill"):
        soak.kill_while_stepping(ends, [], metrics, 0, 10, 3, grace=60)
    # rows up to the half only, then silence: the grace runs out
    with open(metrics, "w") as f:
        f.write("".join(json.dumps({"step": s, "loss": 1.0}) + "\n" for s in range(1, 11)))
    silent = lambda _: [sys.executable, "-c", "import time; time.sleep(30)"]
    with pytest.raises(SystemExit, match="no step past 10"):
        soak.kill_while_stepping(silent, [], metrics, 0, 10, 3, grace=1.0)


def test_rows_count_once_their_newline_is_written(tmp_path):
    soak = _load(os.path.join("scripts", "train_soak_cuda.py"), "train_soak_cuda")
    path = tmp_path / "metrics.jsonl"
    path.write_text('{"step": 1}\n{"step": 2}\n{"ste')
    assert soak.read_rows(str(path)) == [{"step": 1}, {"step": 2}]
    assert soak.read_rows(str(path), skip=1) == [{"step": 2}]


def _same(a, b, prefix_a, prefix_b):
    """Equal objects, with paths under prefix_a read under prefix_b."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k], prefix_a, prefix_b) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y, prefix_a, prefix_b) for x, y in zip(a, b))
    if isinstance(a, str):
        return a.replace(prefix_a, prefix_b) == b
    if isinstance(a, np.ndarray):
        if a.dtype == object:
            return _same(a.tolist(), b.tolist(), prefix_a, prefix_b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_eval_scale_smoke_tiny_on_the_jax_tools_data(tmp_path, one_thread_children):
    smoke = _load(os.path.join("scripts", "eval_scale_smoke_cuda.py"), "eval_scale_smoke_cuda")
    ours = str(tmp_path / "port")
    rc = smoke.main(["--tiny", "--n_outfits", "8", "--n_items", "40", "--img", "64",
                     "--out", ours])
    assert rc == 0
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from eval_scale_smoke import synth as jax_synth

    theirs = str(tmp_path / "jax")
    jax_synth(theirs, "FITB", 8, 40, 64, emb_dim=16)
    files = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)
                             for r, _, fs in os.walk(d) for f in fs)
    # less what the run wrote: the child's split and the results file
    got = [f for f in files(ours) if f not in ("split.json", os.path.join("gen",
                                                                          "eval_results.npy"))]
    assert got == files(theirs) and len(got) == 40 + 8 + 9
    for rel in got:
        a, b = os.path.join(ours, rel), os.path.join(theirs, rel)
        if rel.endswith(".jpg"):
            assert open(a, "rb").read() == open(b, "rb").read(), rel
        else:
            x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
            if x.dtype == object and x.shape == ():
                x, y = x.item(), y.item()
            assert _same(x, y, ours, theirs), rel

"""The port's `parity` command (`difashion_tpu_torch/cli/parity.py`) on the
CPU: the table's gates and the reference formats against the JAX package's
functions on the same inputs, the strict tokenizer and towers, and the
command end to end at the tiny sizes (`parity --tiny --device cpu
--allow_random_weights`: the port's generate, evaluate with the grounding
cascade, the table and its JSON), including a gated failure's exit."""
import json
import logging
import os

import numpy as np
import pytest
import torch

from difashion_tpu.cli import parity as jpar
from difashion_tpu_torch.__main__ import main as port_main
from difashion_tpu_torch.checkpoint import CheckpointStore
from difashion_tpu_torch.cli import parity as tpar
from difashion_tpu_torch.config import Config
from difashion_tpu_torch.data.precompute import save_processed
from difashion_tpu_torch.engine.train import build_train_step
from difashion_tpu_torch.eval.models.open_clip_vit import ViTConfig
from difashion_tpu_torch.models.difashion import FROZEN, create_difashion


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TABLE_CASES = {
    "gates": ({"fid": 10.0, "lpips": 0.50, "clip_score": 0.30, "extra": 1.0},
              {"fid": 10.1, "lpips": 0.60, "clip_score": 0.31}),
    "fid_only": ({"fid": 10.0, "lpips": 0.5}, {"fid": 10.1}),
    "gated_not_measured": ({"clip_score": 0.3}, {"fid": 10.0}),
    "unreadable_ours": ({"fid": {"not": "a number"}, "is": {"acc": 0.5}, "lpips": np.float32(2)},
                        {"fid": 1.0, "lpips": 2.0, "is": 3.0}),
    "numpy_values": ({"fid": np.float64(3.0), "lpips": np.array([0.2])},
                     {"fid": 3.06, "lpips": 0.2}),
    "no_reference": ({"fid": 1.0, "lpips": 0.1}, {}),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_parity_table_matches_jax(case):
    ours, ref = TABLE_CASES[case]
    got, want = tpar.parity_table(ours, ref), jpar.parity_table(ours, ref)
    assert got == want
    log = logging.getLogger("test_parity")
    assert tpar.print_table(got, log) == jpar.print_table(want, log)


def test_parity_table_gates():
    ours, ref = TABLE_CASES["gates"]
    rows = {r[0]: r for r in tpar.parity_table(ours, ref)}
    assert rows["fid"][4].startswith("PASS")          # 0.99 %
    assert rows["lpips"][4].startswith("FAIL")        # 16.7 %
    assert rows["clip_score"][4] == "reported"
    assert rows["extra"][4] == "no reference value"
    log = logging.getLogger("test_parity")
    assert tpar.print_table(tpar.parity_table(ours, {"fid": 10.1}), log) is True
    assert tpar.print_table(tpar.parity_table(ours, ref), log) is False
    # a gated metric the reference pins and we did not measure FAILs
    rows2 = {r[0]: r for r in tpar.parity_table({"clip_score": 0.3}, {"fid": 10.0})}
    assert rows2["fid"][4].startswith("FAIL")


def test_load_reference_results_matches_jax(tmp_path):
    j = tmp_path / "ref.json"
    j.write_text(json.dumps({"fid": 12.5, "lpips": 0.42}))
    n = tmp_path / "eval_results.npy"
    np.save(n, np.array({"FITB-checkpoint-15000": {
        "fid": np.float64(12.5), "is": {"acc": 0.5}, "lpips": np.array([0.25], np.float32),
        "personal_sim_null_fallbacks": 3}, "FITB-other": {"fid": 1.0}}, dtype=object))
    flat = tmp_path / "flat.npy"
    np.save(flat, np.array({"fid": 2.0, "note": "text"}, dtype=object))
    for path in (str(j), str(n), str(flat), None):
        assert tpar.load_reference_results(path) == jpar.load_reference_results(path)
    got = tpar.load_reference_results(str(n))
    assert got == {"fid": 12.5, "lpips": 0.25, "personal_sim_null_fallbacks": 3.0}
    assert tpar.load_reference_results(str(j)) == {"fid": 12.5, "lpips": 0.42}
    assert tpar.load_reference_results(None) == {}


def test_tokenizer_strict_refuses_hash_fallback(tmp_path):
    from difashion_tpu_torch.data.tokenizer import HashTokenizer, load_tokenizer

    with pytest.raises(FileNotFoundError, match="hash"):
        load_tokenizer(str(tmp_path), strict=True)
    assert isinstance(load_tokenizer(str(tmp_path), strict=False), HashTokenizer)


def test_extractors_refuse_random_towers(tmp_path):
    from difashion_tpu_torch.eval.extractors import build_extractors

    with pytest.raises(FileNotFoundError, match="random"):
        build_extractors(str(tmp_path), tiny=True, allow_random=False, device="cpu")
    X = build_extractors(str(tmp_path), tiny=True, allow_random=True, device="cpu")
    assert "fid_inception" in X.random_towers


N_ITEMS = 12


def write_parity_fixture(root, seed=5):
    """A tiny dataset for the test split (FITB table, ground truth, retrieval
    candidates, category pools, histories, the catalog's VAE moments), its
    64 px catalog images, catalog
    CLIP features at the tiny towers' width, and a checkpoint of a seeded
    tiny model with its frozen towers. Returns the command's common flags."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    data, imgs, ckpt = (os.path.join(str(root), d) for d in ("data", "imgs", "ckpt"))
    os.makedirs(os.path.join(data, "map"))
    os.makedirs(imgs)
    names = []
    for i in range(N_ITEMS):
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(
            os.path.join(imgs, f"i{i}.png"))
        names.append(f"i{i}.png")
    np.save(os.path.join(str(root), "paths.npy"), np.array(names, dtype=object))
    cates = [[1 + (i + j) % 4 for j in range(4)] for i in range(4)]
    outfits = [[1 + (3 * i + j) % (N_ITEMS - 1) for j in range(4)] for i in range(4)]
    fitb = [[0] + o[1:] for o in outfits]
    save = lambda name, obj: np.save(os.path.join(data, name), np.array(obj, dtype=object))
    save("fitb_test.npy", {"uids": [1, 2, 1, 2], "oids": [100, 101, 102, 103],
                           "outfits": fitb, "category": cates})
    save("test_grd.npy", {100 + i: {"outfits": outfits[i], "category": cates[i]}
                          for i in range(4)})
    save("fitb_test_retrieval_candidates.npy",
         {u: {100 + i: [outfits[i][0], 7, 8, 9, 10] for i in range(4) if [1, 2, 1, 2][i] == u}
          for u in (1, 2)})
    save(os.path.join("map", "cate_iid_dict.npy"),
         {c: list(range(1 + 2 * (c - 1), 5 + 2 * (c - 1))) for c in range(1, 5)})
    save("test_history.npy", {1: {2: [3]}})
    save("id_cate_dict.npy", {c: f"cate{c}" for c in range(1, 5)})
    np.save(os.path.join(str(root), "cnn.npy"),
            rng.rand(N_ITEMS, ViTConfig.tiny().embed_dim).astype(np.float32))

    cfg = Config.preset_tiny()
    s, C = cfg.model.unet.sample_size, cfg.model.vae.latent_channels
    save_processed(data, "all_item_moments",
                   mean=rng.randn(N_ITEMS, s, s, C).astype(np.float32),
                   logvar=np.full((N_ITEMS, s, s, C), -4.0, np.float32))
    model = create_difashion(cfg.model, seed=3, device="cpu")
    _, init = build_train_step(model, cfg.train)
    store = CheckpointStore(ckpt)
    store.save(init(), 0)
    store.save_frozen({t: getattr(model, t).state_dict() for t in FROZEN})
    return ["--data_path", data, "--ckpt_dir", ckpt, "--img_folder_path", imgs,
            "--image_paths_npy", os.path.join(str(root), "paths.npy"),
            "--cnn_features_npy", os.path.join(str(root), "cnn.npy"),
            "--weights_dir", os.path.join(str(root), "no_weights"), "--mode", "test",
            "--tiny", "--device", "cpu"]


def test_parity_command_end_to_end(tmp_path, monkeypatch):
    """FID through `low_rank_fid` (scipy's `sqrtm` of the tiny towers'
    2048 x 2048 product takes ~20 s a call here; the closed form is held to
    the metric in tests/test_torch_port_eval.py)."""
    from difashion_tpu_torch.eval import drivers
    from test_torch_port_eval_drivers import low_rank_fid

    monkeypatch.setattr(drivers, "fid_from_features", low_rank_fid)
    common = write_parity_fixture(tmp_path)
    out = str(tmp_path / "out")
    # strict without --allow_random_weights: the hash tokenizer is refused
    with pytest.raises(FileNotFoundError):
        port_main(["parity", *common, "--out_dir", str(tmp_path / "refused")])

    args = ["parity", *common, "--out_dir", out, "--allow_random_weights", "--grounding"]
    assert port_main(args) == 0
    with open(os.path.join(out, "parity_table.json")) as f:
        table = json.load(f)
    results = np.load(os.path.join(out, "eval_results.npy"), allow_pickle=True).item()
    grounding = np.load(os.path.join(out, "eval_results_grounding.npy"),
                        allow_pickle=True).item()
    (run, ours), = results.items()
    assert table["run"] == run and run.startswith("FITB-checkpoint-0-")
    assert table["ok"] and table["gated"] == ["fid", "lpips"] and table["gate_pct"] == 2.0
    rows = {r["metric"]: r for r in table["rows"]}
    want = set(ours) | {f"grounding_{k}" for k in grounding[run]}
    assert set(rows) == want
    assert {"fid", "lpips", "clip_score", "compatibility", "grounding_retrieval_acc",
            "grounding_compatibility"} <= want
    assert all(r["gate"] == "no reference value" for r in rows.values())
    assert rows["fid"]["ours"] == pytest.approx(float(ours["fid"]))
    assert np.isfinite(ours["fid"]) and np.isfinite(ours["lpips"])

    # the run's own numbers as the reference: every gate passes at 0 %
    ref = tmp_path / "ref.npy"
    np.save(ref, np.array({"ref": ours}, dtype=object))
    assert port_main(args + ["--reference_results", str(ref)]) == 0
    with open(os.path.join(out, "parity_table.json")) as f:
        rows = {r["metric"]: r for r in json.load(f)["rows"]}
    assert rows["fid"]["delta_pct"] == 0.0 and rows["fid"]["gate"].startswith("PASS")
    assert rows["lpips"]["gate"].startswith("PASS")
    # FID 5 % off: the gated failure exits non-zero, and the table says so
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"fid": float(ours["fid"]) * 1.05, "lpips": ours["lpips"]}))
    with pytest.raises(SystemExit, match="parity FAILED"):
        port_main(args + ["--reference_results", str(bad)])
    with open(os.path.join(out, "parity_table.json")) as f:
        failed = json.load(f)
    assert not failed["ok"]
    assert {r["metric"]: r["gate"] for r in failed["rows"]}["fid"].startswith("FAIL")
    # evaluate on a split without ground truth stops before any tower is built
    i = common.index("--ckpt_dir")
    evaluate = common[:i] + common[i + 2:]
    with pytest.raises(SystemExit, match="no valid_grd.npy"):
        port_main(["evaluate", *evaluate, "--gen_dir", out, "--mode", "valid"])
    # a reference with no usable number is refused
    junk = tmp_path / "junk.npy"
    np.save(junk, np.array({"run": {"fid": {"not": "a number"}}}, dtype=object))
    with pytest.raises(SystemExit, match="no usable"):
        port_main(args + ["--reference_results", str(junk)])

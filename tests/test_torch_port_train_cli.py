"""The port's training driver on the CPU at the tiny config, against the JAX
package where it has a counterpart: `TrainLoader`, `assemble_batch`, the
TensorBoard event files (byte for byte), `MetricLogger`, the memory
accounting (`engine/memory.py`, planned on the meta device) and `info`; then
`python -m difashion_tpu_torch train --tiny --device cpu` end to end:
checkpoints and their pruning, resume from the latest (the restored state
bit for bit, the next step's number), an explicit missing step failing, the
validation samples, and the first-run precompute from PNGs with
`--from_images`. No JAX train step is compiled here; the JAX accounting is a
trace (`jax.eval_shape`)."""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from difashion_tpu.cli import train as jtrain
from difashion_tpu.core import config as jcfg
from difashion_tpu.core import tensorboard as jtb
from difashion_tpu.data import datasets as jdatasets
from difashion_tpu.engine import memory as jmemory
from difashion_tpu.engine.train import zero1_shard_axis as jax_zero1_shard_axis
from difashion_tpu_torch import config as tcfg
from difashion_tpu_torch.__main__ import main as port_main
from difashion_tpu_torch.checkpoint import CheckpointStore
from difashion_tpu_torch.cli import info as tinfo
from difashion_tpu_torch.cli import train as ttrain
from difashion_tpu_torch.core import logging as tlogging
from difashion_tpu_torch.core import tensorboard as ttb
from difashion_tpu_torch.data import datasets as tdatasets
from difashion_tpu_torch.data import precompute as tpre
from difashion_tpu_torch.data.preprocessing import to_model_input
from difashion_tpu_torch.engine import memory as tmemory
from difashion_tpu_torch.engine.train import AdamState, EMAState, TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATES = {1: "pants", 2: "shoes", 3: "earrings", 4: "t-shirt", 5: "bag"}
N_ITEMS = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(rng, n_rows, blank=False):
    outfits = rng.randint(1, N_ITEMS, (n_rows, 4))
    if blank:
        outfits[:, 0] = 0
    return {"uids": list(rng.randint(1, 4, n_rows)), "oids": list(range(100, 100 + n_rows)),
            "outfits": [list(o) for o in outfits],
            "category": [list(c) for c in rng.randint(1, 6, (n_rows, 4))]}


def write_dataset(path, seed=0, n_rows=6, moments=True):
    """A synthetic dataset in the reference's schema: the train table, a
    valid FITB table (one blank slot a row), histories, the category names
    and (with `moments`) the catalog's moments at the tiny latent size."""
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    hist = {1: {2: [3, 4], 5: []}, 2: {1: [7]}}
    files = {"train.npy": _table(rng, n_rows), "fitb_valid.npy": _table(rng, 2, blank=True),
             "train_history.npy": hist, "valid_history.npy": hist,
             "id_cate_dict.npy": dict(CATES)}
    for name, d in files.items():
        np.save(os.path.join(path, name), np.array(d, dtype=object))
    if moments:
        tpre.save_processed(str(path), "all_item_moments",
                            mean=rng.randn(N_ITEMS, 8, 8, 4).astype(np.float32),
                            logvar=rng.uniform(-8, -2, (N_ITEMS, 8, 8, 4)).astype(np.float32))
    return str(path)


def write_config(path, **train):
    cfg = tcfg.Config.preset_tiny()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return str(path)


def _train(data, out, *extra):
    return port_main(["train", "--tiny", "--device", "cpu", "--data_path", data,
                      "--output_dir", out, *extra])


def _run(data, out, *extra):
    """cli/train.py::main's (state, model)."""
    return ttrain.main(["--tiny", "--device", "cpu", "--data_path", data, "--output_dir",
                        out, *extra])


def state_tensors(state):
    return {"params": state.params, "mu": state.opt_state.mu, "nu": state.opt_state.nu,
            "ema": state.ema.params}


def fresh_template(state):
    return TrainState(names=list(state.names),
                      params=[torch.empty_like(p) for p in state.params],
                      opt_state=AdamState(0, [torch.empty_like(t) for t in state.opt_state.mu],
                                          [torch.empty_like(t) for t in state.opt_state.nu]),
                      ema=EMAState([torch.empty_like(t) for t in state.ema.params], 0))


def assert_states_equal(a, b):
    assert a.names == b.names and a.step == b.step
    assert a.opt_state.count == b.opt_state.count and a.ema.step == b.ema.step
    for field, tensors in state_tensors(a).items():
        for name, x, y in zip(a.names, tensors, state_tensors(b)[field]):
            assert torch.equal(x, y), f"{field} {name}"


# ---- TrainLoader, assemble_batch --------------------------------------------


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, True)])
def test_train_loader_matches_jax_across_epochs(shuffle, drop_last):
    t = tdatasets.OutfitTable.from_dict(_table(np.random.RandomState(1), 11))
    jt = jdatasets.OutfitTable(t.uids, t.oids, t.outfits, t.category)
    ours = tdatasets.TrainLoader(t, 3, seed=9, shuffle=shuffle, drop_last=drop_last)
    theirs = jdatasets.TrainLoader(jt, 3, seed=9, shuffle=shuffle, drop_last=drop_last)
    assert ours.steps_per_epoch() == theirs.steps_per_epoch() == (3 if drop_last else 4)
    # three epochs, asked out of order as a resumed run does
    for step in [7, 0, 1, 2, 3, 4, 5, 6, 8, 11, 10, 9]:
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for field in ("uids", "oids", "outfits", "category"):
            np.testing.assert_array_equal(a[field], b[field])
    for loader in (tdatasets.TrainLoader(t, 12), jdatasets.TrainLoader(jt, 12)):
        with pytest.raises(ValueError, match="no full batch"):
            loader.batch_at(0)


def _batch_inputs(rng):
    t = tdatasets.OutfitTable.from_dict(_table(rng, 5))
    loader = tdatasets.TrainLoader(t, 3, seed=4)
    lat = rng.randn(N_ITEMS, 8, 8, 4).astype(np.float32)
    hist = {1: {2: [3, 4]}, 3: {5: [1]}}
    stores = (tdatasets.HistLatentStore.from_catalog(hist, lat),
              jdatasets.HistLatentStore.from_catalog(hist, lat))
    cids = sorted(CATES)
    ids_table = rng.randint(0, 1000, (len(cids), 77))
    return loader, lat, rng.uniform(-8, -2, lat.shape).astype(np.float32), ids_table, \
        {c: i for i, c in enumerate(cids)}, stores


def _same_batch(got, want):
    for field in ("images", "latent_mean", "latent_logvar", "input_ids", "hist_latents"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=field)


def test_assemble_batch_matches_jax_with_moments():
    loader, mean, logvar, ids_table, cid_row, (store, jstore) = _batch_inputs(
        np.random.RandomState(2))
    for step in (0, 1, 2):
        b = loader.batch_at(step)
        got = ttrain.assemble_batch(b, mean, logvar, ids_table, cid_row, store, 0.18,
                                    device="cpu")
        want = jtrain.assemble_batch(b, mean, logvar, ids_table, cid_row, jstore, 0.18)
        assert got.input_ids.dtype == torch.int32 and got.latent_mean.shape == (3, 4, 8, 8, 4)
        _same_batch(got, want)


def test_assemble_batch_matches_jax_with_an_image_loader():
    from PIL import Image

    rng = np.random.RandomState(3)
    loader, _, _, ids_table, cid_row, (store, jstore) = _batch_inputs(rng)
    pics = [Image.fromarray(rng.randint(0, 255, (40 + i % 3 * 7, 32 + i % 2 * 9, 3),
                                        dtype=np.uint8)) for i in range(N_ITEMS)]
    image_loader = lambda iid, r: to_model_input(pics[iid], size=32, crop="random", rng=r)
    ours, theirs = np.random.RandomState(124), np.random.RandomState(124)
    for step in (0, 1):
        b = loader.batch_at(step)
        got = ttrain.assemble_batch(b, None, None, ids_table, cid_row, store, 0.18,
                                    image_loader=image_loader, np_rng=ours, device="cpu")
        want = jtrain.assemble_batch(b, None, None, ids_table, cid_row, jstore, 0.18,
                                     image_loader=image_loader, np_rng=theirs)
        assert got.images.shape == (3, 4, 32, 32, 3)
        _same_batch(got, want)


# ---- TensorBoard, MetricLogger --------------------------------------------


def _write_events(module, log_dir, image):
    w = module.TBEventWriter(log_dir)
    w.add_scalars(1, {"loss": 0.25, "grad_norm": 3.5}, wall_time=1000.5)
    w.add_scalar("lr", 1e-5, 2)
    w.add_scalars(2**40, {"loss": float("nan")}, wall_time=1001.0)
    w.add_image("validation/grid", image, 3, wall_time=1002.0)
    w.add_image("gray", image[..., 0], 4)
    w.close()
    return w.path


def test_tensorboard_file_is_byte_for_byte_the_jax_writers(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1792242000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    image = np.random.RandomState(5).randint(0, 255, (6, 10, 3), dtype=np.uint8)
    ours = _write_events(ttb, str(tmp_path / "ours"), image)
    theirs = _write_events(jtb, str(tmp_path / "theirs"), image)
    assert os.path.basename(ours) == os.path.basename(theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file
    for path in (ours, theirs):
        mine, other = list(ttb.read_events(path)), list(jtb.read_events(path))
        assert len(mine) == 6
        assert repr(mine) == repr(other)
    ev = list(ttb.read_events(theirs))
    assert ev[0]["file_version"] == "brain.Event:2"
    assert ev[1]["step"] == 1 and ev[1]["wall_time"] == 1000.5
    assert ev[1]["scalars"] == {"loss": 0.25, "grad_norm": 3.5}
    assert ev[3]["step"] == 2**40 and np.isnan(ev[3]["scalars"]["loss"])
    img = ev[4]["images"]["validation/grid"]
    assert (img["height"], img["width"], img["colorspace"]) == (6, 10, 3)
    assert ev[5]["images"]["gray"]["colorspace"] == 1
    assert ttb.crc32c(b"123456789") == jtb.crc32c(b"123456789") == 0xE3069283
    corrupt = tmp_path / "corrupt"
    raw = bytearray(open(ours, "rb").read())
    raw[-1] ^= 1   # the last record's data CRC
    corrupt.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        list(ttb.read_events(str(corrupt)))
    assert len(list(ttb.read_events(str(corrupt), verify_crc=False))) == 6
    with pytest.raises(TypeError, match="uint8"):
        ttb.TBEventWriter(str(tmp_path / "x")).add_image("f", image.astype(np.float32), 0)


def test_metric_logger_jsonl_tensorboard_and_missing_tracker(tmp_path, monkeypatch, caplog):
    import io

    from PIL import Image

    monkeypatch.setitem(sys.modules, "wandb", None)   # import wandb raises ImportError
    logger = tlogging.MetricLogger(str(tmp_path), console_every=2,
                                   report_to=("tensorboard", "wandb"))
    assert logger.active_trackers == ["tensorboard"]
    assert "tracker 'wandb' requested" in caplog.text
    losses = {1: 0.5, 2: 0.25, 3: np.float32(0.125)}
    for step, loss in losses.items():
        logger.log(step, loss=loss, grad_norm=torch.tensor(2.0), note="x")
    image = np.random.RandomState(6).randint(0, 255, (8, 12, 3), dtype=np.uint8)
    logger.log_image(3, "validation/fitb_samples", image)
    logger.close()
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 3, 3]
    assert recs[2]["loss"] == 0.125 and recs[0]["grad_norm"] == 2.0 and recs[0]["note"] == "x"
    assert recs[3]["image"] == "validation/fitb_samples"
    (tb_file,) = os.listdir(tmp_path / "tb")
    events = list(ttb.read_events(str(tmp_path / "tb" / tb_file)))
    scalars = [e for e in events if e.get("scalars")]
    assert [e["step"] for e in scalars] == [1, 2, 3]
    for e, r in zip(scalars, recs):
        assert e["scalars"] == {"loss": r["loss"], "grad_norm": 2.0}
        assert e["wall_time"] == r["time"]
    (png,) = [e["images"]["validation/fitb_samples"]["png"] for e in events if e["images"]]
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), image)
    with pytest.raises(ValueError, match="unknown tracker"):
        tlogging.MetricLogger(str(tmp_path / "y"), report_to=("mlflow",))
    timer = tlogging.StepTimer(n_chips=2)
    timer.start()
    t = timer.stop(8)
    assert t["step_time_s"] > 0 and t["images_per_sec_per_chip"] == pytest.approx(
        8 / t["step_time_s"] / 2)


# ---- memory accounting, info -----------------------------------------------


@pytest.mark.parametrize("adam8bit", [False, True])
@pytest.mark.parametrize("ema", [True, False])
def test_memory_accounting_matches_jax(adam8bit, ema):
    kw = dict(use_8bit_adam=adam8bit, use_ema=ema, use_ema_fashion=ema)
    # 8 devices: the ZeRO-1 plan shards (the data-parallel one does not depend
    # on the count)
    ours = tmemory.state_memory_accounting(tcfg.ModelConfig.tiny(), tcfg.TrainConfig(**kw), 8)
    theirs = jmemory.state_memory_accounting(jcfg.ModelConfig.tiny(), jcfg.TrainConfig(**kw),
                                             8)
    assert ours["param_count_trainable"] == theirs["param_count_trainable"] == 2161060
    assert list(ours["buckets"]) == list(theirs["buckets"])
    # the one difference (ROADMAP.md section 3): the optimizer's update count
    # is a host int in the port, an int32 scalar in optax's state, 4 bytes,
    # never sharded
    diff = {k: theirs["buckets"][k] - ours["buckets"][k] for k in ours["buckets"]}
    assert diff == {"params_trainable": 0, "params_frozen": 0, "opt_state": 4, "ema": 0,
                    "grads_transient": 0}
    assert theirs["per_chip_bytes_dp"] - ours["per_chip_bytes_dp"] == 4
    assert theirs["per_chip_bytes_zero1"] - ours["per_chip_bytes_zero1"] == 4
    assert ours["n_devices"] == 8
    assert ours["per_chip_bytes_zero1"] < ours["per_chip_bytes_dp"]


def test_accounting_equals_a_live_state_and_the_shard_rule_equals_jax():
    from difashion_tpu_torch.engine.train import build_train_step
    from difashion_tpu_torch.models.difashion import create_difashion

    for kw in ({}, {"use_8bit_adam": True}):
        tc = tcfg.TrainConfig(**kw)
        model = create_difashion(tcfg.ModelConfig.tiny(), seed=0, device="cpu")
        state = build_train_step(model, tc)[1]()
        acc = tmemory.state_memory_accounting(tcfg.ModelConfig.tiny(), tc, 1)
        live = tmemory.state_bytes(state)
        assert live == {k: acc["buckets"][k] for k in live}
        assert acc["buckets"]["params_frozen"] == sum(
            p.numel() * 4 for t in ("vae", "text_encoder")
            for p in getattr(model, t).parameters())
    for shape in [(), (0, 4), (7,), (8,), (3, 16), (16, 24), (320, 320, 3, 3), (5, 7), (1280,)]:
        for ndev in (1, 2, 3, 4, 8):
            assert tmemory.zero1_shard_axis(shape, ndev) == jax_zero1_shard_axis(shape, ndev)


def test_info_json_reports_cpu_and_the_plan(capsys):
    out = port_main(["info", "--json", "--model", "tiny", "--adam8bit", "--hbm_gib", "0.01"])
    assert out == 0
    got = json.loads(capsys.readouterr().out)
    assert got["backend"] == "cpu" and got["device_kind"] == "cpu" and got["devices"] == 1
    assert got["mesh"] == {"dp": 1} and got["torch"] == torch.__version__
    acc = got["hbm_accounting"]
    want = tmemory.state_memory_accounting(
        tcfg.ModelConfig.tiny(), tcfg.TrainConfig(use_8bit_adam=True), 1)
    assert {k: acc[k] for k in want} == json.loads(json.dumps(want))
    assert acc["hbm_budget_bytes"] == int(0.01 * 2**30)
    assert acc["fits_dp"] is False and acc["fits_zero1"] is False
    env = tinfo.main(["--skip_accounting", "--dp_size", "4"])
    assert env["mesh"] == {"dp": 4}
    text = capsys.readouterr().out
    assert "backend      cpu" in text and "accounting" not in text
    tinfo.main(["--model", "tiny"])
    assert "FITS 80.00 GiB" in capsys.readouterr().out


# ---- the train command end to end --------------------------------------------


def test_train_cli_checkpoints_prune_and_resume_bit_for_bit(tmp_path, capsys):
    data = write_dataset(tmp_path / "data")
    out = str(tmp_path / "ckpt")
    cfg = write_config(tmp_path / "cfg.json", checkpointing_steps=2, checkpoints_total_limit=2)
    state, model = _run(data, out, "--config", cfg, "--max_train_steps", "5")
    store = CheckpointStore(out)
    assert store.all_steps() == [4, 5] and store.has_frozen()
    assert state.step == 5 and state.opt_state.count == 5 and state.ema.step == 5
    frozen = store.load_frozen()
    assert set(frozen) == {"vae", "text_encoder"}
    for tower, sd in frozen.items():
        for k, v in getattr(model, tower).state_dict().items():
            assert torch.equal(sd[k], v), k
    # the checkpoint holds leg 1's final state bit for bit
    assert_states_equal(store.load(fresh_template(state)), state)
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [5]    # one sync: the last step
    assert np.isfinite(recs[0]["loss"]) and recs[0]["update_skipped"] == 0.0

    # resume at the saved step: zero steps to take returns the restored state
    restored, _ = _run(data, out, "--config", cfg, "--max_train_steps", "5",
                       "--resume_from_checkpoint", "latest")
    assert_states_equal(restored, state)
    # and the run continues from step 5
    cont, _ = _run(data, out, "--config", cfg, "--max_train_steps", "7",
                   "--resume_from_checkpoint", "latest")
    assert cont.step == 7 and cont.opt_state.count == 7 and cont.ema.step == 7
    assert store.all_steps() == [6, 7]
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [5, 7]
    assert recs[1]["images_per_sec_per_chip"] == pytest.approx(
        2 * 2 * 4 / recs[1]["step_time_s"])
    # an explicit step resumes from that checkpoint
    at6, _ = _run(data, out, "--config", cfg, "--max_train_steps", "6",
                  "--resume_from_checkpoint", "6")
    assert at6.step == 6
    assert _train(data, str(tmp_path / "other"), "--max_train_steps", "1") == 0


def test_train_cli_explicit_missing_step_exits_nonzero(tmp_path):
    data = write_dataset(tmp_path / "data")
    out = str(tmp_path / "ckpt")
    _run(data, out, "--max_train_steps", "2")
    with pytest.raises(SystemExit, match="checkpoint-99 not found"):
        _run(data, out, "--max_train_steps", "3", "--resume_from_checkpoint", "99")
    assert CheckpointStore(out).all_steps() == [2]
    proc = subprocess.run(
        [sys.executable, "-m", "difashion_tpu_torch", "train", "--tiny", "--device", "cpu",
         "--data_path", data, "--output_dir", out, "--max_train_steps", "3",
         "--resume_from_checkpoint", "7"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and "checkpoint-7 not found" in proc.stderr
    assert CheckpointStore(out).all_steps() == [2]


def test_train_cli_validation_samples_with_the_ema_weights(tmp_path):
    from PIL import Image

    data = write_dataset(tmp_path / "data")
    plain, _ = _run(data, str(tmp_path / "plain"), "--max_train_steps", "3")
    out = str(tmp_path / "ckpt")
    state, _ = _run(data, out, "--max_train_steps", "3", "--validation_steps", "2")
    # sampling swaps the EMA weights in and back: training is unchanged
    assert_states_equal(state, plain)
    run = os.path.join(out, "samples", "step-2")
    manifest = np.load(run + ".npy", allow_pickle=True).item()
    paths = [p for u in manifest.values() for r in u.values() for p in r["image_paths"]]
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)
    assert np.asarray(Image.open(paths[0])).shape == (64, 64, 3)
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert {"step": 2, "image": "validation/fitb_samples"}.items() <= recs[0].items()
    (tb_file,) = os.listdir(os.path.join(out, "tb"))
    events = list(ttb.read_events(os.path.join(out, "tb", tb_file)))
    assert any("validation/fitb_samples" in e["images"] for e in events)


def test_train_cli_precomputes_from_pngs_then_trains_from_images(tmp_path):
    from PIL import Image

    from difashion_tpu_torch.cli.extract_features import make_item_loader
    from difashion_tpu_torch.models.difashion import create_difashion

    data = write_dataset(tmp_path / "data", moments=False)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(8)
    names = []
    for i in range(N_ITEMS):
        Image.fromarray(rng.randint(0, 255, (80, 64, 3), dtype=np.uint8)).save(
            img_dir / f"item{i}.png")
        names.append(f"item{i}.png")
    paths = str(tmp_path / "paths.npy")
    np.save(paths, np.array(names, dtype=object))
    images = ["--img_folder_path", str(img_dir), "--image_paths_npy", paths]
    out = str(tmp_path / "ckpt")
    with pytest.raises(SystemExit, match="catalog moments not found"):
        _run(data, out, "--max_train_steps", "1")
    state, _ = _run(data, out, "--max_train_steps", "2", "--from_images", *images)
    assert state.step == 2 and CheckpointStore(out).all_steps() == [2]
    got = tpre.load_processed(data, "all_item_moments")
    # the precompute is extract-features' (the seed-0 VAE over the PIL catalog
    # pipeline)
    cfg = tcfg.ModelConfig.tiny()
    want = tpre.encode_catalog(create_difashion(cfg, seed=0, device="cpu"),
                               make_item_loader(str(img_dir), names, cfg.vae.sample_size),
                               N_ITEMS, device="cpu")
    for key in ("mean", "logvar"):
        assert got[key].shape == (N_ITEMS, 8, 8, 4)
        np.testing.assert_array_equal(got[key], want[key])
    # the next run reads the cache, without images
    state, _ = _run(data, out, "--max_train_steps", "3", "--resume_from_checkpoint", "latest")
    assert state.step == 3


def test_train_cli_refuses_several_gpus_and_missing_pil(tmp_path, monkeypatch):
    data = write_dataset(tmp_path / "data")
    cfg = write_config(tmp_path / "cfg.json", dp_size=2)
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        _run(data, str(tmp_path / "a"), "--config", cfg, "--max_train_steps", "1")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match="--from_images needs PIL"):
        _run(data, str(tmp_path / "b"), "--max_train_steps", "1", "--from_images",
             "--img_folder_path", "x", "--image_paths_npy", os.path.join(data, "train.npy"))
    with pytest.raises(SystemExit, match="--validation_steps .* needs PIL"):
        _run(data, str(tmp_path / "c"), "--max_train_steps", "1", "--validation_steps", "1")
    nodata = write_dataset(tmp_path / "nodata", moments=False)
    with pytest.raises(SystemExit, match="first-run precompute .* needs PIL"):
        _run(nodata, str(tmp_path / "d"), "--max_train_steps", "1", "--img_folder_path",
             "x", "--image_paths_npy", os.path.join(data, "train.npy"))

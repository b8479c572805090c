"""The JAX package's checkpoints in the port, on the CPU at the tiny config:
the msgpack codec (`core/msgpack.py`) against `flax.serialization` byte for
byte, the flax path and layout translation (`core/flax_layout.py`) against
`core/importer.py` at the tiny, sd2_base and sd15 configs, and
`CheckpointStore` reading directories that `difashion_tpu.core.checkpoint.
CheckpointStore` wrote: AdamW with EMA, AdamW under a schedule without EMA,
8-bit AdamW (refused: its blocks differ), a JAX directory read without the
MutualEncoder's dims (refused), the port's JAX-layout writer read back by the
JAX store under a schedule and under the constant rate, one resumed update
against optax's, `generate` / `serve` from a JAX directory against the same
weights in the port's own checkpoint, and `train --resume_from_checkpoint`
into a directory that then holds both layouts.

Weights are seeded numpy values on the JAX trees' shapes (`jax.eval_shape`:
no JAX init). Reads are bit-equal; the resumed update is held to
`test_torch_port_train.py`'s AdamW tolerance (rtol 1e-6, atol 1e-7)."""
import collections
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import flax.serialization as flax_ser
from difashion_tpu.core import checkpoint as jckpt
from difashion_tpu.core import config as jcfg
from difashion_tpu.core.importer import export_params, flax_path_to_hf_key
from difashion_tpu.engine import optim8bit as j8
from difashion_tpu.engine import train as jtrain
from difashion_tpu.models.difashion import create_difashion as jax_create
from difashion_tpu_torch import config as tcfg
from difashion_tpu_torch.checkpoint import CheckpointStore
from difashion_tpu_torch.cli import train as tcli
from difashion_tpu_torch.core import flax_layout as fl
from difashion_tpu_torch.core import msgpack as tm
from difashion_tpu_torch.engine import train as ttrain
from difashion_tpu_torch.engine.optim8bit import Adam8bitState
from difashion_tpu_torch.models.difashion import create_difashion
from difashion_tpu_torch.weights import load_difashion

from test_torch_port_serve import _dataset
from test_torch_port_train_cli import write_config, write_dataset

UPDATE_TOL = dict(rtol=1e-6, atol=1e-7)
KINDS = {"unet": "unet", "vae": "vae", "text_encoder": "text", "fashion_encoder": "mutual"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the codec -----------------------------------------------------------------

NT = collections.namedtuple("NT", ["count", "mu"])


def _trees(rng):
    a = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    c = rng.randint(-5, 5, (2, 3)).astype(np.int32)
    big = rng.randn(40).astype(np.float32)
    ints = (1, -3, 300, 70000, -40000, 2 ** 40, 1.5, True, "hey", b"raw")
    jt = {"x": jnp.asarray(a), "y": [jnp.asarray(b).astype(jnp.bfloat16), {"z": jnp.asarray(c)},
                                     None, ints],
          "nt": NT(jnp.asarray(7, jnp.int32), {"k": jnp.asarray(a)}), "s": np.float32(2.5),
          "i": np.int32(3), "bf": jnp.asarray(1.5, jnp.bfloat16), "empty": {},
          "e0": jnp.zeros((0, 3)), "big": jnp.asarray(big)}
    tt = {"x": torch.from_numpy(a), "y": [torch.from_numpy(b).bfloat16(),
                                          {"z": torch.from_numpy(c)}, None, ints],
          "nt": NT(torch.tensor(7, dtype=torch.int32), {"k": torch.from_numpy(a)}),
          "s": np.float32(2.5), "i": np.int32(3), "bf": torch.tensor(1.5, dtype=torch.bfloat16),
          "empty": {}, "e0": torch.zeros(0, 3), "big": torch.from_numpy(big)}
    return jt, tt


@pytest.mark.parametrize("chunk", [None, 64])
def test_packb_is_flax_to_bytes_byte_for_byte(monkeypatch, chunk):
    """fp32, bf16 and int32 arrays and scalars, numpy scalars, nested lists,
    tuples and namedtuples, python scalars; `chunk`: MAX_CHUNK_SIZE cut so
    that `big` (160 bytes) is stored chunked."""
    if chunk:
        monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(tm, "MAX_CHUNK_SIZE", chunk)
    jt, tt = _trees(np.random.RandomState(0))
    want = serialization.to_bytes(jt)
    assert (b"__msgpack_chunked_array__" in want) == bool(chunk)
    assert tm.packb(tt) == want
    back = tm.unpackb(want)
    assert torch.equal(back["big"], tt["big"]) and back["big"].shape == (40,)
    assert back["y"]["0"].dtype == torch.bfloat16 and torch.equal(back["y"]["0"], tt["y"][0])
    assert torch.equal(back["nt"]["count"], torch.tensor(7, dtype=torch.int32))
    assert back["y"]["3"] == {str(i): v for i, v in enumerate(tt["y"][3])}
    assert back["y"]["2"] is None and back["empty"] == {} and back["e0"].shape == (0, 3)


def test_mapped_file_maps_each_leaf_on_its_own(tmp_path, monkeypatch):
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    jt, tt = _trees(np.random.RandomState(1))
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.to_bytes(jt))
    with tm.MappedFile(str(path)) as mf:
        x = mf.tensor(mf.tree["x"])
        assert torch.equal(x, tt["x"])
        assert isinstance(mf.tree["big"], tm.Chunked) and len(mf.tree["big"].chunks) == 3
        assert torch.equal(mf.tensor(mf.tree["big"]), tt["big"])
        bf = mf.tensor(mf.tree["y"]["0"])       # bfloat16, read as int16
        assert isinstance(mf.tree["s"], tm.Blob) and mf.tree["s"].scalar
        assert mf.tree["y"]["3"]["9"] == tm.Bin(mf.tree["y"]["3"]["9"].offset, 3)
    # the tensors keep their own windows of the file after it is closed
    assert torch.equal(x, tt["x"]) and torch.equal(bf, tt["y"][0])
    assert torch.equal(tm.MappedFile(str(path)).tensor(mf.tree["e0"]), tt["e0"])


# ---- paths and layouts ---------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "sd2_base", "sd15"])
def test_flax_paths_translate_both_ways(name):
    cfg = getattr(jcfg.ModelConfig, name)()
    shapes = jax.eval_shape(lambda k: jax_create(cfg, k)[1], jax.random.PRNGKey(0))
    n = 0
    for tower, sub in shapes.items():
        kind = KINDS[tower]
        leaves = [(tuple(str(k.key) for k in p), s.shape)
                  for p, s in jax.tree_util.tree_flatten_with_path(sub)[0]]
        conv = {fl.flax_path_to_hf_key(p, kind).rsplit(".", 1)[0]: len(s) == 4
                for p, s in leaves if p[-1] == "kernel"}
        for p, s in leaves:
            key = fl.flax_path_to_hf_key(p, kind)
            if p != ("category_embedding",):
                assert key == flax_path_to_hf_key(p, kind)
            assert fl.hf_key_to_flax_path(key, kind, conv.get(key.rsplit(".", 1)[0], False)) == p
            n += 1
    assert n > 600


@functools.cache
def _tiny_shapes():
    cfg = jcfg.ModelConfig.tiny()
    return jax.eval_shape(lambda k: jax_create(cfg, k)[1], jax.random.PRNGKey(0))


def _jax_params(seed):
    """The tiny bundle's parameter trees with seeded numpy values."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda s: (rng.randn(*s.shape) * 0.05).astype(np.float32),
                                  _tiny_shapes())


def _dims():
    c = jcfg.ModelConfig.tiny().mutual
    return (c.latent_channels, c.latent_size)


def _export(tree):
    """{port name: HF-layout array} of a {tower: flax tree} through the JAX
    package's exporter."""
    return {f"{t}.{k}": v for t, sub in tree.items()
            for k, v in export_params(sub, KINDS[t],
                                      mutual_dims=_dims() if t == "fashion_encoder"
                                      else None).items()}


def test_layouts_match_the_jax_exporter():
    params = _jax_params(3)
    want = _export(params)
    for tower, sub in params.items():
        kind = KINDS[tower]
        for p, v in jax.tree_util.tree_flatten_with_path(sub)[0]:
            path = tuple(str(k.key) for k in p)
            name = f"{tower}.{fl.flax_path_to_hf_key(path, kind)}"
            t = torch.from_numpy(np.asarray(v))
            got = fl.to_port(path, kind, _dims())(t)
            assert torch.equal(got, torch.from_numpy(np.array(want[name]))), name
            assert torch.equal(fl.to_flax(path, kind, _dims())(got), t), name


# ---- checkpoints written by the JAX store ----------------------------------------

CASES = {"adamw_ema": dict(), "adamw_schedule_no_ema": dict(lr_scheduler="cosine",
                                                            lr_warmup_steps=1,
                                                            max_train_steps=10, use_ema=False,
                                                            use_ema_fashion=False),
         "adam8bit": dict(use_8bit_adam=True)}


def _train_cfgs(**kw):
    jc = dataclasses.replace(jcfg.Config.preset_tiny().train, learning_rate=1e-3, **kw)
    tc = dataclasses.replace(tcfg.Config.preset_tiny().train, learning_rate=1e-3, **kw)
    return jc, tc


def _jax_state(jc, params, steps=2, seed=5):
    """A JAX TrainState as after `steps` updates: the optax state of
    `make_optimizer(jc)` (its structure and shapes, every leaf seeded) with
    seeded moments (or int8 blocks and scales) and counts `steps`, an EMA a
    little off the parameters."""
    trainable, frozen = jtrain.split_params(params)
    rng = np.random.RandomState(seed)
    like = lambda tree, fn: jax.tree_util.tree_map(lambda x: fn(x.shape), tree)
    opt = jax.eval_shape(jtrain.make_optimizer(jc).init, trainable)
    adam, decay, sched = opt[1]
    count = np.asarray(steps, np.int32)
    if isinstance(adam, j8.Adam8bitState):
        q = lambda s: rng.randint(-127, 128, s).astype(np.int8)
        sc = lambda s: (rng.rand(*s) * 1e-3).astype(np.float32)
        adam = adam._replace(count=count, mu_q=like(adam.mu_q, q), mu_s=like(adam.mu_s, sc),
                             nu_q=like(adam.nu_q, q), nu_s=like(adam.nu_s, sc))
    else:
        adam = adam._replace(count=count,
                             mu=like(adam.mu, lambda s: (rng.randn(*s) * 1e-3).astype(np.float32)),
                             nu=like(adam.nu, lambda s: (rng.rand(*s) * 1e-5).astype(np.float32)))
    if "count" in sched._fields:
        sched = sched._replace(count=count)
    ema = jax.tree_util.tree_map(
        lambda p: (p + rng.randn(*p.shape) * 1e-3).astype(np.float32), trainable)
    use_ema = jc.use_ema or jc.use_ema_fashion
    opt_state = (opt[0], (adam, decay, sched))
    assert all(isinstance(x, np.ndarray) for x in jax.tree_util.tree_leaves(opt_state))
    return jtrain.TrainState(params=jtrain.merge_params(trainable, frozen),
                             opt_state=opt_state,
                             ema=jtrain.EMAState(params=ema, step=count) if use_ema else None,
                             step=count)


def _write_jax(root, jc, seed=3, steps=2):
    params = _jax_params(seed)
    state = _jax_state(jc, params, steps)
    store = jckpt.CheckpointStore(str(root))
    store.save(state, steps)
    store.save_frozen(jtrain.split_params(params)[1])
    return state


def _port_template(tc, seed=0):
    model = create_difashion(tcfg.ModelConfig.tiny(), seed=seed, device="cpu")
    _, init_state = ttrain.build_train_step(model, tc)
    return model, init_state()


def _assert_state_is_jax(state, jstate):
    want = _export(jtrain.split_params(jstate.params)[0])
    for name, p in zip(state.names, state.params):
        assert torch.equal(p.detach(), torch.from_numpy(np.array(want[name]))), name
    adam = jstate.opt_state[1][0]
    assert state.opt_state.count == int(adam.count) and state.step == int(jstate.step)
    if isinstance(state.opt_state, ttrain.AdamState):
        for field in ("mu", "nu"):
            want = _export(getattr(adam, field))
            for name, t in zip(state.names, getattr(state.opt_state, field)):
                assert torch.equal(t, torch.from_numpy(np.array(want[name]))), name
    if jstate.ema is not None:
        want = _export(jstate.ema.params)
        assert state.ema.step == int(jstate.ema.step)
        for name, t in zip(state.names, state.ema.params):
            assert torch.equal(t, torch.from_numpy(np.array(want[name]))), name


@pytest.mark.parametrize("case", list(CASES))
def test_jax_checkpoints_read_bit_equal(tmp_path, case):
    jc, tc = _train_cfgs(**CASES[case])
    jstate = _write_jax(tmp_path, jc)
    _, template = _port_template(tc)
    store = CheckpointStore(str(tmp_path))
    assert store.all_steps() == [2] and store.has_frozen()
    if case == "adam8bit":
        # conv and dense kernels order their elements differently on the two
        # sides, so their int8 blocks of 256 differ: refused, not requantized
        with pytest.raises(ValueError, match="8-bit AdamW moments cannot be carried"):
            store.load(template, mutual_dims=_dims())
        return
    state = store.load(template, mutual_dims=_dims())
    assert state.params[0] is template.params[0]          # in place
    assert (state.ema is None) == (case == "adamw_schedule_no_ema")
    _assert_state_is_jax(state, jstate)
    frozen = store.load_frozen()
    want = {t: export_params(jstate.params[t], KINDS[t]) for t in ("vae", "text_encoder")}
    assert frozen.keys() == want.keys()
    for t in want:
        assert frozen[t].keys() == want[t].keys()
        for k, v in want[t].items():
            assert torch.equal(frozen[t][k], torch.from_numpy(np.array(v))), k


def test_the_port_writes_the_jax_layout_the_jax_store_reads(tmp_path):
    jc, tc = _train_cfgs(lr_scheduler="constant_with_warmup", lr_warmup_steps=2)
    jstate = _write_jax(tmp_path / "jax", jc)
    _, template = _port_template(tc)
    state = CheckpointStore(str(tmp_path / "jax")).load(template, mutual_dims=_dims())
    CheckpointStore(str(tmp_path / "port")).save_jax_layout(state, 2, tc, _dims())
    for f in ("trainable.msgpack", "opt_state.msgpack", "ema.msgpack"):
        a = tm.unpackb((tmp_path / "port" / "checkpoint-2" / f).read_bytes())
        b = tm.unpackb((tmp_path / "jax" / "checkpoint-2" / f).read_bytes())

        def same(x, y, where=()):
            assert type(x) is type(y), where
            if isinstance(x, dict):
                assert x.keys() == y.keys(), where
                for k in x:
                    same(x[k], y[k], where + (k,))
            elif isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y), where
        same(a, b)
    back = jckpt.CheckpointStore(str(tmp_path / "port")).load(jstate._replace(step=np.int32(0)))
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_the_jax_layout_needs_the_mutual_dims_and_follows_the_schedule(tmp_path):
    """Without the model config's MutualEncoder dims a JAX directory is
    refused (its flat size does not decide them: 4*64*64 == 16*32*32); the
    writer under the recipe's constant rate holds no schedule state, replaces
    a checkpoint of the same step, and the JAX store reads it back."""
    jc, tc = _train_cfgs()
    assert jc.lr_scheduler == tc.lr_scheduler == "constant"
    jstate = _write_jax(tmp_path / "jax", jc)
    _, template = _port_template(tc)
    with pytest.raises(ValueError, match="pass mutual_dims"):
        CheckpointStore(str(tmp_path / "jax")).load(template)
    with pytest.raises(ValueError, match="latent"):
        fl.mutual_latent_dims(4 * 64 * 64, None)
    state = CheckpointStore(str(tmp_path / "jax")).load(template, mutual_dims=_dims())
    store = CheckpointStore(str(tmp_path / "port"))
    store.save_jax_layout(state, 2, tc, _dims())
    store.save_jax_layout(state, 2, tc, _dims())
    assert sorted(os.listdir(tmp_path / "port")) == ["checkpoint-2"]
    opt = tm.unpackb((tmp_path / "port" / "checkpoint-2" / "opt_state.msgpack").read_bytes())
    assert opt["1"]["2"] == {} and int(opt["1"]["0"]["count"]) == 2
    back = jckpt.CheckpointStore(str(tmp_path / "port")).load(jstate._replace(step=np.int32(0)))
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_one_resumed_update_matches_optax(tmp_path):
    """One optimizer + EMA update from the restored state: the port's
    `apply_gradients` against the JAX step's (clip, optax chain, EMA) from
    the same checkpoint, on the same seeded gradients."""
    jc, tc = _train_cfgs(lr_scheduler="constant_with_warmup", lr_warmup_steps=5)
    jstate = _write_jax(tmp_path, jc)
    _, template = _port_template(tc)
    state = CheckpointStore(str(tmp_path)).load(template, mutual_dims=_dims())
    trainable = jtrain.split_params(jstate.params)[0]
    rng = np.random.RandomState(9)
    grads = jax.tree_util.tree_map(lambda p: (rng.randn(*p.shape) * 0.5).astype(np.float32),
                                   trainable)
    tx = jtrain.make_optimizer(jc)

    @jax.jit
    def update(grads, opt, trainable):
        updates, opt = tx.update(grads, opt, trainable)
        return optax.apply_updates(trainable, updates), opt

    new, opt = update(grads, jstate.opt_state, trainable)
    d = float(jtrain.ema_decay_schedule(jnp.asarray(jstate.ema.step), jc.ema_decay))
    ema = jax.tree_util.tree_map(lambda e, p: d * e + (1.0 - d) * p, jstate.ema.params, new)
    g = _export(grads)
    m = ttrain.apply_gradients(state, [torch.from_numpy(np.array(g[n]))
                                       for n in state.names], ttrain.make_optimizer(tc), tc)
    np.testing.assert_allclose(float(m["grad_norm"]), float(optax.global_norm(grads)),
                               rtol=1e-6)
    assert state.opt_state.count == 3 == int(opt[1][0].count) and state.ema.step == 3
    for field, tree in (("params", new), ("ema", ema), ("mu", opt[1][0].mu),
                        ("nu", opt[1][0].nu)):
        want = _export(tree)
        got = {"params": state.params, "ema": state.ema.params, "mu": state.opt_state.mu,
               "nu": state.opt_state.nu}[field]
        for name, t in zip(state.names, got):
            np.testing.assert_allclose(t.detach().numpy(), want[name], **UPDATE_TOL,
                                       err_msg=f"{field} {name}")


def test_generate_and_serve_from_a_jax_directory(tmp_path):
    """`generate` and `serve` read a JAX directory (checkpoint + frozen
    towers) into the same weights as the port's own checkpoint of them
    (carried across by the JAX exporter): the same images, byte for byte."""
    from difashion_tpu_torch.__main__ import main
    from difashion_tpu_torch.cli import serve

    jc, tc = _train_cfgs()
    jstate = _write_jax(tmp_path / "jax", jc)
    model = create_difashion(tcfg.ModelConfig.tiny(), seed=1, device="cpu")
    sds = {t: export_params(jstate.params[t], KINDS[t],
                            mutual_dims=_dims() if t == "fashion_encoder" else None)
           for t in KINDS}
    load_difashion(model, sds)
    named = model.trainable_parameters()
    ema = _export(jstate.ema.params)
    port_state = ttrain.TrainState(
        names=[n for n, _ in named], params=[p for _, p in named],
        opt_state=ttrain.AdamState(2, [torch.zeros_like(p) for _, p in named],
                                   [torch.zeros_like(p) for _, p in named]),
        ema=ttrain.EMAState([torch.from_numpy(np.array(ema[n])) for n, _ in named], 2),
        step=2)
    store = CheckpointStore(str(tmp_path / "port"))
    store.save(port_state, 2)
    store.save_frozen({t: getattr(model, t).state_dict() for t in ("vae", "text_encoder")})
    data = tmp_path / "data"
    _dataset(str(data))
    images = {}
    for who in ("jax", "port"):
        out = tmp_path / f"out_{who}"
        common = ["--data_path", str(data), "--ckpt_dir", str(tmp_path / who), "--tiny",
                  "--device", "cpu", "--allow_random_weights", "--num_inference_steps", "2"]
        assert main(["generate", *common, "--output_dir", str(out)]) == 0
        images[who] = {os.path.relpath(os.path.join(d, f), out): open(os.path.join(d, f),
                                                                         "rb").read()
                       for d, _, fs in os.walk(out) for f in fs if f.endswith(".jpg")}
        svc = serve.build_service(serve.parse_args(common + ["--max_batch", "2"]))
        assert svc.checkpoint_step == 2
    assert images["jax"] and images["jax"] == images["port"]


def test_train_resumes_a_jax_directory_and_keeps_both_layouts(tmp_path):
    """train --resume_from_checkpoint latest from a JAX checkpoint: the
    restored state is the JAX one, the next checkpoints are the port's in
    the same directory, `latest` and the pruning go by step across layouts,
    and the JAX frozen towers count as saved."""
    data = write_dataset(tmp_path / "data")
    out = tmp_path / "ckpt"
    cfg = write_config(tmp_path / "cfg.json", checkpointing_steps=1, checkpoints_total_limit=2)
    jc = jcfg.Config.from_json(open(cfg).read()).train
    jstate = _write_jax(out, jc)
    restored, _ = tcli.main(["--tiny", "--device", "cpu", "--data_path", data, "--output_dir",
                             str(out), "--config", cfg, "--max_train_steps", "2",
                             "--resume_from_checkpoint", "latest"])
    _assert_state_is_jax(restored, jstate)
    store = CheckpointStore(str(out))
    assert not os.path.exists(out / "frozen.pt") and store.has_frozen()
    state, _ = tcli.main(["--tiny", "--device", "cpu", "--data_path", data, "--output_dir",
                          str(out), "--config", cfg, "--max_train_steps", "3",
                          "--resume_from_checkpoint", "latest"])
    assert state.step == 3 and state.opt_state.count == 3 and state.ema.step == 3
    assert store.all_steps() == [2, 3]
    assert os.path.exists(out / "checkpoint-2" / "trainable.msgpack")
    assert os.path.exists(out / "checkpoint-3" / "trainable.pt")
    state4, _ = tcli.main(["--tiny", "--device", "cpu", "--data_path", data, "--output_dir",
                           str(out), "--config", cfg, "--max_train_steps", "4",
                           "--resume_from_checkpoint", "latest"])
    assert store.all_steps() == [3, 4] and state4.step == 4
    with open(out / "checkpoint-4" / "meta.json") as f:
        assert json.load(f)["step"] == 4

"""The port's multi-GPU layer on the CPU, in real processes under gloo:
`core/distributed.py` (the group from torchrun's environment, `host_shard`,
the bucketed gradient mean, the startup parameter check), the data-parallel
train step with and without gradient accumulation, ZeRO-1 (alone, with
accumulation, its 8-bit refusal, its bytes and its checkpoint), sharded
generation, and the train command under two ranks.

Two child ranks (`tests/_torch_dist_child.py`, torch and the port only) run
every engine check in one spawn while this process computes the references:
the port's one-process step over the global batch, the JAX package's
`shard_train_step` on `make_mesh(2)` with injected draws, and its sharded
sampler (`shard_generation_inputs`), all at the tiny config in fp32 with the
same weights (seeded values on the JAX bundle's shapes, loaded into the port
through `export_params`). A child that fails or outlives its timeout fails
the test with its output."""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from difashion_tpu.core import config as jcfg
from difashion_tpu.core.distributed import host_shard as jax_host_shard
from difashion_tpu.core.importer import export_params
from difashion_tpu.engine import generate as jgen
from difashion_tpu.engine import train as jtrain
from difashion_tpu.models.difashion import create_difashion as jax_create
from difashion_tpu_torch import config as tcfg
from difashion_tpu_torch.checkpoint import CheckpointStore
from difashion_tpu_torch.cli import info as tinfo
from difashion_tpu_torch.cli import train as tcli
from difashion_tpu_torch.core import distributed
from difashion_tpu_torch.engine import generate as tgen
from difashion_tpu_torch.engine import memory as tmemory
from difashion_tpu_torch.engine import train as ttrain

from _torch_dist_child import SEED, batch_of, train_config
from test_torch_port_models import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_port_models import port_from_jax
from test_torch_port_train_cli import write_config, write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_dist_child.py")
TIMEOUT = 240          # seconds a spawn may take; the work is a few seconds a rank
B, OLEN = 4, 4         # the global train batch: 2 outfits a rank
SAMPLER_TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_multiprocess.py's sharded bound
JAX_TOL = dict(rtol=1e-4, atol=1e-4)       # tests/test_torch_port_serve.py's vs JAX
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)     # tests/test_multiprocess.py's
ZERO1_TOL = dict(rtol=1e-6, atol=0)        # __graft_entry__.py's ZeRO-1 == DP


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """`world` processes of one command, each with torchrun's environment."""

    def __init__(self, args, world=2):
        port = _free_port()
        self.procs = []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=REPO)
            self.procs.append(subprocess.Popen(
                [sys.executable, *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))

    def wait(self, timeout=TIMEOUT):
        """Every rank's output; fails the test on a timeout or an exit code."""
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            outs += [p.communicate()[0] for p in self.procs[len(outs):]]
            pytest.fail(f"ranks timed out after {timeout} s:\n" + "\n".join(
                f"--- rank {r} ---\n{o[-3000:]}" for r, o in enumerate(outs)))
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            pytest.fail("ranks failed:\n" + "\n".join(
                f"--- rank {r} (exit {self.procs[r].returncode}) ---\n{outs[r][-3000:]}"
                for r in bad))
        return outs


# ---- the shared problem ----------------------------------------------------------

def _jax_bundle():
    """The JAX tiny bundle's modules and its parameter shapes with seeded
    values (no eager init: `jax.eval_shape`)."""
    cfg = jcfg.ModelConfig.tiny()
    held = {}

    def create(key):
        held["model"], params = jax_create(cfg, key)
        return params

    shapes = jax.eval_shape(create, jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.05).astype(np.float32), shapes)
    return cfg, held["model"], params


def _train_arrays(cfg, rng):
    h, C, n = cfg.unet.sample_size, cfg.vae.latent_channels, B * OLEN
    batch = {"mean": rng.randn(B, OLEN, h, h, C).astype(np.float32),
             "logvar": rng.uniform(-8, -2, (B, OLEN, h, h, C)).astype(np.float32),
             "ids": rng.randint(0, cfg.text.vocab_size, (B, OLEN, 77)).astype(np.int64),
             "hist": (rng.randn(B, OLEN, h, h, C) * 0.3).astype(np.float32)}
    injected = {"enc_eps": rng.randn(n, h, h, C).astype(np.float32),
                "noise": rng.randn(n, h, h, C).astype(np.float32),
                "t_outfit": rng.randint(0, 1000, (B,)).astype(np.int64),
                "p_mask": rng.uniform(size=n).astype(np.float32),
                "p_cate": rng.uniform(size=n).astype(np.float32)}
    return batch, injected


def _gen_arrays(cfg, rng, gen_mask):
    """Generation inputs (numpy, in GenerationInputs' order) for the outfits
    of `gen_mask` [B, olen] (True: a slot to generate)."""
    nb = gen_mask.shape[0]
    h, C, D = cfg.unet.sample_size, cfg.vae.latent_channels, cfg.text.hidden_size
    F = int(gen_mask.sum())
    gen_index = np.zeros(gen_mask.shape, np.int64)
    gen_index[gen_mask] = np.arange(F)
    outfit_idx = np.nonzero(gen_mask)[0].astype(np.int64)
    return (rng.randn(F, h, h, C).astype(np.float32), outfit_idx,
            (rng.randn(nb, OLEN, h, h, C) * 0.2).astype(np.float32), gen_mask, gen_index,
            (rng.randn(F, h, h, C) * 0.1).astype(np.float32),
            (rng.randn(F, 77, D) * 0.1).astype(np.float32),
            np.zeros((77, D), np.float32), np.zeros((h, h, C), np.float32))


def _mixed_fitb_mask(rng):
    """4 outfits generating 1, 2, 3, 1 of their slots: 7 fills (odd), and
    the third outfit's fills straddle the two ranks' shares."""
    mask = np.zeros((4, OLEN), bool)
    for i, k in enumerate((1, 2, 3, 1)):
        mask[i, rng.permutation(OLEN)[:k]] = True
    return mask


class World:
    """The problem, the port model, and the two child ranks working on it."""

    def __init__(self, work):
        self.cfg, self.jmodel, self.params = _jax_bundle()
        self.port = port_from_jax(self.cfg, self.params)
        rng = np.random.RandomState(17)
        self.batch, self.injected = _train_arrays(self.cfg, rng)
        self.gen = {"gor": _gen_arrays(self.cfg, rng, np.ones((2, OLEN), bool)),
                    "fitb": _gen_arrays(self.cfg, rng, _mixed_fitb_mask(rng))}
        with torch.no_grad():
            null_text = self.port.encode_text(torch.zeros(1, 77, dtype=torch.long))[0]
        h, C = self.cfg.unet.sample_size, self.cfg.vae.latent_channels
        self.null_latent, self.null_text = torch.zeros(h, h, C), null_text
        self.work = str(work)
        self.init = {n: p.detach().clone() for n, p in self.port.trainable_parameters()}
        torch.save({"weights": self.port.state_dict(), "batch": self.batch,
                    "injected": self.injected, "gen": self.gen,
                    "null_latent": self.null_latent, "null_text": self.null_text},
                   os.path.join(self.work, "inputs.pt"))
        self.ranks = Ranks([CHILD, self.work])
        self._results = None

    def results(self):
        if self._results is None:
            self.ranks.wait()
            self._results = [torch.load(os.path.join(self.work, f"rank{r}.pt"),
                                        weights_only=False) for r in range(2)]
        return self._results

    def reset(self):
        """The port model's initial weights back."""
        with torch.no_grad():
            for n, p in self.port.trainable_parameters():
                p.copy_(self.init[n])

    def one_process_step(self, k):
        """The port's step over the global batch in one process (no group)."""
        self.reset()
        step, init = ttrain.build_train_step(self.port, train_config(k))
        state, m = step(init(), batch_of(self.batch), self.null_latent, self.null_text,
                        torch.Generator().manual_seed(SEED))
        return float(m["loss"]), {n: p.detach().clone() for n, p in zip(state.names,
                                                                        state.params)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("dist"))


def _close(got, want, tol, what):
    assert set(got) == set(want), what
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **tol,
                                   err_msg=f"{what}: {name}")


# ---- (a) host_shard --------------------------------------------------------------

def test_host_shard_matches_jax():
    rng = np.random.RandomState(0)
    batch = {"outfits": rng.randint(0, 99, (8, 4)), "uids": np.arange(8),
             "category": rng.randint(0, 5, (8, 4))}
    for world in (1, 2, 4, 8):
        for rank in range(world):
            got = distributed.host_shard(batch, rank, world)
            want = jax_host_shard(batch, process_index=rank, process_count=world)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    for world in (3, 5):
        with pytest.raises(ValueError) as theirs:
            jax_host_shard(batch, process_index=0, process_count=world)
        with pytest.raises(ValueError, match=str(theirs.value)):
            distributed.host_shard(batch, 0, world)


def test_buckets_and_device_rules():
    # sizes in units of the module's bucket (meta tensors: shapes, no memory)
    q = distributed.BUCKET_BYTES // 4 // 8
    ts = ([torch.empty(n * q, device="meta") for n in (3, 5, 9, 2)]
          + [torch.empty(4 * q, dtype=torch.float64, device="meta")])
    assert distributed.buckets(ts) == [[0, 1], [2], [3], [4]]
    assert distributed.shared_devices(["a", "b", "a", "c"]) == {"a": [0, 2]}
    assert distributed.shared_devices(["a", "b"]) == {}
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")
    assert distributed.rank_device("cuda:0", 1) == torch.device("cuda", 0)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no card of its own"):
            distributed.rank_device("cuda", 0)
    with pytest.raises(ValueError, match="one of"):
        distributed.initialize_distributed("mpi", "cpu")
    # a single process joins no group
    assert distributed.initialize_distributed("gloo", "cpu") == distributed.single("cpu")


# ---- the children's checks -------------------------------------------------------

# The JAX mesh step first: it compiles while the children work.
def test_dp_step_with_injected_draws_matches_jax_shard_train_step(world):
    """The 2-rank port step with the same injected draws against the JAX
    package's `shard_train_step` on a 2-device mesh: the loss at
    tests/test_torch_port_train.py's loss-vs-JAX bound, the parameters at
    tests/test_multiprocess.py's."""
    cfg, jmodel, params = world.cfg, world.jmodel, world.params
    inj = {k: jnp.asarray(v, jnp.int32 if k == "t_outfit" else jnp.float32)
           for k, v in world.injected.items()}
    jc = jcfg.TrainConfig(learning_rate=1e-4)
    step_fn, init_fn = jtrain.build_train_step(jmodel, jc)
    mesh = jtrain.make_mesh(2)
    jitted, place_batch, place_repl = jtrain.shard_train_step(step_fn, mesh)
    x = world.batch
    batch = jtrain.TrainBatch(images=None, latent_mean=x["mean"], latent_logvar=x["logvar"],
                              input_ids=x["ids"].astype(np.int32), hist_latents=x["hist"])
    original = jtrain.difashion_loss
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "difashion_loss",
                   lambda *a, **kw: original(*a, **kw, injected=inj))
        state = place_repl(init_fn(jax.tree_util.tree_map(jnp.asarray, params)))
        new, m = jitted(state, place_batch(batch), place_repl(world.null_latent.numpy()),
                        place_repl(world.null_text.numpy()), jax.random.PRNGKey(0))
        jloss = float(m["loss"])
    dims = (cfg.mutual.latent_channels, cfg.mutual.latent_size)
    want = {f"unet.{k}": torch.from_numpy(np.array(v))
            for k, v in export_params(new.params["unet"], "unet").items()}
    want.update({f"fashion_encoder.{k}": torch.from_numpy(np.array(v)) for k, v in
                 export_params(new.params["fashion_encoder"], "mutual",
                               mutual_dims=dims).items()})
    for r in world.results():
        np.testing.assert_allclose(r["injected"]["loss"], jloss, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["injected"]["grad_norm"], float(m["grad_norm"]),
                                   rtol=1e-4)
        _close(r["injected"]["params"], want, PARAM_TOL, f"injected rank {r['rank']}")


def test_startup_check_passes_alike_and_refuses_a_difference(world):
    res = world.results()
    assert [r["rank"] for r in res] == [0, 1]
    assert all(r["world"] == r["world_size"] == 2 for r in res)
    # rank 1's perturbed bias is seen by every rank, in its tower only
    for r in res:
        assert "fashion_encoder" in r["refused"] and "unet" not in r["refused"]
        assert "[1]" in r["refused"]


@pytest.mark.parametrize("k", [1, 2])
def test_ddp_step_equals_the_one_process_step(world, k):
    """Each rank's draws are its rows of the global batch's, so the 2-rank
    step computes the one-process step over both ranks' outfits. Loss:
    within 1e-6 relative (fp32: the mean over ranks of per-rank means sums
    in another order than the one-process mean, a few roundings of 2^-24);
    JAX's two-process loss is exact."""
    res = world.results()
    case = "ddp" if k == 1 else "ddp_k2"
    loss, params = world.one_process_step(k)
    for r in res:
        assert r[case]["skipped"] == 0.0
        np.testing.assert_allclose(r[case]["loss"], loss, rtol=1e-6)
        _close(r[case]["params"], params, PARAM_TOL, f"{case} rank {r['rank']}")
    # the same all-reduced gradient on both ranks: the same update, bit for bit
    for n in params:
        assert torch.equal(res[0][case]["params"][n], res[1][case]["params"][n]), n
    # the parameters moved (the comparison is not of two initial states)
    assert any(not torch.equal(params[n], world.init[n]) for n in params)


@pytest.mark.parametrize("k", [1, 2])
def test_zero1_equals_ddp(world, k):
    res = world.results()
    ddp, z1 = ("ddp", "zero1") if k == 1 else ("ddp_k2", "zero1_k2")
    for r in res:
        assert r[z1]["loss"] == r[ddp]["loss"]
        _close(r[z1]["params"], r[ddp]["params"], ZERO1_TOL, f"{z1} rank {r['rank']}")
        assert "gather_zero1_state" in r[z1]["snapshot_refused"]
        dp_bytes, z_bytes = r[ddp]["bytes"], r[z1]["bytes"]
        assert z_bytes["params_trainable"] == dp_bytes["params_trainable"]
        assert z_bytes["opt_state"] < 0.6 * dp_bytes["opt_state"]
        assert z_bytes["ema"] < 0.6 * dp_bytes["ema"]
    # the gathered state is the data-parallel one
    for f in ("mu", "nu", "ema"):
        _close(res[0][z1][f], res[0][ddp][f], ZERO1_TOL, f"{z1} {f}")
        assert f not in res[1][z1]


def _same_files(got, want, what):
    """Two loaded checkpoint files: the same structure, tensors within
    ZERO1_TOL, everything else equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same_files(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.shape == want.shape and got.dtype == want.dtype, what
        np.testing.assert_allclose(got.numpy(), want.numpy(), **ZERO1_TOL, err_msg=what)
    else:
        assert got == want, what


def test_zero1_checkpoint_keeps_the_data_parallel_files(world):
    world.results()
    stores = [CheckpointStore(os.path.join(world.work, f"ckpt_{c}")) for c in ("ddp", "zero1")]
    assert [s.all_steps() for s in stores] == [[1], [1]]
    paths = [s.ckpt_path(1) for s in stores]
    names = sorted(os.listdir(paths[0]))
    assert names == sorted(os.listdir(paths[1])) and "opt_state.pt" in names
    for name in names:
        if name.endswith(".pt"):
            _same_files(*(torch.load(os.path.join(p, name)) for p in paths[::-1]), name)
        else:
            assert open(os.path.join(paths[0], name)).read() == open(
                os.path.join(paths[1], name)).read(), name


def test_zero1_refuses_8bit_adam(world):
    with pytest.raises(ValueError, match="8-bit AdamW"):
        ttrain.build_train_step(world.port, train_config(use_8bit_adam=True),
                                dp=distributed.DistInfo(0, 2, 0, torch.device("cpu")),
                                zero1=True)


def test_zero1_bytes_match_place_state_zero1(world):
    """A rank's ZeRO-1 state bytes against the addressable shard of the JAX
    package's `place_state_zero1` on a 2-device mesh (the port keeps Adam's
    count on the host: 4 bytes fewer, ROADMAP §3) and against the memory
    plan; the children's live states count the same."""
    jc = jcfg.TrainConfig(learning_rate=1e-4)
    _, init_fn = jtrain.build_train_step(world.jmodel, jc)
    jstate = init_fn(jax.tree_util.tree_map(jnp.asarray, world.params))
    placed = jtrain.place_state_zero1(jstate, jtrain.make_mesh(2))

    def device0_bytes(tree):
        return sum(x.addressable_shards[0].data.size * x.dtype.itemsize
                   for x in jax.tree_util.tree_leaves(tree))

    trainable, _ = jtrain.split_params(placed.params)
    theirs = (device0_bytes(trainable) + device0_bytes(placed.opt_state)
              + device0_bytes(placed.ema.params))
    for rank in (0, 1):
        _, init = ttrain.build_train_step(world.port, train_config(), zero1=True,
                                          dp=distributed.DistInfo(rank, 2, rank,
                                                                  torch.device("cpu")))
        ours = tmemory.state_bytes(init())
        assert sum(ours.values()) == theirs - 4
        for r in world.results():
            if r["rank"] == rank:
                assert r["zero1"]["bytes"] == ours
    acc = tmemory.state_memory_accounting(tcfg.ModelConfig.tiny(), train_config(), 2)
    frozen = acc["buckets"]["params_frozen"] + acc["buckets"]["grads_transient"]
    assert sum(ours.values()) == acc["per_chip_bytes_zero1"] - frozen
    assert sum(world.results()[0]["ddp"]["bytes"].values()) == acc["per_chip_bytes_dp"] - frozen


@pytest.mark.parametrize("name", ["gor", "fitb"])
def test_sharded_generation_matches_unsharded_and_jax(world, name):
    arrays = world.gen[name]
    F = arrays[0].shape[0]
    world.reset()
    world.port.eval()
    spec = tgen.make_guidance_spec(12.0, 4.0, 5.0)
    want = tgen.build_sampler(world.port, num_inference_steps=2, spec=spec, eta=0.1)(
        tgen.GenerationInputs(*(torch.from_numpy(a) for a in arrays)))
    jspec = jgen.make_guidance_spec(12.0, 4.0, 5.0)
    mesh = jtrain.make_mesh(2)
    repl = NamedSharding(mesh, P())
    jparams = jax.tree_util.tree_map(lambda a: jax.device_put(a, repl), world.params)
    jinputs = jgen.shard_generation_inputs(jgen.GenerationInputs(
        *(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a) for a in arrays)), mesh)
    theirs = np.asarray(jax.jit(jgen.build_sampler(
        world.jmodel, num_inference_steps=2, spec=jspec, eta=0.1))(jparams, jinputs))[:F]
    for r in world.results():
        got = r["generation"][name]
        assert got["rows"] == -(-F // 2) and got["latents"].shape == want.shape
        np.testing.assert_allclose(got["latents"].numpy(), want.numpy(), **SAMPLER_TOL)
        np.testing.assert_allclose(got["latents"].numpy(), theirs, **JAX_TOL)
    if name == "fitb":
        assert F % 2 == 1


def test_sharded_ddim_draws_the_global_step_noise(world):
    """DDIM at eta 0.5 from one seed: each rank keeps its rows of the global
    batch's step noise, so the sharded run is the unsharded one."""
    world.reset()
    world.port.eval()
    spec = tgen.make_guidance_spec(12.0, 4.0, 5.0)
    want = tgen.build_sampler(world.port, num_inference_steps=2, spec=spec, eta=0.1,
                              scheduler="ddim", ddim_eta=0.5)(
        tgen.GenerationInputs(*(torch.from_numpy(a) for a in world.gen["gor"])),
        generator=torch.Generator().manual_seed(SEED))
    for r in world.results():
        got = r["generation"]["gor_ddim"]
        assert got["rows"] == 4
        np.testing.assert_allclose(got["latents"].numpy(), want.numpy(), **SAMPLER_TOL)


# ---- (f) the train command under two ranks -----------------------------------------

def test_train_command_under_two_ranks(tmp_path):
    data = write_dataset(tmp_path / "data", n_rows=8)
    out = str(tmp_path / "ckpt")
    cfg = write_config(tmp_path / "cfg.json", dp_size=2, train_batch_size=2)
    cmd = ["-m", "difashion_tpu_torch", "train", "--tiny", "--device", "cpu", "--config", cfg,
           "--data_path", data, "--output_dir", out]
    outs = Ranks(cmd + ["--max_train_steps", "2"]).wait()
    store = CheckpointStore(out)
    assert store.all_steps() == [2] and store.has_frozen()
    assert "saved checkpoint-2" in outs[0] and "saved checkpoint-2" not in outs[1]
    # one writer: one TensorBoard file, one metrics line for the logged step
    assert len([f for f in os.listdir(os.path.join(out, "tb"))
                if f.startswith("events.out.tfevents")]) == 1
    lines = [json.loads(s) for s in open(os.path.join(out, "metrics.jsonl"))]
    assert [rec["step"] for rec in lines] == [2] and np.isfinite(lines[0]["loss"])
    outs = Ranks(cmd + ["--max_train_steps", "3", "--resume_from_checkpoint", "latest"]).wait()
    assert all("resumed from checkpoint at step 2" in o for o in outs)
    assert store.all_steps() == [2, 3]
    lines = [json.loads(s) for s in open(os.path.join(out, "metrics.jsonl"))]
    assert [rec["step"] for rec in lines] == [2, 3]
    with open(os.path.join(store.ckpt_path(3), "meta.json")) as f:
        assert json.load(f)["step"] == 3


def test_train_command_without_a_group_names_torchrun(tmp_path):
    data = write_dataset(tmp_path / "data")
    cfg = write_config(tmp_path / "cfg.json", dp_size=2, train_batch_size=2)
    with pytest.raises(SystemExit, match=r"torchrun --nproc_per_node 2"):
        tcli.main(["--tiny", "--device", "cpu", "--config", cfg, "--data_path", data,
                   "--output_dir", str(tmp_path / "o"), "--max_train_steps", "1"])
    log = tcli.setup_logging()
    assert tcli.resolve_dp_size(-1, 2, 4, log) == 2
    with pytest.raises(SystemExit, match="do not split over 2 ranks"):
        tcli.resolve_dp_size(-1, 2, 3, log)


# ---- (g) scale_lr's world ---------------------------------------------------------

def _updates(kw):
    """The parameters after one optimizer step of the port's chain and of
    the JAX package's from the same parameters and gradient (steps of ~1e-3
    on parameters of ~1: a step size off by any factor shows)."""
    rng = np.random.RandomState(4)
    p, g = rng.randn(3, 5).astype(np.float32), rng.randn(3, 5).astype(np.float32) * 0.1
    opt = ttrain.make_optimizer(tcfg.TrainConfig(**kw))
    ours = torch.from_numpy(p.copy())
    opt.update_([ours], [torch.from_numpy(g)], opt.init([ours]))
    tx = jtrain.make_optimizer(jcfg.TrainConfig(**kw))
    upd, _ = tx.update({"w": jnp.asarray(g)}, tx.init({"w": jnp.asarray(p)}), {"w": jnp.asarray(p)})
    return ours.numpy(), np.asarray(optax.apply_updates({"w": jnp.asarray(p)}, upd)["w"])


def test_scale_lr_world_matches_jax(world, monkeypatch):
    kw = dict(scale_lr=True, train_batch_size=4, learning_rate=1e-4,
              gradient_accumulation_steps=2)
    for dp_size in (1, 2, 3):
        np.testing.assert_allclose(*_updates(dict(kw, dp_size=dp_size)), rtol=1e-6)
    # dp_size -1: the group's world, as jax.device_count() under one process
    # a device (torchrun's WORLD_SIZE before the group is joined)
    monkeypatch.setenv("WORLD_SIZE", str(jax.device_count()))
    np.testing.assert_allclose(*_updates(kw), rtol=1e-6)
    assert tinfo.device_report()["mesh"] == {"dp": jax.device_count()}
    # inside the two-rank group (accumulation 1): the world is 2
    want = ttrain.lr_schedule(tcfg.TrainConfig(**dict(kw, gradient_accumulation_steps=1,
                                                      dp_size=2)))(0)
    for r in world.results():
        assert r["scale_lr"] == want

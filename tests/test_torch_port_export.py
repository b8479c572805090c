"""The port's checkpoint export against the JAX tool, on the CPU at the tiny
config: the safetensors writer (`core/importer.py::write_safetensors`) read
back by the `safetensors` package and by the port's reader, bit for bit in
every dtype it writes; `scripts/export_hf_torch.py` against
`tools/export_hf.py` on one JAX checkpoint (the same files, keys, dtypes
and bit-equal tensors, with and without `--ema` / `--include_frozen`), and
its files read by the JAX importer with a UNet forward there against the
port's. The evaluation weights directory is `test_torch_port_eval_weights.py`'s.

Tolerance: the UNet forward as in `test_torch_port_models.py` (fp32, 2e-5).
Everything else is bit-equal."""
import importlib.util
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file

from difashion_tpu.core.importer import export_params
from difashion_tpu.core.importer import import_sd_checkpoint as jax_import_sd
from difashion_tpu.models.unet import UNet2DCondition as JUNet
from difashion_tpu_torch.config import Config
from difashion_tpu_torch.core.importer import (
    import_sd_checkpoint,
    read_safetensors,
    write_safetensors,
)
from difashion_tpu_torch.models.difashion import create_difashion

from test_torch_port_jax_checkpoint import KINDS, _dims, _jax_params, _train_cfgs, _write_jax
from test_torch_port_models import nchw, nhwc, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET_TOL = dict(rtol=2e-5, atol=2e-5)


def _load(path, name):
    """A script or tool (no package) loaded by its path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the safetensors writer ------------------------------------------------------

def _tensors(dtype):
    g = torch.Generator().manual_seed(0)
    if dtype == torch.bool:
        make = lambda s: torch.rand(s, generator=g) > 0.5
    elif dtype.is_floating_point:
        make = lambda s: torch.randn(s, generator=g).to(dtype)
    else:
        info = torch.iinfo(dtype)
        make = lambda s: torch.randint(max(info.min, -1000), min(info.max, 1000), s,
                                       generator=g, dtype=torch.int64).to(dtype)
    return {"a.weight": make((3, 5)), "b": make((7,)), "scalar": make(()),
            "empty": make((0, 4)),
            "conv": make((4, 3, 2, 2)).to(memory_format=torch.channels_last),
            "transposed": make((5, 3)).t()}


DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
          torch.uint8, torch.bool]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_writer_files_read_by_the_package_bit_equal(tmp_path, dtype):
    """Every dtype the writer takes, at 0-d, empty, channels-last and
    transposed tensors: the package reads the logical values bit for bit,
    the header is 8-byte aligned, the metadata comes back, and the port's
    reader round-trips the file."""
    sd = _tensors(dtype)
    path = str(tmp_path / "x.safetensors")
    n = write_safetensors(path, sd, metadata={"format": "pt"})
    assert os.path.getsize(path) == n
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
    assert header_len % 8 == 0
    got = load_file(path)
    ours = read_safetensors(path)
    assert set(got) == set(ours) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == ours[k].dtype == dtype and got[k].shape == v.shape
        assert torch.equal(got[k], v) and torch.equal(ours[k], v), k
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_writer_refuses_other_dtypes_and_leaves_no_partial_file(tmp_path):
    """A dtype it does not write raises before a byte is written; a write
    that fails part way leaves the file that was there and no temporary."""
    path = str(tmp_path / "x.safetensors")
    write_safetensors(path, {"a": torch.ones(3)})
    before = open(path, "rb").read()
    with pytest.raises(TypeError):
        write_safetensors(path, {"a": torch.ones(3, dtype=torch.float64)})

    class Failing(dict):
        reads = 0

        def __getitem__(self, k):
            Failing.reads += 1
            if Failing.reads > 3:   # the header pass reads each once; fail mid-data
                raise RuntimeError("killed")
            return super().__getitem__(k)

    with pytest.raises(RuntimeError, match="killed"):
        write_safetensors(path, Failing(a=torch.zeros(4), b=torch.zeros(4)))
    assert open(path, "rb").read() == before
    assert os.listdir(tmp_path) == ["x.safetensors"]


# ---- export_hf ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A tiny checkpoint of the JAX store (AdamW, EMA, the frozen towers),
    exported by `tools/export_hf.py` with `--ema --include_frozen`, and its
    raw weights through the tool's own exporter (`export_params`, what the
    tool writes without `--ema`: one JAX model init fewer)."""
    root = tmp_path_factory.mktemp("jaxckpt")
    jc, _ = _train_cfgs()
    jstate = _write_jax(str(root / "ckpt"), jc)
    tool = _load(os.path.join("tools", "export_hf.py"), "export_hf")
    out = str(root / "jax_ema_frozen")
    tool.main(["--ckpt_dir", str(root / "ckpt"), "--out", out, "--tiny", "--ema",
               "--include_frozen"])
    raw = {t: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in export_params(
        jstate.params[t], KINDS[t], mutual_dims=_dims() if t == "fashion_encoder" else None
    ).items()} for t in ("unet", "fashion_encoder")}
    return str(root / "ckpt"), out, raw


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("variant", ["ema_frozen", "raw", "ema", "frozen"])
def test_export_is_the_jax_tools_files(jax_ckpt, tmp_path, variant):
    """The port's export of the JAX checkpoint: the JAX tool's file names and
    keys, its dtypes (fp32, as the store holds them), bit-equal tensors; the
    EMA weights with `--ema`, the raw ones without, the frozen towers with
    `--include_frozen` only."""
    ckpt, jax_out, raw = jax_ckpt
    ema, frozen = "ema" in variant, "frozen" in variant
    out = str(tmp_path / "port")
    script = _load(os.path.join("scripts", "export_hf_torch.py"), "export_hf_torch")
    report = script.main(["--ckpt_dir", ckpt, "--out", out, "--tiny"]
                         + (["--ema"] if ema else []) + (["--include_frozen"] if frozen else []))
    assert report["step"] == 2
    towers = ["fashion_encoder", "unet"] + (["text_encoder", "vae"] if frozen else [])
    want_files = sorted(os.path.join(t, "model.safetensors" if t == "text_encoder"
                                     else "diffusion_pytorch_model.safetensors") for t in towers)
    assert _files(out) == want_files
    for rel in want_files:
        tower = rel.split(os.sep)[0]
        got = load_file(os.path.join(out, rel))
        want = (raw[tower] if tower in raw and not ema
                else load_file(os.path.join(jax_out, rel)))
        assert set(got) == set(want), rel
        for k, v in want.items():
            assert got[k].dtype == v.dtype == torch.float32 and torch.equal(got[k], v), (rel, k)
    if not ema:   # the raw weights differ from the EMA ones
        ema_unet = load_file(os.path.join(jax_out, "unet", "diffusion_pytorch_model.safetensors"))
        assert not torch.equal(raw["unet"]["conv_in.weight"], ema_unet["conv_in.weight"])


def test_export_reads_in_the_jax_importer(jax_ckpt, tmp_path):
    """The port's `--ema --include_frozen` export read by JAX's
    `import_sd_checkpoint` and by the port's: a tiny UNet forward in each
    agrees within 2e-5."""
    ckpt, _, _ = jax_ckpt
    out = str(tmp_path / "port")
    script = _load(os.path.join("scripts", "export_hf_torch.py"), "export_hf_torch")
    script.main(["--ckpt_dir", ckpt, "--out", out, "--tiny", "--ema", "--include_frozen"])
    jparams = jax_import_sd(out, _jax_params(11))
    cfg = Config.preset_tiny().model
    model = import_sd_checkpoint(out, create_difashion(cfg, seed=5, device="cpu"))
    rng = np.random.RandomState(0)
    u = cfg.unet
    x = rng.randn(2, u.sample_size, u.sample_size, u.in_channels).astype(np.float32)
    tvals = np.array([17, 503], np.int64)
    ctx = rng.randn(2, 77, u.cross_attention_dim).astype(np.float32)
    from difashion_tpu.core.config import ModelConfig as JModelConfig

    want = np.asarray(jax.jit(JUNet(JModelConfig.tiny().unet).apply)(
        {"params": jparams["unet"]}, jnp.asarray(x), jnp.asarray(tvals), jnp.asarray(ctx)))
    with torch.no_grad():
        got = nhwc(model.unet(nchw(x), torch.from_numpy(tvals), torch.from_numpy(ctx)))
    np.testing.assert_allclose(got, want, **UNET_TOL)

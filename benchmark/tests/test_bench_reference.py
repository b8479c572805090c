"""The plain reference agrees with the port at the tiny preset on the CPU:
each tower, a whole GOR generation through the pipeline, and the training
steps, when the port computes in fp32 as the reference does."""
from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark.core import harness
from benchmark.core.weights import make_weights, reference_towers


@pytest.mark.parametrize("sd15", [False, True])
def test_towers_match_the_port_in_fp32(sd15):
    from benchmark.tests.conftest import tiny_model
    from difashion_tpu_torch.config import Config
    from difashion_tpu_torch.models.difashion import DiFashion
    from difashion_tpu_torch.weights import load_difashion

    mc = tiny_model(sd15)
    with torch.device("meta"):
        prog = DiFashion(Config.from_dict({"model": mc}).model)
    prog = prog.to_empty(device="cpu")
    load_difashion(prog, make_weights(mc, 7, "cpu", torch.float32))
    prog.eval()
    ref = reference_towers(mc, 7, "cpu", torch.float32)
    g = torch.Generator().manual_seed(0)
    x, t = torch.randn(3, 8, 8, 8, generator=g), torch.tensor([10, 500, 990])
    ctx, z = torch.randn(3, 77, 32, generator=g), torch.randn(2, 4, 8, 8, generator=g)
    ids = torch.randint(0, 1000, (2, 77), generator=g)
    with torch.no_grad():
        pairs = [(prog.unet(x, t, ctx), ref["unet"](x, t, ctx)),
                 (prog.decode_latents(z), ref["vae"].decode(z)),
                 (prog.encode_text(ids), ref["text_encoder"](ids)),
                 (prog.apply_mutual(x[:, :4]), ref["fashion_encoder"](x[:, :4]))]
    for a, b in pairs:
        assert (a - b).abs().max() <= 1e-5 * (1 + b.abs().max())


def _run(base, cell, **kw):
    run = harness.Run(cell=cell, seed=2 ** 31 + 17, seconds=0.0, trace=False, device="cpu",
                      t0=time.perf_counter(), base=base)
    run.workload.update(kw)
    harness.load_runner(run.workload["runner"]).run(run)
    return run


def test_generation_matches_in_fp32(tiny_base):
    run = _run(tiny_base, "tiny.gor", dtype="float32")
    assert run.checks["image_mean_abs_levels"].value < 1e-2   # a level flips at most


def test_training_steps_match_in_fp32(tiny_base):
    w = json.loads((tiny_base / "workloads" / "tiny.train.json").read_text())
    run = _run(tiny_base, "tiny.train", recipe=dict(w["recipe"], mixed_precision="no"))
    got = {k: c.value for k, c in run.checks.items()}
    assert got["loss_rel_gap"] < 1e-5 and got["grad_leaf_gap"] < 1e-5
    # Adam's first steps are sign-like, so a last-digit difference in a
    # near-zero gradient moves an element by up to lr: a few 1e-5 of a leaf
    assert got["change_leaf_gap"] < 1e-3 and got["ema_change_leaf_gap"] < 1e-3


def test_sound_runs_pass_their_limits(tiny_base):
    for cell in ("tiny.gor", "tiny15.gor", "tiny.train"):
        run = _run(tiny_base, cell)
        assert all(c.ok for c in run.checks.values()), (cell, run.checks)

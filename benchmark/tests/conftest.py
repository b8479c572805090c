"""Fixtures of the benchmark's CPU tests: a folder of tiny cells made from
the real cells' files (the tiny preset's widths, fewer steps and rows, the
real limits), and the card check of the tests marked `cuda`."""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"
GEN_CELL, TRAIN_CELL = "sd2_base.gor_pndm50", "sd2_base.train_b8"


def tiny_model(sd15: bool = False) -> dict:
    from difashion_tpu_torch.config import ModelConfig

    mc = dataclasses.asdict(ModelConfig.tiny())
    if sd15:   # conv projections, fixed heads, head dims 16 / 32
        mc["unet"].update(use_linear_projection=False, fixed_num_heads=2)
    return mc


@pytest.fixture(scope="session")
def tiny_base(tmp_path_factory) -> Path:
    """benchmark-like folder: configs tiny / tiny15, workloads tiny.gor,
    tiny15.gor, tiny.train; the real cells' parameters at small sizes."""
    base = tmp_path_factory.mktemp("bench")
    (base / "configs").mkdir()
    (base / "workloads").mkdir()
    for name, sd15 in (("tiny", False), ("tiny15", True)):
        (base / "configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "reduced": [], "model": tiny_model(sd15)}))
    gen = json.loads((BENCH / "workloads" / f"{GEN_CELL}.json").read_text())
    gen["generation"].update(num_inference_steps=3, height=64, width=64)
    gen["traffic"]["batches"] = 2
    for name in ("tiny", "tiny15"):
        (base / "workloads" / f"{name}.gor.json").write_text(json.dumps(dict(gen, config=name)))
    train = json.loads((BENCH / "workloads" / f"{TRAIN_CELL}.json").read_text())
    train["traffic"].update(items=256, steps=8, outfits_per_step=2)
    # at the tiny widths on the CPU, bf16 autocast lands as far from fp32 as
    # the fp8 control on some seeds (leaves of a few hundred elements); the
    # recipe's fp32 path is the sound run these tests hold to the limits
    train["recipe"].update(mixed_precision="no", train_batch_size=2)
    (base / "workloads" / "tiny.train.json").write_text(json.dumps(dict(train, config="tiny")))
    return base


@pytest.fixture
def card():
    """Skips a `cuda` test where there is no card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")

"""Generation CLI: FITB / GOR over a split's outfit table, for evaluation.
Counterpart of `difashion_tpu/cli/generate.py`.

    python -m difashion_tpu_torch generate --data_path <dir> --ckpt_dir <ckpt> \
        [--task FITB|GOR] [--mode valid|test] [--tiny] [--device cuda|cpu]

Restores a checkpoint of the port's store, or one that the JAX package's
`train` wrote (flax msgpack, `checkpoint.py`), copies its EMA weights into the
model, runs the generation pipeline over the split and writes the JPEG tree
and manifests under the reference's run name
`<TASK>-checkpoint-<step>-cate<cs>-mutual<ms>-hist<hs>`. Runs on the card
unless `--device cpu`; the JPEGs need PIL.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from difashion_tpu_torch.checkpoint import CheckpointStore
from difashion_tpu_torch.cli.common import (
    apply_generation_overrides,
    load_config,
    setup_logging,
)
from difashion_tpu_torch.config import Config
from difashion_tpu_torch.data.datasets import FashionData, HistLatentStore
from difashion_tpu_torch.data.precompute import load_processed
from difashion_tpu_torch.data.tokenizer import load_tokenizer
from difashion_tpu_torch.engine.pipeline import GenerationPipeline
from difashion_tpu_torch.engine.train import EMAState, TrainState
from difashion_tpu_torch.models.difashion import create_difashion
from difashion_tpu_torch.weights import load_tower


def load_model_for_inference(cfg: Config, ckpt_dir: str, step: Optional[int] = None,
                             use_ema: bool = True, device="cuda"):
    """Build the model (bf16 under the bf16 recipe, else fp32), restore a
    checkpoint's trainable weights, load the frozen towers where the store
    has them, and copy the EMA weights in. Returns (model, step)."""
    dtype = torch.bfloat16 if cfg.train.mixed_precision == "bf16" else torch.float32
    model = create_difashion(cfg.model, seed=cfg.train.seed, device=device, dtype=dtype)
    named = model.trainable_parameters()
    params = [p for _, p in named]
    ema = EMAState(params=[torch.empty_like(p) for p in params], step=0) if use_ema else None
    template = TrainState(names=[n for n, _ in named], params=params, opt_state=None, ema=ema)
    store = CheckpointStore(ckpt_dir)
    state = store.load(template, step, mutual_dims=(
        cfg.model.mutual.latent_channels, cfg.model.mutual.latent_size))
    if store.has_frozen():
        for tower, sd in store.load_frozen().items():
            load_tower(getattr(model, tower), sd, tower)
    if state.ema is not None:
        with torch.no_grad():
            for p, e in zip(state.params, state.ema.params):
                p.copy_(e)
    return model.eval(), int(state.step)


def run_name(task: str, step: int, cfg: Config) -> str:
    g = cfg.generation
    return (f"{task}-checkpoint-{step}-cate{g.category_guidance_scale}"
            f"-mutual{g.mutual_guidance_scale}-hist{g.hist_guidance_scale}")


def item_latents_and_hist(cfg: Config, data_path: str, history: dict):
    """The catalog's scaled latents from `processed/all_item_moments.npz`
    (None without it) and the history store over them."""
    proc = load_processed(data_path, "all_item_moments")
    item_latents = proc["mean"] * cfg.model.vae.scaling_factor if proc is not None else None
    s, C = cfg.model.unet.sample_size, cfg.model.vae.latent_channels
    catalog = item_latents if item_latents is not None else np.zeros((1, s, s, C), np.float32)
    return item_latents, HistLatentStore.from_catalog(history, catalog)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DiFashion generation (PyTorch/CUDA)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--ckpt_step", type=int, default=None, help="default: latest")
    p.add_argument("--task", choices=["FITB", "GOR"], default="FITB")
    p.add_argument("--mode", choices=["valid", "test"], default="test")
    p.add_argument("--output_dir", default="generated")
    p.add_argument("--config", default=None)
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--num_inference_steps", type=int, default=None)
    p.add_argument("--category_guidance_scale", type=float, default=None)
    p.add_argument("--hist_guidance_scale", type=float, default=None)
    p.add_argument("--mutual_guidance_scale", type=float, default=None)
    p.add_argument("--scheduler", choices=["pndm", "ddim", "dpmpp"], default=None)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--no_ema", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="permit the hash-tokenizer fallback (outputs will be "
                        "meaningless; tests/throughput only)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    log = setup_logging()
    cfg = apply_generation_overrides(load_config(args.config, args.tiny), **{
        k: getattr(args, k) for k in ("num_inference_steps", "category_guidance_scale",
                                      "hist_guidance_scale", "mutual_guidance_scale",
                                      "scheduler")})
    tokenizer = load_tokenizer(args.tokenizer_dir, cfg.model.text.vocab_size,
                               strict=not args.allow_random_weights)
    model, step = load_model_for_inference(cfg, args.ckpt_dir, args.ckpt_step,
                                           use_ema=not args.no_ema, device=args.device)
    log.info("loaded checkpoint-%d (ema=%s) on %s", step, not args.no_ema, args.device)

    data = FashionData.load(args.data_path)
    item_latents, hist_store = item_latents_and_hist(cfg, args.data_path,
                                                     data.history.get(args.mode, {}))
    pipe = GenerationPipeline(model, cfg, data.id_cate_dict, tokenizer, hist_store,
                              item_latents=item_latents)
    table = data.fitb_valid if args.mode == "valid" else data.fitb_test
    grd = data.valid_grd if args.mode == "valid" else data.test_grd
    out = pipe.run(table, args.task, args.output_dir, run_name(args.task, step, cfg),
                   grd_dict=grd, seed=args.seed, max_batches=args.max_batches)
    log.info("generation complete: %s", out)
    return out


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Export a checkpoint to diffusers-layout safetensors with the PyTorch port:
the counterpart of `tools/export_hf.py`, with its flags and its files.

    python3 scripts/export_hf_torch.py --ckpt_dir ckpt [--step N] --out exported/ \
        [--ema] [--include_frozen] [--tiny] [--config cfg.json]

Writes `<out>/unet/diffusion_pytorch_model.safetensors` and
`<out>/fashion_encoder/diffusion_pytorch_model.safetensors` (with
`--include_frozen` also `vae/diffusion_pytorch_model.safetensors` and
`text_encoder/model.safetensors`): the checkpoint's fp32 weights (`--ema`:
its EMA weights) under the diffusers / transformers keys, written by the
port's own safetensors writer (`core/importer.py::export_checkpoint`). The
checkpoint may be the port's or the JAX package's. With `--tiny` the export
runs on the CPU, otherwise on the card. Prints one JSON line of the files,
their bytes and seconds.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="checkpoint -> diffusers safetensors (PyTorch)")
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--ema", action="store_true",
                   help="export the EMA weights (the reference's released form)")
    p.add_argument("--include_frozen", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--config", default=None)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from difashion_tpu_torch.cli.common import load_config, setup_logging
    from difashion_tpu_torch.core.importer import export_checkpoint

    setup_logging()
    cfg = load_config(args.config, args.tiny)
    report = export_checkpoint(cfg, args.ckpt_dir, args.out, step=args.step, ema=args.ema,
                               include_frozen=args.include_frozen,
                               device="cpu" if args.tiny else "cuda")
    print(json.dumps({"exported_step": report["step"], "ema": args.ema, **report}), flush=True)
    return report


if __name__ == "__main__":
    main()

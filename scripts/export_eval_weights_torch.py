#!/usr/bin/env python3
"""Write a complete evaluation `weights_dir` with the PyTorch port (the
weights-arrival drill): the counterpart of `tools/export_eval_weights.py`,
with its flags and its files.

    python3 scripts/export_eval_weights_torch.py --out eval_weights/ [--tiny] [--seed 0] \
        [--num_classes 50] [--n_merges 200]

Builds every evaluation tower with seeded random weights (ViT-H/14 image and
text, the FID and the finetuned InceptionV3, VGG16 and the LPIPS heads, the
compatibility net; the tiny ones with `--tiny`) and writes the files that
`eval/extractors.py::build_extractors` reads, plus a CLIP-shaped
`tokenizer/` (`eval/models/exporters.py`). With that directory the strict
`parity` command (no `--allow_random_weights`) runs before any real weights
exist. With `--tiny` it runs on the CPU, otherwise on the card. Prints one
JSON line of the files, their bytes and seconds.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="evaluation weights directory (PyTorch)")
    p.add_argument("--out", required=True)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_classes", type=int, default=50)
    p.add_argument("--n_merges", type=int, default=200)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from difashion_tpu_torch.eval.models.exporters import export_weights_dir

    files = export_weights_dir(args.out, tiny=args.tiny, seed=args.seed,
                               num_classes=args.num_classes, n_merges=args.n_merges,
                               device="cpu" if args.tiny else "cuda")
    print(json.dumps({"out": args.out, "files": files}), flush=True)
    return files


if __name__ == "__main__":
    main()

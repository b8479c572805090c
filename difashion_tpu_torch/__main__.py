"""Command dispatcher: `python -m difashion_tpu_torch <command> [...]`.

Commands (each runs on the card unless given `--device cpu`):
  train              the fine-tuning loop (checkpoints, resume, metrics)
  extract-features   catalog VAE moments and CLIP features (`--stage vae|clip|all`)
  generate           FITB / GOR generation of a split into a JPEG tree
  evaluate           the metric cascades over generated runs (`--task`, `--grounding`)
  parity             generate -> evaluate -> the table against the reference, FID / LPIPS
                     gated at 2 % (`--allow_random_weights`: plumbing runs only)
  serve              the HTTP generation service
  info               the visible devices and the training state's memory plan

On the CPU at the tiny sizes (tests and plumbing): `evaluate --tiny --device cpu
--allow_random_weights ...` and `parity --tiny --device cpu --allow_random_weights ...`
with the flags each prints under `--help`; on the card the same without
`--tiny --device cpu`. The mid-scale learning proof is a script:
`python3 scripts/learning_proof_cuda.py [--steps 6000]` (train -> generate ->
the reconstruction gates; its report goes to `scripts/logs/`).
"""
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "train":
        from difashion_tpu_torch.cli.train import main as run
    elif cmd in ("extract-features", "extract_features"):
        from difashion_tpu_torch.cli.extract_features import main as run
    elif cmd == "generate":
        from difashion_tpu_torch.cli.generate import main as run
    elif cmd == "evaluate":
        from difashion_tpu_torch.cli.evaluate import main as run
    elif cmd == "parity":
        from difashion_tpu_torch.cli.parity import main as run
    elif cmd == "serve":
        from difashion_tpu_torch.cli.serve import main as run
    elif cmd == "info":
        from difashion_tpu_torch.cli.info import main as run
    else:
        print(f"unknown command {cmd!r}\n{__doc__}")
        return 2
    run(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())

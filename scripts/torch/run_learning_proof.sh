#!/usr/bin/env bash
# Mid-scale learning proof with the PyTorch port: a 64 px DiFashion overfit
# through the port's train -> generate commands with the production 4-branch
# CFG and 50-step PNDM, gated on image-space reconstruction. Report:
# scripts/logs/learning_proof_cuda.json (see scripts/learning_proof_cuda.py;
# `--tiny --device cpu` runs the CPU-sized proof). WORKDIR keeps the fixture,
# checkpoints and runs (default: a temporary directory, deleted at the end).
set -euo pipefail
cd "$(dirname "$0")/../.."
exec python scripts/learning_proof_cuda.py ${WORKDIR:+--workdir "$WORKDIR"} \
  --steps "${STEPS:-6000}" --img "${IMG:-64}" \
  --inference_steps "${INFERENCE_STEPS:-50}" "$@"

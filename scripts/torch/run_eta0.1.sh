#!/bin/sh
# Canonical training recipe with the PyTorch port: the reference's
# run_eta0.1.sh (lr 1e-5, eta 0.1, min-SNR gamma 5.0, bsz 2, EMA on, 20k
# steps, bf16 autocast), resumed from the latest checkpoint, on the card.
python -m difashion_tpu_torch train \
    --data_path "${DATA_PATH:-datasets/polyvore}" \
    --output_dir "${OUTPUT_DIR:-ckpt}" \
    --pretrained_dir "${PRETRAINED_DIR:-}" \
    --resume_from_checkpoint latest "$@" 2>&1 | tee train.log

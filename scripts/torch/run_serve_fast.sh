#!/bin/sh
# Fast-serving recipe with the PyTorch port: the warm-model HTTP service with
# the DPM-Solver++(2M) 20-step scheduler, on the card. Drop
# --scheduler/--num_inference_steps for the reference-parity PNDM-50 path.
python -m difashion_tpu_torch serve \
    --data_path "${DATA_PATH:-datasets/polyvore}" \
    --ckpt_dir "${CKPT_DIR:-ckpt}" \
    --scheduler dpmpp --num_inference_steps 20 \
    --port "${PORT:-8080}" 2>&1 | tee serve.log

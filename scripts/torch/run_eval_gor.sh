#!/bin/sh
# GOR evaluation recipe with the PyTorch port (reference
# Evaluation/run_eval_gor.sh).
python -m difashion_tpu_torch evaluate \
    --data_path "${DATA_PATH:-datasets/polyvore}" \
    --gen_dir "${GEN_DIR:-generated}" --task GOR --mode "${1:-test}" \
    --weights_dir "${EVAL_WEIGHTS:-eval_weights}" "$@" 2>&1 | tee eval_gor.log

#!/bin/sh
# Grounding evaluation recipes with the PyTorch port (reference
# run_eval_grounding_{fitb,gor}.sh).
TASK="${1:-FITB}"
python -m difashion_tpu_torch evaluate \
    --data_path "${DATA_PATH:-datasets/polyvore}" \
    --gen_dir "${GEN_DIR:-generated}" --task "$TASK" --mode "${2:-test}" \
    --grounding --weights_dir "${EVAL_WEIGHTS:-eval_weights}" 2>&1 | tee "eval_grounding_${TASK}.log"

#!/bin/sh
# Generation-for-evaluation recipe with the PyTorch port (reference
# run_inf4eval.sh): TASK={FITB,GOR}, MODE={valid,test}; 50-step PNDM, scales
# cate 12 / mutual 5 / hist 4, on the card.
TASK="${1:-FITB}"; MODE="${2:-test}"
python -m difashion_tpu_torch generate \
    --data_path "${DATA_PATH:-datasets/polyvore}" \
    --ckpt_dir "${CKPT_DIR:-ckpt}" \
    --task "$TASK" --mode "$MODE" \
    --output_dir "${GEN_DIR:-generated}" 2>&1 | tee "inf4eval_${TASK}_${MODE}.log"

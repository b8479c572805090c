#!/bin/sh
# Catalog feature extraction with the PyTorch port (reference
# Evaluation/extract_hist_embs.sh + the preprocess_dataset VAE cache): VAE
# moments, CLIP features and history means, on the card.
python -m difashion_tpu_torch extract-features \
    --data_path "${DATA_PATH:-datasets/polyvore}" \
    --img_folder_path "${IMG_FOLDER:-images}" \
    --image_paths_npy "${IMAGE_PATHS:-all_item_image_paths.npy}" "$@" 2>&1 | tee extract_features.log

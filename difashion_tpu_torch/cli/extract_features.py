"""Feature-extraction CLI, `--stage vae`: the catalog's VAE moments and the
scaled modes, as `difashion_tpu/cli/extract_features.py` writes them
(`processed/all_item_moments.npz`, `processed/all_item_latents.npy`).

    python -m difashion_tpu_torch extract-features --stage vae \
        --data_path <dir> --img_folder_path <images> --image_paths_npy <npy> [--tiny]

Runs on the card unless `--device cpu`, in fp32 as the JAX CLI does. The
catalog CLIP features (`--stage clip`, and `all`) come with the evaluation
slice and raise NotImplementedError. `--pretrained_dir` reads the VAE (and
the other SD towers) from a local diffusers directory
(`core/importer.py::import_sd_checkpoint`); without it the VAE has the
port's seeded random weights (seed 0), as the JAX CLI runs without
`--pretrained_dir`.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from difashion_tpu_torch.config import Config
from difashion_tpu_torch.data.datasets import load_npy
from difashion_tpu_torch.data.precompute import (
    encode_catalog,
    moments_to_scaled_modes,
    save_processed,
)

log = logging.getLogger("difashion_tpu_torch")


def make_item_loader(img_folder: str, image_paths, size: int):
    """The PIL catalog pipeline (white composite -> pad to a white square ->
    LANCZOS resize), as [size, size, 3] float32 in [-1, 1]."""
    from PIL import Image

    from difashion_tpu_torch.data.preprocessing import prepare_catalog_image

    def load(iid: int):
        img = Image.open(os.path.join(img_folder, str(image_paths[iid])))
        arr = np.asarray(prepare_catalog_image(img, size=size), np.float32)
        return 2.0 * (arr / 255.0) - 1.0

    return load


def main(argv=None):
    p = argparse.ArgumentParser(description="DiFashion feature extraction (PyTorch/CUDA)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--img_folder_path", required=True)
    p.add_argument("--image_paths_npy", required=True)
    p.add_argument("--stage", choices=["vae", "clip", "all"], default="all")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--clip_batch_size", type=int, default=200)
    p.add_argument("--weights_dir", default=None)
    p.add_argument("--pretrained_dir", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.stage != "vae":
        raise NotImplementedError(
            f"--stage {args.stage}: the catalog CLIP features come with the port's "
            "evaluation slice; run --stage vae")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    from difashion_tpu_torch.models.difashion import create_difashion

    cfg = Config.preset_tiny() if args.tiny else Config.preset_eta01()
    image_paths = load_npy(args.image_paths_npy)
    n_items = len(image_paths)
    model = create_difashion(cfg.model, seed=0, device=args.device)
    if args.pretrained_dir:
        from difashion_tpu_torch.core.importer import import_sd_checkpoint

        import_sd_checkpoint(args.pretrained_dir, model)
        log.info("imported pretrained SD weights from %s", args.pretrained_dir)
    loader = make_item_loader(args.img_folder_path, image_paths, cfg.model.vae.sample_size)
    log.info("VAE-encoding %d catalog items on %s ...", n_items, args.device)
    moments = encode_catalog(model, loader, n_items, batch_size=args.batch_size,
                             device=args.device)
    save_processed(args.data_path, "all_item_moments", **moments)
    np.save(os.path.join(args.data_path, "processed", "all_item_latents.npy"),
            moments_to_scaled_modes(moments, cfg.model.vae.scaling_factor))
    log.info("saved all_item_moments.npz / all_item_latents.npy")


if __name__ == "__main__":
    main()

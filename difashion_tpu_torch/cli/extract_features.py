"""Feature-extraction CLI, as `difashion_tpu/cli/extract_features.py` writes
its files:
  * `--stage vae`: the catalog's VAE moments and scaled modes
    (`processed/all_item_moments.npz`, `processed/all_item_latents.npy`);
  * `--stage clip`: the catalog's CLIP image features
    (`processed/cnn_features_clip.npy`, [n_items, 1024]) and each history
    split's per-(user, category) mean of them
    (`processed/{split}_history_clipembs.npy`);
  * `--stage all` (the default): both.

    python -m difashion_tpu_torch extract-features --stage vae|clip|all \
        --data_path <dir> --img_folder_path <images> --image_paths_npy <npy> \
        [--weights_dir <eval weights>] [--pretrained_dir <diffusers dir>] [--tiny]

Runs on the card unless `--device cpu`, in fp32 as the JAX CLI does (under
torch's default flags: TF32 off for matmuls, on for cuDNN's convolutions).
The VAE stage's item loader is the native C++ pipeline (`data/native.py`,
built at first use) and the PIL one where that cannot be built; the CLIP
stage reads each catalog image with the training transform at 512 px
(`data/preprocessing.py::load_catalog_image`), as the JAX CLI does.
`--pretrained_dir` reads the VAE (and the other SD towers) from a local
diffusers directory (`core/importer.py::import_sd_checkpoint`); without it
the VAE has the port's seeded random weights (seed 0), as the JAX CLI runs
without `--pretrained_dir`. `--weights_dir` holds the evaluation towers'
files (`eval/extractors.py`); without them the CLIP tower has seeded random
weights, with a warning.
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
    """The catalog pipeline (white composite -> pad to a white square ->
    Lanczos resize) as iid -> [size, size, 3] float32 in [-1, 1]: the native
    library's where it builds, else PIL's (the same pipeline, not the
    training transform: the moments must not depend on the machine). The
    returned function's `kind` says which ("native" or "pil")."""
    from difashion_tpu_torch.data import native

    if native.native_available():
        def load(iid: int):
            return native.prepare_image(os.path.join(img_folder, str(image_paths[iid])),
                                        size=size)

        load.kind = "native"
        return load
    log.warning("taking the PIL catalog pipeline (%s)", native.unavailable())
    from PIL import Image

    from difashion_tpu_torch.data.preprocessing import prepare_catalog_image

    def load(iid: int):
        img = Image.open(os.path.join(img_folder, str(image_paths[iid])))
        arr = np.asarray(prepare_catalog_image(img, size=size), np.float32)
        return 2.0 * (arr / 255.0) - 1.0

    load.kind = "pil"
    return load


def run_clip_stage(args, image_paths) -> dict:
    """The catalog's CLIP features and each history split's mean of them,
    written under `processed/`. Returns {file stem: path}."""
    from difashion_tpu_torch.data.datasets import FashionData
    from difashion_tpu_torch.data.preprocessing import load_catalog_image
    from difashion_tpu_torch.eval.drivers import (
        extract_catalog_clip_features,
        process_history_clip_embs,
    )
    from difashion_tpu_torch.eval.extractors import build_extractors

    data = FashionData.load(args.data_path)
    X = build_extractors(args.weights_dir, batch_size=args.clip_batch_size, tiny=args.tiny,
                         device=args.device)

    def loader01(iid: int):
        img = load_catalog_image(os.path.join(args.img_folder_path, str(image_paths[iid])),
                                 size=512)
        return (img + 1.0) / 2.0

    n_items = len(image_paths)
    log.info("CLIP-encoding %d catalog items on %s ...", n_items, args.device)
    feats = extract_catalog_clip_features(X, loader01, n_items,
                                          batch_size=args.clip_batch_size)
    out_dir = os.path.join(args.data_path, "processed")
    os.makedirs(out_dir, exist_ok=True)
    files = {"cnn_features_clip": os.path.join(out_dir, "cnn_features_clip.npy")}
    np.save(files["cnn_features_clip"], feats)
    for split, hist in data.history.items():
        stem = f"{split}_history_clipembs"
        files[stem] = os.path.join(out_dir, stem + ".npy")
        np.save(files[stem], np.array(process_history_clip_embs(hist, feats), dtype=object))
        log.info("saved %s.npy", stem)
    return files


def run_vae_stage(args, image_paths) -> None:
    """The catalog's VAE moments and scaled modes, written under `processed/`."""
    from difashion_tpu_torch.models.difashion import create_difashion

    cfg = Config.preset_tiny() if args.tiny else Config.preset_eta01()
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


def parse_args(argv=None):
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
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    image_paths = load_npy(args.image_paths_npy)
    if args.stage in ("vae", "all"):
        run_vae_stage(args, image_paths)
    if args.stage in ("clip", "all"):
        run_clip_stage(args, image_paths)


if __name__ == "__main__":
    main()

"""Catalog precompute: VAE moments for every catalog item, the history means
and the tokenized prompts, written as the `processed/` cache.

Counterpart of `difashion_tpu/data/precompute.py`, with the same files, names,
keys and dtypes, so a cache written by either package loads in the other
(all under `<data_path>/processed/`):
  * all_item_moments.npz: mean, logvar [N, h, w, C] fp32 (unscaled, NHWC);
  * all_item_latents.npy: mode * scaling_factor [N, h, w, C] fp32;
  * {split}_hist_latents.npy: a pickled {uid: {cid: mean latent}} dict with a
    "null" entry (the latent of item 0, the white image);
  * new_{train,fitb_valid,fitb_test}.npz: the outfit tables with per-outfit
    `input_ids` [olen, 77] of the training prompts.

The encoder runs eagerly under `inference_mode`, each GroupNorm through the
GroupNorm kernel on CUDA; a ragged last batch is encoded at its own size
(nothing is compiled for a fixed shape, so the JAX package's padding is not
needed).
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Union

import numpy as np
import torch

from difashion_tpu_torch.data.datasets import HistLatentStore, OutfitTable
from difashion_tpu_torch.data.prompts import build_train_prompts
from difashion_tpu_torch.models.difashion import DiFashion


def encode_catalog(model: DiFashion, image_loader: Callable[[int], np.ndarray],
                   num_items: int, batch_size: int = 64,
                   device: Union[str, torch.device] = "cuda") -> dict:
    """VAE-encode items 0 .. num_items - 1 in batches of `batch_size`.
    `image_loader(i)` -> [H, W, 3] in [-1, 1]; the model's VAE lies on
    `device`. Returns {"mean", "logvar"}: unscaled, fp32 numpy [N, h, w, C]."""
    device = torch.device(device)
    means, logvars = [], []

    def fetch(dist):
        means.append(dist.mean.float().permute(0, 2, 3, 1).cpu().numpy())
        logvars.append(dist.logvar.float().permute(0, 2, 3, 1).cpu().numpy())

    with torch.inference_mode():
        dist = None
        for start in range(0, num_items, batch_size):
            end = min(start + batch_size, num_items)
            # the host loads this batch while the device encodes the last one
            imgs = np.stack([image_loader(i) for i in range(start, end)]).astype(np.float32)
            if dist is not None:
                fetch(dist)
            # NHWC images seen as channels-last [B, 3, H, W]: the VAE's layout
            dist = model.vae.encode(torch.from_numpy(imgs).to(device).permute(0, 3, 1, 2))
        fetch(dist)
    return {"mean": np.concatenate(means, axis=0),
            "logvar": np.concatenate(logvars, axis=0)}


def moments_to_scaled_modes(moments: dict, scaling_factor: float) -> np.ndarray:
    """mode() * scaling_factor: the `all_item_latents.npy` contract."""
    return moments["mean"] * scaling_factor


def tokenize_outfits(table: OutfitTable, id_cate_dict, tokenizer) -> np.ndarray:
    """Per-outfit [olen, 77] input_ids of the training prompts. Returns
    [N, olen, 77] int32."""
    N, olen = table.category.shape
    if N == 0:
        return np.zeros((0, olen, 77), np.int32)
    # tokenize each unique category once; outfits index into the table
    unique_cids = np.unique(table.category).astype(int).tolist()
    ids = tokenizer(build_train_prompts(unique_cids, id_cate_dict))     # [U, 77]
    cid_to_row = {c: i for i, c in enumerate(unique_cids)}
    rows = np.vectorize(cid_to_row.get, otypes=[np.int64])(table.category)
    return ids[rows].astype(np.int32)


def build_processed_cache(data_path: str, data, id_cate_dict, tokenizer, moments: dict,
                          scaling_factor: float) -> dict:
    """Write the `processed/` cache (see the module's docstring) from the
    catalog's moments. Returns {artifact name: path}."""
    out = {}
    pdir = os.path.join(data_path, "processed")
    os.makedirs(pdir, exist_ok=True)

    all_latents = moments_to_scaled_modes(moments, scaling_factor)
    np.save(os.path.join(pdir, "all_item_latents.npy"), all_latents)
    np.savez(os.path.join(pdir, "all_item_moments.npz"), **moments)
    out["all_item_latents"] = os.path.join(pdir, "all_item_latents.npy")

    for name, table in (("new_train", data.train),
                        ("new_fitb_valid", data.fitb_valid),
                        ("new_fitb_test", data.fitb_test)):
        if table is None:
            continue
        ids = tokenize_outfits(table, id_cate_dict, tokenizer)
        p = os.path.join(pdir, name + ".npz")
        np.savez(p, uids=table.uids, oids=table.oids, outfits=table.outfits,
                 category=table.category, input_ids=ids)
        out[name] = p

    for split, hist in data.history.items():
        store = HistLatentStore.from_catalog(hist, all_latents)
        payload = dict(store.hist)
        payload["null"] = store.null
        p = os.path.join(pdir, f"{split}_hist_latents.npy")
        np.save(p, np.array(payload, dtype=object))
        out[f"{split}_hist_latents"] = p
    return out


def save_processed(data_path: str, name: str, **arrays) -> None:
    os.makedirs(os.path.join(data_path, "processed"), exist_ok=True)
    np.savez(os.path.join(data_path, "processed", name + ".npz"), **arrays)


def load_processed(data_path: str, name: str) -> Optional[dict]:
    p = os.path.join(data_path, "processed", name + ".npz")
    if not os.path.exists(p):
        return None
    with np.load(p, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}

"""Generation pipeline: FITB / GOR over an outfit table -> a JPEG tree and
manifests. Counterpart of `difashion_tpu/engine/pipeline.py`, with the same
on-disk contract:

  <out>/<TASK>-checkpoint-<step>-cate<cs>-mutual<ms>-hist<hs>/
      images/<uid>/<oid>/<i>.jpg   (one per generated slot)
      images/<uid>/<oid>/all.jpg   (GOR: the merged grid)
      images/<uid>/<oid>/grd.jpg   (FITB: the merged ground-truth outfit, given images)
  <...>.npy          gen manifest {uid: {oid: {cates, full_cates, outfits, image_paths}}}
  <...>_grd.npy      grd manifest {uid: {oid: {outfits, image_paths}}}
  <...>.config.json  the run's settings

The category prompts are one 50-row text table, encoded once. A batch runs
the sampler, the VAE decode and the uint8 quantization on the device with no
host sync until its images are fetched, so `run` dispatches batch i + 1
before it writes batch i. Ragged batches are padded to fixed fill and outfit
counts and the padding dropped on save.

Initial noise: each fill draws its [h, w, C] latent from a CPU
`torch.Generator` seeded by a stable hash of (seed, uid, oid, slot), so
images do not depend on how fills are grouped into batches and a resumed run
is bit-identical to an uninterrupted one. The JAX package folds the same
identity into a threefry key; the two draw different numbers.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import struct
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from difashion_tpu_torch.config import Config
from difashion_tpu_torch.core import tracing
from difashion_tpu_torch.data.datasets import HistLatentStore, OutfitTable
from difashion_tpu_torch.data.prompts import build_train_prompts
from difashion_tpu_torch.engine.generate import (
    GenerationInputs,
    build_sampler,
    decode_to_uint8,
    make_guidance_spec,
)
from difashion_tpu_torch.models.difashion import DiFashion


def merge_images_grid(images: np.ndarray) -> np.ndarray:
    """[n, H, W, 3] uint8 -> one grid image (ceil(sqrt(n)) columns, padded
    white)."""
    n, H, W, _ = images.shape
    cols = math.ceil(math.sqrt(n))
    rows = math.ceil(n / cols)
    grid = np.full((rows * H, cols * W, 3), 255, np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = images[i]
    return grid


def save_jpeg(arr: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path, quality=95)


def fill_noise(seed: int, uids, oids, slots, shape) -> np.ndarray:
    """N(0, 1) latents [F, *shape] float32: fill k's from a CPU generator
    seeded by a stable 63-bit hash of (seed, uid, oid, slot)."""
    out = np.empty((len(uids),) + tuple(shape), np.float32)
    for k, ident in enumerate(zip(uids, oids, slots)):
        key = struct.pack("<4q", seed, *(int(i) for i in ident))
        digest = hashlib.blake2b(key, digest_size=8).digest()
        g = torch.Generator().manual_seed(int.from_bytes(digest, "little") >> 1)
        out[k] = torch.randn(tuple(shape), generator=g).numpy()
    return out


@dataclass
class PreparedBatch:
    inputs: GenerationInputs  # on the model's device
    fill_uids: np.ndarray     # [F]
    fill_oids: np.ndarray     # [F]
    fill_cate: np.ndarray     # [F]
    full_cate: np.ndarray     # [F, olen]
    olists: np.ndarray        # [F, olen] outfit item ids as fed (0 = generated slot)
    valid: np.ndarray         # [F] bool (False on pad rows)


class GenerationPipeline:
    def __init__(self, model: DiFashion, config: Config, id_cate_dict: Dict[int, str],
                 tokenizer, hist_store: Optional[HistLatentStore],
                 item_latents: Optional[np.ndarray] = None,   # [N, h, w, C] scaled modes
                 null_latent: Optional[np.ndarray] = None,    # [h, w, C] scaled white latent
                 item_image_loader=None):   # iid -> [H, W, 3] image (grd.jpg)
        self.model = model
        self.config = config
        self.tokenizer = tokenizer
        self.hist_store = hist_store
        self.item_latents = item_latents
        self.item_image_loader = item_image_loader
        self.device = next(model.parameters()).device
        g = config.generation
        self.spec = make_guidance_spec(
            g.category_guidance_scale, g.hist_guidance_scale, g.mutual_guidance_scale,
            use_history=config.train.use_history,
            use_mutual=config.train.use_mutual_guidance)
        if null_latent is None:
            if item_latents is not None:
                null_latent = item_latents[0]
            else:
                s = model.config.unet.sample_size
                null_latent = np.zeros((s, s, model.config.vae.latent_channels), np.float32)
        self.null_latent = np.asarray(null_latent, np.float32)

        # the category text table: one encode for all categories
        cids = sorted(id_cate_dict.keys())
        ids = tokenizer(build_train_prompts(cids, id_cate_dict))
        self.cid_row = {c: i for i, c in enumerate(cids)}
        with torch.inference_mode():
            encode = lambda a: model.encode_text(
                torch.from_numpy(np.asarray(a)).long().to(self.device)).float()
            self.cate_emb = encode(ids)                  # [n_cates, 77, D]
            self.null_emb = encode(tokenizer([""]))[0]   # [77, D]
        self.sampler = build_sampler(
            model, num_inference_steps=g.num_inference_steps, spec=self.spec, eta=g.eta,
            scheduler=g.scheduler, ddim_eta=g.ddim_eta)

    # ------------------------------------------------------------------ prep --

    @tracing.traced("gen.prepare")
    def prepare_batch(self, batch: dict, task: str, seed: int, pad_to: Optional[int] = None,
                      pad_outfits: Optional[int] = None) -> PreparedBatch:
        """batch: {uids, oids, outfits, category} host arrays; task FITB or GOR
        (GOR zeroes every slot). pad_to / pad_outfits keep the fill and outfit
        axes at fixed sizes: pad fills repeat the last fill, pad outfits
        generate nothing."""
        uids = np.asarray(batch["uids"])
        oids = np.asarray(batch["oids"])
        olists = np.asarray(batch["outfits"]).copy()
        category = np.asarray(batch["category"])
        if task == "GOR":
            olists[:] = 0
        if pad_outfits is not None and len(olists) < pad_outfits:
            padn = pad_outfits - len(olists)
            # pad with rows whose every slot is known: no fills added
            uids = np.concatenate([uids, np.repeat(uids[-1:], padn)])
            oids = np.concatenate([oids, np.repeat(oids[-1:], padn)])
            olists = np.concatenate([olists, np.ones((padn, olists.shape[1]), olists.dtype)])
            category = np.concatenate([category, np.repeat(category[-1:], padn, axis=0)])
        B, olen = olists.shape
        gen_mask = olists == 0
        fills = [(b, j) for b in range(B) for j in range(olen) if gen_mask[b, j]]
        F = len(fills)
        gen_index = np.zeros((B, olen), np.int32)
        for k, (b, j) in enumerate(fills):
            gen_index[b, j] = k
        outfit_idx = np.array([b for b, _ in fills], np.int32)
        fill_cate = np.array([category[b, j] for b, j in fills], np.int64)
        fill_uids = uids[outfit_idx]
        fill_oids = oids[outfit_idx]
        full_cate = category[outfit_idx]

        h = self.model.config.unet.sample_size
        C = self.model.config.vae.latent_channels
        if self.item_latents is not None:
            known = self.item_latents[olists.reshape(-1)].reshape(B, olen, h, h, C)
        else:
            known = np.broadcast_to(self.null_latent, (B, olen) + self.null_latent.shape)
        if self.hist_store is not None:
            hist = np.stack([self.hist_store.lookup(int(u), int(c))
                             for u, c in zip(fill_uids, fill_cate)])
        else:
            hist = np.broadcast_to(self.null_latent, (F,) + self.null_latent.shape)
        cate_rows = np.array([self.cid_row[int(c)] for c in fill_cate], np.int64)
        init = fill_noise(seed, fill_uids, fill_oids, [j for _, j in fills], (h, h, C))

        valid = np.ones(F, bool)
        if pad_to is not None and F < pad_to:
            pad = pad_to - F

            def padrow(x):
                return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)

            init, hist, cate_rows = padrow(init), padrow(hist), padrow(cate_rows)
            outfit_idx = padrow(outfit_idx)
            fill_uids, fill_oids = padrow(fill_uids), padrow(fill_oids)
            fill_cate, full_cate = padrow(fill_cate), padrow(full_cate)
            valid = np.concatenate([valid, np.zeros(pad, bool)])

        dev = self.device
        on_dev = lambda a, dtype=torch.float32: torch.from_numpy(
            np.ascontiguousarray(a)).to(device=dev, dtype=dtype)
        inputs = GenerationInputs(
            init_latents=on_dev(init),
            outfit_idx=on_dev(outfit_idx, torch.long),
            known_latents=on_dev(known),
            gen_mask=on_dev(gen_mask, torch.bool),
            gen_index=on_dev(gen_index, torch.long),
            hist_latents=on_dev(hist),
            cate_text=self.cate_emb[on_dev(cate_rows, torch.long)],
            null_text=self.null_emb,
            null_latent=on_dev(self.null_latent),
        )
        return PreparedBatch(inputs=inputs, fill_uids=fill_uids, fill_oids=fill_oids,
                             fill_cate=fill_cate, full_cate=full_cate,
                             olists=olists[outfit_idx], valid=valid)

    # ------------------------------------------------------------------- run --

    def sample(self, prep: PreparedBatch) -> torch.Tensor:
        """The sampler's final latents [F, h, w, C] (fp32, on the device)."""
        return self.sampler(prep.inputs)

    def dispatch_batch(self, prep: PreparedBatch) -> torch.Tensor:
        """Sampler, decode and uint8 quantization queued on the device: uint8
        images [F, H, W, 3] (pad rows included), without waiting for them."""
        return decode_to_uint8(self.model, self.sample(prep))

    def generate_batch(self, prep: PreparedBatch) -> np.ndarray:
        """uint8 images [F, H, W, 3] on the host (pad rows included; filter
        with prep.valid)."""
        imgs = self.dispatch_batch(prep)
        with tracing.span("gen.fetch"):
            return imgs.cpu().numpy()

    def run(self, table: OutfitTable, task: str, out_dir: str, run_name: str,
            grd_dict: Optional[dict] = None, batch_size: Optional[int] = None,
            seed: int = 123, max_batches: Optional[int] = None) -> str:
        """Iterate the table, write the JPEGs and manifests. Returns the run
        directory. A complete run is skipped untouched; a partial manifest
        (a run that stopped) is resumed, generating only the missing batches."""
        g = self.config.generation
        if batch_size is None:
            batch_size = g.fitb_batch_size if task == "FITB" else g.gor_batch_size
        run_dir = os.path.join(out_dir, run_name)
        outputs: dict = {}
        grds: dict = {}

        def row_done(i: int) -> bool:
            return int(table.oids[i]) in outputs.get(int(table.uids[i]), {})

        if os.path.exists(run_dir + ".npy"):
            outputs = np.load(run_dir + ".npy", allow_pickle=True).item()
            if os.path.exists(run_dir + "_grd.npy"):
                grds = np.load(run_dir + "_grd.npy", allow_pickle=True).item()
            if all(row_done(i) for i in range(len(table))):
                return run_dir   # complete: untouched
        os.makedirs(run_dir, exist_ok=True)
        olen = table.outfits.shape[1]
        pad_to = batch_size * (olen if task == "GOR" else 1)

        with open(run_dir + ".config.json", "w") as f:
            json.dump({"task": task, "seed": seed, "batch_size": batch_size,
                       "max_batches": max_batches, "generation": dataclasses.asdict(g),
                       "n_rows": len(table),
                       "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())},
                      f, indent=2)

        n_batches = -(-len(table) // batch_size)
        if max_batches is not None:
            n_batches = min(n_batches, max_batches)

        def drain(pending):
            prep, imgs_dev = pending
            self._save_batch(prep, imgs_dev.cpu().numpy(), run_dir, task, outputs, grds,
                             grd_dict)
            np.save(run_dir + ".npy", np.array(outputs, dtype=object))
            if grd_dict is not None:
                np.save(run_dir + "_grd.npy", np.array(grds, dtype=object))

        # batch i + 1 is queued on the device before batch i's images are
        # fetched and written
        pending = None
        for bi in range(n_batches):
            sl = slice(bi * batch_size, (bi + 1) * batch_size)
            if all(row_done(i) for i in range(sl.start, min(sl.stop, len(table)))):
                continue   # resume: this batch is in the manifest
            batch = {"uids": table.uids[sl], "oids": table.oids[sl],
                     "outfits": table.outfits[sl], "category": table.category[sl]}
            prep = self.prepare_batch(batch, task, seed, pad_to=pad_to, pad_outfits=batch_size)
            imgs_dev = self.dispatch_batch(prep)
            if pending is not None:
                drain(pending)
            pending = (prep, imgs_dev)
        if pending is not None:
            drain(pending)
        return run_dir

    # ------------------------------------------------------------------ save --

    def _save_batch(self, prep: PreparedBatch, imgs: np.ndarray, run_dir: str, task: str,
                    outputs: dict, grds: dict, grd_dict: Optional[dict]) -> None:
        per_oid: dict = {}
        for k in range(len(imgs)):
            if prep.valid[k]:
                per_oid.setdefault((int(prep.fill_uids[k]), int(prep.fill_oids[k])), []).append(k)
        for (uid, oid), ks in per_oid.items():
            folder = os.path.join(run_dir, "images", str(uid), str(oid))
            img_paths = []
            for i, k in enumerate(ks):
                p = os.path.join(folder, f"{i}.jpg")
                save_jpeg(imgs[k], p)
                img_paths.append(p)
            if task == "GOR":
                save_jpeg(merge_images_grid(imgs[np.asarray(ks)]),
                          os.path.join(folder, "all.jpg"))
            if (task == "FITB" and self.item_image_loader is not None
                    and grd_dict is not None and oid in grd_dict):
                g_imgs = []
                for iid in grd_dict[oid]["outfits"]:
                    im = np.asarray(self.item_image_loader(int(iid)))
                    if im.dtype != np.uint8:
                        im = np.clip(im * 255.0 + 0.5, 0, 255).astype(np.uint8)
                    g_imgs.append(im)
                save_jpeg(merge_images_grid(np.stack(g_imgs)), os.path.join(folder, "grd.jpg"))
            outputs.setdefault(uid, {})[oid] = {
                "cates": [int(prep.fill_cate[k]) for k in ks],
                "full_cates": np.asarray(prep.full_cate[ks[0]]),
                "outfits": np.asarray(prep.olists[ks[0]]),
                "image_paths": img_paths,
            }
            if grd_dict is not None and oid in grd_dict:
                g_outfits = np.asarray(grd_dict[oid]["outfits"])
                g_cates = np.asarray(grd_dict[oid]["category"])
                paths = []
                for k in ks:
                    idx = np.where(g_cates == int(prep.fill_cate[k]))[0]
                    paths.append(int(g_outfits[idx[0]]) if len(idx) else 0)  # item ids
                grds.setdefault(uid, {})[oid] = {"outfits": g_outfits, "image_paths": paths}

"""The one traffic generator: a synthetic catalog at Polyvore-U's schema and
the work drawn over it, from a cell's parameters (the "traffic" group of its
workload file) and the run's seed.

Schema (Polyvore-U, as DiFashion reads it): categories with integer ids and
names, items of one category each, outfits of `items_per_outfit` items of
distinct categories, users who own outfits and a history of items per
category. Users are drawn Zipf-skewed (a few users own many outfits), the
categories of an outfit by a Zipf-skewed popularity. A (user, category) pair
has a history with probability `history_share`; its history latent is the
mean latent of those items, here drawn directly. Latents are N(0, s) with the
workload's scales: the benchmark's weights are random, so no value is more
realistic than another, and the shapes are the model's.

Everything is a function of (parameters, seed): the same seed gives the same
work. Batches are drawn whole at set-up; a window that needs more than
`batches` cycles through them again with fresh outfit ids (fresh noise).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def category_names(n: int) -> Dict[int, str]:
    """Category ids 1..n with neutral names (the prompts' words change no
    shape: every prompt is 77 tokens)."""
    return {c: f"category {c}" for c in range(1, n + 1)}


@dataclass
class GenTraffic:
    """Batches of outfits to generate and the history store's latents."""

    batches: List[dict]                 # {uids, oids, outfits, category} host arrays
    hist: Dict[int, Dict[int, np.ndarray]]   # uid -> cid -> [h, w, C] float32
    null_latent: np.ndarray             # [h, w, C]
    id_cate: Dict[int, str]

    def batch(self, i: int) -> dict:
        """Batch i; past the drawn ones, a drawn batch again with new outfit ids."""
        b = dict(self.batches[i % len(self.batches)])
        cycle = i // len(self.batches)
        if cycle:
            b["oids"] = b["oids"] + cycle * 1_000_000
        return b

    def hist_latent(self, uid: int, cid: int) -> np.ndarray:
        return self.hist.get(int(uid), {}).get(int(cid), self.null_latent)


def generation(p: dict, seed: int, latent_shape) -> GenTraffic:
    """p: categories, users, user_zipf, category_zipf, items_per_outfit,
    outfits_per_batch, batches, history_share, latent_scale, task."""
    r = rng(seed, 1)
    n_cat, olen, per = p["categories"], p["items_per_outfit"], p["outfits_per_batch"]
    user_w = zipf_weights(p["users"], p["user_zipf"])
    cate_w = zipf_weights(n_cat, p["category_zipf"])
    batches = []
    oid = 1
    for _ in range(p["batches"]):
        uids = r.choice(p["users"], size=per, p=user_w) + 1
        cats = np.stack([r.choice(n_cat, size=olen, replace=False, p=cate_w) + 1
                         for _ in range(per)])
        if p["task"] == "GOR":
            outfits = np.zeros((per, olen), np.int64)
        else:
            raise ValueError(f"task {p['task']!r}: the generator draws GOR outfits only")
        batches.append({"uids": uids.astype(np.int64),
                        "oids": np.arange(oid, oid + per, dtype=np.int64),
                        "outfits": outfits, "category": cats.astype(np.int64)})
        oid += per
    pairs = sorted({(int(u), int(c)) for b in batches
                    for u, row in zip(b["uids"], b["category"]) for c in row})
    has = r.random(len(pairs)) < p["history_share"]
    lat = r.standard_normal((int(has.sum()),) + tuple(latent_shape),
                            dtype=np.float32) * p["latent_scale"]
    hist: Dict[int, Dict[int, np.ndarray]] = {}
    for (u, c), x in zip([pc for pc, h in zip(pairs, has) if h], lat):
        hist.setdefault(u, {})[c] = x
    null = r.standard_normal(tuple(latent_shape), dtype=np.float32) * p["latent_scale"]
    return GenTraffic(batches, hist, null, category_names(n_cat))


@dataclass
class TrainTraffic:
    """The catalog's latent moments and the history pool on the device, and
    the items of every step's outfits."""

    mean: "torch.Tensor"        # [n_items, h, w, C] VAE posterior means (unscaled)
    logvar: "torch.Tensor"      # [n_items, h, w, C]
    hist_pool: "torch.Tensor"   # [n_hist + 1, h, w, C] scaled history latents, the null last
    ids_table: "torch.Tensor"   # [n_cat + 1, 77] token ids of each category's prompt
    items: "torch.Tensor"       # [steps, B, olen] item ids
    hist_idx: "torch.Tensor"    # [steps, B, olen] row of hist_pool
    item_cate: "torch.Tensor"   # [n_items] category ids
    null_latent: "torch.Tensor"  # [h, w, C]

    @property
    def steps(self) -> int:
        return int(self.items.shape[0])

    def batch(self, step: int) -> dict:
        """The outfits of `step` (cycling past the drawn steps):
        latent_mean, latent_logvar, hist_latents [B, olen, h, w, C],
        input_ids [B, olen, 77]."""
        it = self.items[step % self.steps]
        flat = it.reshape(-1)
        shape = tuple(it.shape)
        return {"latent_mean": self.mean[flat].view(shape + tuple(self.mean.shape[1:])),
                "latent_logvar": self.logvar[flat].view(shape + tuple(self.mean.shape[1:])),
                "hist_latents": self.hist_pool[self.hist_idx[step % self.steps].reshape(-1)]
                .view(shape + tuple(self.mean.shape[1:])),
                "input_ids": self.ids_table[self.item_cate[flat]].view(shape + (-1,))}


def training(p: dict, seed: int, latent_shape, device, vocab_size: int) -> TrainTraffic:
    """p: categories, items, users, user_zipf, category_zipf, history_share,
    steps, outfits_per_step, items_per_outfit, mean_scale, logvar_mean,
    logvar_scale, latent_scale. The steps' items are a permutation of the
    catalog, so no row repeats before `items` rows have been drawn."""
    import torch

    from benchmark.reference.sampling import hash_token_ids, train_prompt

    r = rng(seed, 3)
    B, olen = p["outfits_per_step"], p["items_per_outfit"]
    n_rows = p["steps"] * B * olen
    if n_rows > p["items"]:
        raise ValueError(f"{p['steps']} steps of {B * olen} rows need {n_rows} items, "
                         f"the catalog has {p['items']}")
    item_cate = r.choice(p["categories"], size=p["items"],
                         p=zipf_weights(p["categories"], p["category_zipf"])) + 1
    items = r.permutation(p["items"])[:n_rows].reshape(p["steps"], B, olen)
    uids = r.choice(p["users"], size=(p["steps"], B),
                    p=zipf_weights(p["users"], p["user_zipf"])) + 1
    pair_row: Dict[tuple, int] = {}   # (uid, cid) -> row of the pool, -1: no history
    hist_idx = np.empty(items.shape, np.int64)
    n_hist = 0
    for (s, b, j), item in np.ndenumerate(items):
        key = (int(uids[s, b]), int(item_cate[item]))
        if key not in pair_row:
            pair_row[key] = -1
            if r.random() < p["history_share"]:
                pair_row[key], n_hist = n_hist, n_hist + 1
        hist_idx[s, b, j] = pair_row[key]
    hist_idx[hist_idx < 0] = n_hist   # the null latent, last in the pool
    gen = torch.Generator(device=device).manual_seed((int(seed) * 8 + 5) % (2 ** 63 - 1))
    shape = tuple(latent_shape)
    normal = lambda n, scale: torch.randn((n,) + shape, generator=gen, device=device) * scale
    mean = normal(p["items"], p["mean_scale"])
    logvar = normal(p["items"], p["logvar_scale"]) + p["logvar_mean"]
    null = normal(1, p["latent_scale"])
    pool = torch.cat([normal(n_hist, p["latent_scale"]), null])
    names = category_names(p["categories"])
    ids = hash_token_ids([""] + [train_prompt(names[c]) for c in range(1, p["categories"] + 1)],
                         vocab_size=vocab_size)
    dev = lambda a: torch.as_tensor(a, device=device)
    return TrainTraffic(mean=mean, logvar=logvar, hist_pool=pool, ids_table=dev(ids).long(),
                        items=dev(items), hist_idx=dev(hist_idx), item_cate=dev(item_cate),
                        null_latent=null[0])

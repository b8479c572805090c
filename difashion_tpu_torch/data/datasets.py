"""`.npy` schema readers for the iFashion / Polyvore-U contract, and the
per-(user, category) history latents. Copy of
`difashion_tpu/data/datasets.py`, with the shuffling `TrainLoader` of the
training loop.

Schemas:
  * train.npy / fitb_{valid,test}.npy: dict of parallel lists
    {uids, oids, outfits (4 iids, 0 = blank), category (4 cids)}
  * {valid,test}_grd.npy: {oid: {"outfits": [iid x4], "category": [cid x4]}}
  * fitb_*_retrieval_candidates.npy: {uid: {oid: [grd_iid, 4 negatives]}}
  * *_history.npy: {uid: {cid: [iid, ...]}}
  * id_cate_dict.npy: {cid: name}; map/cate_iid_dict.npy: {cid: [iids]}

The host prepares dense arrays; the device never sees Python dicts.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


def load_npy_dict(path: str):
    return np.load(path, allow_pickle=True).item()


def load_npy(path: str):
    return np.load(path, allow_pickle=True)


@dataclass
class OutfitTable:
    """One outfit per row; parallel arrays."""

    uids: np.ndarray      # [N] int
    oids: np.ndarray      # [N] int
    outfits: np.ndarray   # [N, olen] int (0 = blank/to-generate)
    category: np.ndarray  # [N, olen] int

    def __len__(self) -> int:
        return len(self.uids)

    @staticmethod
    def from_dict(d: dict) -> "OutfitTable":
        return OutfitTable(
            uids=np.asarray(d["uids"], np.int64),
            oids=np.asarray(d["oids"], np.int64),
            outfits=np.stack([np.asarray(o, np.int64) for o in d["outfits"]]),
            category=np.stack([np.asarray(c, np.int64) for c in d["category"]]),
        )

    @staticmethod
    def load(path: str) -> "OutfitTable":
        return OutfitTable.from_dict(load_npy_dict(path))


@dataclass
class FashionData:
    """Everything a task run needs from `datasets/{name}/`."""

    train: Optional[OutfitTable]
    fitb_valid: Optional[OutfitTable]
    fitb_test: Optional[OutfitTable]
    valid_grd: Optional[dict]           # {oid: {"outfits": [...], "category": [...]}}
    test_grd: Optional[dict]
    history: Dict[str, dict]            # split -> {uid: {cid: [iids]}}
    id_cate_dict: Dict[int, str]
    cate_iid_dict: Optional[dict]       # {cid: [iids]}
    retrieval_candidates: Dict[str, dict]  # split -> {uid: {oid: [5 iids]}}

    @staticmethod
    def load(data_path: str, splits=("train", "valid", "test")) -> "FashionData":
        def opt_table(name):
            p = os.path.join(data_path, name)
            return OutfitTable.load(p) if os.path.exists(p) else None

        def opt_dict(name):
            p = os.path.join(data_path, name)
            return load_npy_dict(p) if os.path.exists(p) else None

        history = {}
        for s in splits:
            d = opt_dict(f"{s}_history.npy")
            if d is not None:
                history[s] = d
        retrieval = {}
        for s in ("valid", "test"):
            d = opt_dict(f"fitb_{s}_retrieval_candidates.npy")
            if d is not None:
                retrieval[s] = d
        cate_iid = None
        p = os.path.join(data_path, "map", "cate_iid_dict.npy")
        if os.path.exists(p):
            cate_iid = load_npy_dict(p)
        return FashionData(
            train=opt_table("train.npy"),
            fitb_valid=opt_table("fitb_valid.npy"),
            fitb_test=opt_table("fitb_test.npy"),
            valid_grd=opt_dict("valid_grd.npy"),
            test_grd=opt_dict("test_grd.npy"),
            history=history,
            id_cate_dict=opt_dict("id_cate_dict.npy") or {},
            cate_iid_dict=cate_iid,
            retrieval_candidates=retrieval,
        )


class HistLatentStore:
    """Per-(uid, cate) mean latents with the null fallback: the `processed/`
    cache's hist_latents[uid][cate] is the mean of the user's history-item
    latents; the "null" entry is the latent of item 0 (the white image)."""

    def __init__(self, hist_latents: dict, null_latent: np.ndarray):
        self.hist = hist_latents
        self.null = np.asarray(null_latent, np.float32)

    @staticmethod
    def from_catalog(history: dict, all_latents: np.ndarray) -> "HistLatentStore":
        out = {}
        for uid, by_cate in history.items():
            # skip empty history lists: mean([]) is NaN and `cate in by_cate`
            # would then bypass the null fallback in lookup()
            per_cate = {
                cate: all_latents[np.asarray(iids, np.int64)].mean(axis=0)
                for cate, iids in by_cate.items() if len(iids) > 0
            }
            if per_cate:
                out[uid] = per_cate
        return HistLatentStore(out, all_latents[0])

    def lookup(self, uid: int, cate: int) -> np.ndarray:
        by_cate = self.hist.get(uid)
        if by_cate is not None and cate in by_cate:
            return np.asarray(by_cate[cate], np.float32)
        return self.null

    def gather(self, uids: np.ndarray, category: np.ndarray) -> np.ndarray:
        """uids [B], category [B, olen] -> [B, olen, *latent_shape]."""
        B, olen = category.shape
        out = np.empty((B, olen) + self.null.shape, np.float32)
        for i in range(B):
            for j in range(olen):
                out[i, j] = self.lookup(int(uids[i]), int(category[i, j]))
        return out


class TrainLoader:
    """Shuffling epoch iterator with step-accurate resume: the permutation of
    an epoch is a pure function of (seed, epoch), so `batch_at(step)` after a
    restart gives the batch an uninterrupted run would have drawn."""

    def __init__(self, table: OutfitTable, batch_size: int, seed: int = 123,
                 drop_last: bool = True, shuffle: bool = True):
        self.table = table
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.shuffle = shuffle
        self._order_cache = None

    def steps_per_epoch(self) -> int:
        n = len(self.table)
        spe = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        if spe == 0:
            raise ValueError(
                f"train table has {n} rows < batch_size {self.batch_size} "
                f"(drop_last={self.drop_last}): no full batch can be formed")
        return spe

    def epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.table))
        # one-slot cache: the loop asks for the same epoch's permutation batch
        # after batch
        if self._order_cache is not None and self._order_cache[0] == epoch:
            return self._order_cache[1]
        rng = np.random.RandomState((self.seed * 100003 + epoch) % (2 ** 31))
        order = rng.permutation(len(self.table))
        self._order_cache = (epoch, order)
        return order

    def batch_at(self, global_step: int) -> dict:
        """{uids, oids, outfits, category} of the batch at `global_step`."""
        epoch, step = divmod(global_step, self.steps_per_epoch())
        idx = self.epoch_order(epoch)[step * self.batch_size: (step + 1) * self.batch_size]
        t = self.table
        return {"uids": t.uids[idx], "oids": t.oids[idx], "outfits": t.outfits[idx],
                "category": t.category[idx]}

"""Evaluation drivers, first part: the image reader and the catalog CLIP
features. Counterpart of `difashion_tpu/eval/drivers.py:53-63,576-604` (the
reference's `extract_hist_embs.py`): the whole catalog through the CLIP image
tower in batches of 200, and each (user, category) history's mean
embedding. The four metric cascades (FITB, GOR and their grounding forms)
are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from difashion_tpu_torch.eval.extractors import Extractors


def load_image01(path: str, size: Optional[int] = None) -> np.ndarray:
    """An image as [H, W, 3] float32 in [0, 1], bilinear-resized to
    size x size when given (polyvore's 291 px ground truths to 512)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None and img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def extract_catalog_clip_features(extractors: Extractors,
                                  item_image_loader: Callable[[int], np.ndarray],
                                  num_items: int, batch_size: int = 200) -> np.ndarray:
    """Encode the catalog with the CLIP image tower -> [num_items, 1024];
    `item_image_loader(iid)` gives [H, W, 3] in [0, 1]."""
    feats = []
    for s in range(0, num_items, batch_size):
        imgs = np.stack([item_image_loader(i) for i in range(s, min(s + batch_size, num_items))])
        feats.append(extractors.clip_image_embs(imgs))
    return np.concatenate(feats, axis=0)


def process_history_clip_embs(history: dict, cnn_features: np.ndarray) -> dict:
    """{uid: {cid: [iids]}} -> {uid: {cid: mean CLIP embedding}}."""
    return {uid: {cid: cnn_features[np.asarray(iids, np.int64)].mean(axis=0)
                  for cid, iids in by_cate.items()}
            for uid, by_cate in history.items()}

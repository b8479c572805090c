"""Metric math (feature space, backbone-agnostic): a copy of
`difashion_tpu/eval/metrics.py` in numpy and scipy, the computational core of
the reference's `Evaluation/eval_utils.py` metric suite as pure functions over
features and probabilities:

  * FID: activation statistics + Frechet distance (pytorch_fid semantics)
  * the custom IS: finetuned-Inception softmax -> accuracy, entropy,
    exp(KL(p || uniform)), the reference's uniform-prior variant
  * CLIP text / image scores: 100 * cosine
  * personalization similarity: generated CLIP embedding vs the per-(user,
    category) mean history embedding
  * retrieval accuracy over 5 candidates (ground truth at index 0)
  * top-N recall over category pools, per row and grouped by category

The towers that make the features are in `eval/models/`; these take numpy.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


# ---------------------------------------------------------------------------
# FID
# ---------------------------------------------------------------------------

def activation_statistics(features: np.ndarray):
    """[N, D] -> (mu [D], sigma [D, D]) with np.cov semantics (rowvar=False)."""
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), with the pytorch_fid
    eps-regularization fallback for singular products."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = np.asarray(linalg.sqrtm(sigma1.dot(sigma2)))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"imaginary component {np.max(np.abs(covmean.imag))} in sqrtm"
            )
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def fid_from_features(feat1: np.ndarray, feat2: np.ndarray) -> float:
    m1, s1 = activation_statistics(feat1)
    m2, s2 = activation_statistics(feat2)
    return frechet_distance(m1, s1, m2, s2)


# ---------------------------------------------------------------------------
# Custom Inception Score (uniform-prior KL) + category accuracy
# ---------------------------------------------------------------------------

def inception_metrics(
    probs: np.ndarray,
    labels: np.ndarray,
    num_splits: int = 1,
    eps: float = 1e-16,
):
    """probs: [N, K] softmax outputs of the finetuned 50-class Inception;
    labels: [N] ground-truth category rows.

    Returns dict(acc, entropy_mean, entropy_std, is_mean, is_std) matching
    `calculate_inception_score_given_data` exactly: entropy = E[-sum p log p];
    score = exp(E[sum p (log p - log u)]) with u uniform."""
    preds = np.argmax(probs, axis=1)
    acc = float(np.mean(preds == labels))
    K = probs.shape[1]
    uniform = np.full((K,), 1.0 / K)

    ents, scores = [], []
    N = probs.shape[0]
    for i in range(num_splits):
        part = probs[i * N // num_splits:(i + 1) * N // num_splits]
        ent = float(np.mean(np.sum(-part * np.log(part + eps), axis=1)))
        kl = float(
            np.mean(np.sum(part * (np.log(part + eps) - np.log(uniform[None])), axis=1))
        )
        ents.append(ent)
        scores.append(np.exp(kl))
    return {
        "acc": acc,
        "entropy_mean": float(np.mean(ents)),
        "entropy_std": float(np.std(ents)) if len(ents) > 1 else 0.0,
        "is_mean": float(np.mean(scores)),
        "is_std": float(np.std(scores)) if len(scores) > 1 else 0.0,
    }


# ---------------------------------------------------------------------------
# Cosine-similarity family
# ---------------------------------------------------------------------------

def _l2norm(x: np.ndarray, axis=-1, eps: float = 1e-12) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), eps)


def clip_score(img_emb: np.ndarray, txt_emb: np.ndarray) -> float:
    """mean 100 * cosine(image, text) (`eval_utils.py:101-114`)."""
    sims = np.sum(_l2norm(img_emb) * _l2norm(txt_emb), axis=-1)
    return float(np.mean(100.0 * sims))


def clip_image_score(emb1: np.ndarray, emb2: np.ndarray,
                     similarity_func: str = "cosine") -> float:
    if similarity_func == "cosine":
        sims = np.sum(_l2norm(emb1) * _l2norm(emb2), axis=-1)
        return float(np.mean(100.0 * sims))
    if similarity_func == "euclidean":
        return float(np.linalg.norm(_l2norm(emb1) - _l2norm(emb2)))
    raise ValueError(f"unknown similarity {similarity_func!r}")


def personalization_sim(gen_emb: np.ndarray, hist_emb: np.ndarray) -> float:
    """gen embeddings vs (already-mean) history CLIP embeddings; both normalized,
    100 * cosine, averaged (`eval_utils.py:503-538`)."""
    sims = np.sum(_l2norm(gen_emb) * _l2norm(hist_emb), axis=-1)
    return float(np.mean(100.0 * sims))


def retrieval_accuracy(gen_emb: np.ndarray, candidate_embs: np.ndarray):
    """gen_emb [N, D]; candidate_embs [N, 5, D] with ground truth at index 0.
    Returns (acc, preds) (`eval_utils.py:652-723`)."""
    sims = np.sum(
        _l2norm(gen_emb)[:, None] * _l2norm(candidate_embs, axis=-1), axis=-1
    )
    preds = np.argmax(sims, axis=1)
    return float(np.mean(preds == 0)), preds


def topn_recall(
    gen_emb: np.ndarray,
    candidate_iids: Sequence[np.ndarray],
    candidate_embs: Sequence[np.ndarray],
    grd_iids: Sequence[int],
    topN: Sequence[int] = (10, 20, 50, 100),
):
    """Per-row variable-size candidate pools (the category's full item set).
    Returns (top1_preds [N], recalls {N: recall}) (`eval_utils.py:725-767`)."""
    all_top = []
    preds = []
    maxN = topN[-1]
    for emb, iids, cand in zip(gen_emb, candidate_iids, candidate_embs):
        sims = np.sum(_l2norm(emb[None]) * _l2norm(cand), axis=-1)
        all_top.append(np.asarray(iids)[_topk_desc(sims[None], maxN)[0]])
        preds.append(all_top[-1][0])
    recalls = _recalls_from_top(all_top, grd_iids, topN)
    return np.asarray(preds), recalls


def _topk_desc(sims: np.ndarray, k: int) -> np.ndarray:
    """Row-wise indices of the k largest entries, sorted descending by similarity.
    argpartition + small sort instead of a full per-row argsort."""
    n = sims.shape[-1]
    k = min(k, n)
    if k < n:
        part = np.argpartition(-sims, k - 1, axis=-1)[..., :k]
    else:
        part = np.broadcast_to(np.arange(n), sims.shape).copy()
    order = np.argsort(-np.take_along_axis(sims, part, -1), axis=-1)
    return np.take_along_axis(part, order, -1)


def _recalls_from_top(all_top, grd_iids, topN) -> dict:
    recalls = {}
    for N in topN:
        hits = sum(1 for grd, top in zip(grd_iids, all_top) if grd in top[:N])
        recalls[N] = hits / len(grd_iids)
    return recalls


def topn_recall_grouped(
    gen_emb: np.ndarray,
    cates: Sequence[int],
    cate_iid_dict: dict,
    cnn_features: np.ndarray,
    grd_iids: Sequence[int],
    topN: Sequence[int] = (10, 20, 50, 100),
):
    """Catalog-scale top-N retrieval: rows grouped by category so each category pool
    is normalized once and scored with ONE [rows, D] @ [D, pool] matmul (the
    reference's per-row loops over `map/cate_iid_dict.npy` pools,
    `evaluate_grounding_gor.py:204-282`, are O(N * pool) Python work).

    Returns (top1_preds [N], recalls {N: recall}) — identical to calling
    `topn_recall` with per-row pools."""
    cates = np.asarray(cates)
    gen_n = _l2norm(gen_emb)
    maxN = max(topN)
    n = len(gen_emb)
    preds = np.zeros(n, np.int64)
    all_top: list = [None] * n
    for c in np.unique(cates):
        rows = np.nonzero(cates == c)[0]
        iids = np.asarray(cate_iid_dict[int(c)], np.int64)
        pool = _l2norm(cnn_features[iids])
        sims = gen_n[rows] @ pool.T
        topk = _topk_desc(sims, maxN)
        for ri, r in enumerate(rows):
            all_top[r] = iids[topk[ri]]
            preds[r] = all_top[r][0]
    return preds, _recalls_from_top(all_top, grd_iids, topN)

"""Evaluation drivers: the four metric cascades (FITB, GOR and their
grounding forms), the image reader and the catalog CLIP features.
Counterpart of `difashion_tpu/eval/drivers.py` (the reference's
`evaluate_fitb.py`, `evaluate_gor.py`, `evaluate_grounding_{fitb,gor}.py`
and `extract_hist_embs.py`), over the manifests the generation pipeline
writes:

  * gen manifest  {uid: {oid: {cates, full_cates, outfits, image_paths}}}
  * each metric is added to `eval_results.npy` (`eval_results_grounding.npy`
    for the grounding cascades), a pickled {run name: {metric: value}},
    written through a temporary file and `os.replace` after every metric, so
    a run that stops keeps what it computed;
  * a metric already in the file is not computed again, and a stream of
    images runs only for metrics that are missing and computable.

The file is the JAX package's, key for key and type for type (Python floats,
the Inception metrics' dict, an int count), so either package resumes the
other's file and the JAX `parity.load_reference_results` reads this one.

The reference's quirks are kept: eval prompts drop "high quality" and use
the larger special-category list (`data/prompts.py::eval_prompt`);
retrieval's ground truth is candidate 0; compat pointers use negative ids
for generated items (`eval/models/compat.py::gather_outfit_feats`); its
`clip_og_retrieval_given_data` / `clip_gor_retrieval_given_data` name
mismatch resolves to one top-N routine (`metrics.topn_recall_grouped`).

The JAX package's two divergences from the reference, kept as they are:

  * `EvalContext.hist_emb` falls back to the catalog item 0 (the white null
    image) CLIP embedding where a (uid, cid) history entry is missing, where
    the reference raises KeyError; each fallback is counted, logged as a
    WARNING and recorded beside the score as `personal_sim_null_fallbacks`;
  * a metric whose inputs are absent (no retrieval candidates, catalog
    features or histories) is skipped instead of failing on a file load.

The towers run wherever `Extractors` was built; the cascades themselves are
numpy on the host.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from difashion_tpu_torch.data.prompts import eval_prompt
from difashion_tpu_torch.engine.pipeline import merge_images_grid
from difashion_tpu_torch.eval.extractors import Extractors
from difashion_tpu_torch.eval.metrics import (
    clip_image_score,
    clip_score,
    fid_from_features,
    inception_metrics,
    personalization_sim,
    retrieval_accuracy,
    topn_recall_grouped,
)
from difashion_tpu_torch.eval.models.compat import gather_outfit_feats

log = logging.getLogger("difashion_tpu_torch")


def load_image01(path: str, size: Optional[int] = None) -> np.ndarray:
    """An image as [H, W, 3] float32 in [0, 1], bilinear-resized to
    size x size when given (polyvore's 291 px ground truths to 512)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None and img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


@dataclass
class EvalContext:
    """Everything the cascades need besides the manifests."""

    extractors: Extractors
    id_cate_dict: Dict[int, str]
    item_image_loader: Callable[[int], np.ndarray]   # iid -> [H, W, 3] in [0, 1]
    cnn_features_clip: Optional[np.ndarray] = None   # [n_items, 1024]
    history_clipembs: Optional[dict] = None          # {uid: {cid: [1024]}}
    retrieval_candidates: Optional[dict] = None      # {uid: {oid: [5 iids]}}
    cate_iid_dict: Optional[dict] = None             # {cid: [iids]}
    cid_to_label: Optional[dict] = None              # {cid: class row}
    img_size: int = 512
    hist_emb_fallbacks: int = 0                      # null-embedding substitutions

    def label_of(self, cid: int) -> int:
        if self.cid_to_label is not None:
            return int(self.cid_to_label[cid])
        return sorted(self.id_cate_dict).index(cid)

    def hist_emb(self, uid: int, cid: int) -> np.ndarray:
        """The (user, category) mean history CLIP embedding; where it is
        missing, the null image's (catalog item 0), counted and logged (the
        module header's first divergence)."""
        h = (self.history_clipembs or {}).get(uid, {})
        if cid in h:
            return np.asarray(h[cid], np.float32)
        if self.cnn_features_clip is not None:
            self.hist_emb_fallbacks += 1
            log.warning("no history CLIP embedding for uid=%d cid=%d: using the null-image "
                        "embedding (the reference would raise KeyError); personal_sim for "
                        "this item is against the null image", uid, cid)
            return np.asarray(self.cnn_features_clip[0], np.float32)
        raise KeyError(f"no history embedding for uid={uid} cid={cid}")


def _put_personal_sim(sink, ctx: EvalContext, emb, uids, cates) -> None:
    """personal_sim, and beside it `personal_sim_null_fallbacks` where rows
    used the null embedding."""
    before = ctx.hist_emb_fallbacks
    hist = np.stack([ctx.hist_emb(u, c) for u, c in zip(uids, cates)])
    sink.put("personal_sim", personalization_sim(emb, hist))
    n = ctx.hist_emb_fallbacks - before
    if n:
        sink.put("personal_sim_null_fallbacks", int(n))


class _ResultSink:
    """One run's metrics in the shared results file, rewritten atomically
    after each metric."""

    def __init__(self, out_path: str, run_name: str):
        self.path = out_path
        self.run = run_name
        self.all = (np.load(out_path, allow_pickle=True).item()
                    if os.path.exists(out_path) else {})
        self.all.setdefault(run_name, {})

    def has(self, metric: str) -> bool:
        return metric in self.all[self.run]

    def put(self, metric: str, value) -> None:
        self.all[self.run][metric] = value
        # a kill mid-write of the shared file would lose every run's metrics
        tmp = self.path + ".tmp.npy"
        np.save(tmp, np.array(self.all, dtype=object))
        os.replace(tmp, self.path)

    def results(self) -> dict:
        return self.all[self.run]


def stream_image_features(X: Extractors, loader: Callable[[int], np.ndarray], n: int,
                          want: Sequence[str], chunk: Optional[int] = None
                          ) -> Dict[str, np.ndarray]:
    """Features of images 0..n-1 of `loader` (-> [H, W, 3] in [0, 1]), `chunk`
    images resident at a time: `want` from {"fid", "probs", "clip"} ->
    {name: [n, ...]}. Nothing is loaded when nothing is wanted."""
    if not want:
        return {}
    chunk = chunk or max(X.batch_size, 1)
    acc: Dict[str, list] = {k: [] for k in want}
    for s in range(0, n, chunk):
        imgs = np.stack([loader(i) for i in range(s, min(s + chunk, n))])
        if "fid" in acc:
            acc["fid"].append(X.fid_features(imgs))
        if "probs" in acc:
            acc["probs"].append(X.inception_probs(imgs))
        if "clip" in acc:
            acc["clip"].append(X.clip_image_embs(imgs))
    return {k: np.concatenate(v, axis=0) for k, v in acc.items()}


def stream_lpips(X: Extractors, loader_a: Callable[[int], np.ndarray],
                 loader_b: Callable[[int], np.ndarray], n: int,
                 chunk: Optional[int] = None) -> np.ndarray:
    """Pairwise LPIPS of images 0..n-1 of two loaders, `chunk` pairs at a time."""
    chunk = chunk or max(X.batch_size, 1)
    out = []
    for s in range(0, n, chunk):
        idx = range(s, min(s + chunk, n))
        out.append(X.lpips(np.stack([loader_a(i) for i in idx]),
                           np.stack([loader_b(i) for i in idx])))
    return np.concatenate(out)


def _flatten_fitb_manifest(manifest: dict):
    """-> (uids, oids, cates, outfit rows, image paths), one entry per
    generated image."""
    uids, oids, cates, rows, paths = [], [], [], [], []
    for uid, by_oid in manifest.items():
        for oid, rec in by_oid.items():
            for c, p in zip(rec["cates"], rec["image_paths"]):
                uids.append(uid)
                oids.append(oid)
                cates.append(int(c))
                rows.append(np.asarray(rec["outfits"]))
                paths.append(p)
    return uids, oids, cates, rows, paths


def _open_run(run_path: str, out_path: Optional[str], run_name: Optional[str],
              results_file: str):
    """The run's manifest and its sink (the results file beside the run by
    default)."""
    manifest = np.load(run_path + ".npy", allow_pickle=True).item()
    out_path = out_path or os.path.join(os.path.dirname(run_path), results_file)
    return manifest, _ResultSink(out_path, run_name or os.path.basename(run_path))


def _grd_item_iids(grd_dict: Dict[int, dict], oids, cates) -> list:
    """Per generated slot, the ground-truth outfit's item of its category."""
    out = []
    for oid, c in zip(oids, cates):
        g = grd_dict[oid]
        idx = int(np.where(np.asarray(g["category"]) == c)[0][0])
        out.append(int(np.asarray(g["outfits"])[idx]))
    return out


def _prompts(ctx: EvalContext, cates) -> list:
    return [eval_prompt(ctx.id_cate_dict[c]) for c in cates]


def _compat(X: Extractors, rows, ctx: EvalContext, gen_emb=None) -> float:
    feats = gather_outfit_feats(np.stack(rows), ctx.cnn_features_clip, gen_emb)
    return float(np.mean(X.compat_scores(feats)))


def evaluate_fitb(run_path: str, ctx: EvalContext, grd_dict: Dict[int, dict],
                  out_path: Optional[str] = None, run_name: Optional[str] = None) -> dict:
    """FITB cascade over one generation run (`evaluate_fitb.py:157-436`): FID
    and IS against the ground-truth items, CLIP text scores of both, CLIP
    retrieval among the 5 candidates, CLIP image score and LPIPS against the
    ground truth, personalization, and compatibility of the completed and
    the ground-truth outfits."""
    manifest, sink = _open_run(run_path, out_path, run_name, "eval_results.npy")
    X = ctx.extractors
    uids, oids, cates, _, paths = _flatten_fitb_manifest(manifest)
    N = len(paths)
    gen_loader = lambda k: load_image01(paths[k], ctx.img_size)
    grd_iids = _grd_item_iids(grd_dict, oids, cates)
    grd_loader = lambda k: ctx.item_image_loader(grd_iids[k])

    # a stream runs only for metrics missing AND computable: otherwise a
    # re-run would pass the whole manifest through the CLIP tower for a
    # metric that can never be written
    can_retrieval = ctx.retrieval_candidates is not None and ctx.cnn_features_clip is not None
    can_personal = ctx.history_clipembs is not None
    can_compat = ctx.cnn_features_clip is not None
    need_gen_clip = any(not sink.has(m) and ok for m, ok in (
        ("clip_score", True), ("clip_retrieval_acc", can_retrieval),
        ("clip_image_score", True), ("personal_sim", can_personal),
        ("compatibility", can_compat)))
    gen_want = [w for w, need in (("fid", not sink.has("fid")), ("probs", not sink.has("is")),
                                  ("clip", need_gen_clip)) if need]
    grd_want = [w for w, need in (
        ("fid", not sink.has("fid")),
        ("clip", not sink.has("grd_clip_score") or not sink.has("clip_image_score"))) if need]
    gf = stream_image_features(X, gen_loader, N, gen_want)
    rf = stream_image_features(X, grd_loader, N, grd_want)
    gen_emb = gf.get("clip")

    if not sink.has("fid"):
        sink.put("fid", fid_from_features(gf["fid"], rf["fid"]))
    if not sink.has("is"):
        sink.put("is", inception_metrics(gf["probs"],
                                         np.asarray([ctx.label_of(c) for c in cates])))
    if not sink.has("clip_score") or not sink.has("grd_clip_score"):
        txt_emb = X.clip_text_embs(_prompts(ctx, cates))
        if not sink.has("clip_score"):
            sink.put("clip_score", clip_score(gen_emb, txt_emb))
        if not sink.has("grd_clip_score"):
            sink.put("grd_clip_score", clip_score(rf["clip"], txt_emb))
    if not sink.has("clip_retrieval_acc") and can_retrieval:
        cand = np.stack([np.asarray(ctx.retrieval_candidates[u][o], np.int64)
                         for u, o in zip(uids, oids)])
        acc, _ = retrieval_accuracy(gen_emb, ctx.cnn_features_clip[cand])
        sink.put("clip_retrieval_acc", acc)
    if not sink.has("clip_image_score"):
        sink.put("clip_image_score", clip_image_score(gen_emb, rf["clip"]))
    if not sink.has("lpips"):
        sink.put("lpips", float(np.mean(stream_lpips(X, gen_loader, grd_loader, N))))
    if not sink.has("personal_sim") and can_personal:
        _put_personal_sim(sink, ctx, gen_emb, uids, cates)
    need_c, need_g = not sink.has("compatibility"), not sink.has("grd_compatibility")
    if (need_c or need_g) and can_compat:
        # one row per outfit; each blank gets its OWN image's negative pointer
        # into gen_emb (images are in slot order in the manifest), so an
        # outfit with several blanks scores every generated image
        out_rows, grd_rows, k = [], [], 0
        for by_oid in manifest.values():
            for oid, rec in by_oid.items():
                row = np.asarray(rec["outfits"]).copy()
                nblank = int((row == 0).sum())
                row[row == 0] = -np.arange(k, k + nblank, dtype=row.dtype)
                k += nblank
                out_rows.append(row)
                grd_rows.append(np.asarray(grd_dict[oid]["outfits"]))
        if need_c:
            sink.put("compatibility", _compat(X, out_rows, ctx, gen_emb))
        if need_g:
            sink.put("grd_compatibility", _compat(X, grd_rows, ctx))
    return sink.results()


def evaluate_gor(run_path: str, ctx: EvalContext, grd_dict: Dict[int, dict],
                 out_path: Optional[str] = None, run_name: Optional[str] = None) -> dict:
    """GOR cascade: item-level FID (against every ground-truth item), IS and
    CLIP text score; outfit-level CLIP image score and LPIPS between merged
    grids (`evaluate_gor.py:107-120,217-237`); personalization; compatibility
    of each generated and ground-truth outfit."""
    manifest, sink = _open_run(run_path, out_path, run_name, "eval_results.npy")
    X = ctx.extractors
    uids, oids, cates, _, paths = _flatten_fitb_manifest(manifest)
    N = len(paths)
    gen_loader = lambda k: load_image01(paths[k], ctx.img_size)
    grd_item_iids = [int(i) for oid in dict.fromkeys(oids) for i in grd_dict[oid]["outfits"]]
    grd_loader = lambda k: ctx.item_image_loader(grd_item_iids[k])

    can_personal = ctx.history_clipembs is not None
    can_compat = ctx.cnn_features_clip is not None
    need_gen_clip = any(not sink.has(m) and ok for m, ok in (
        ("clip_score", True), ("personal_sim", can_personal), ("compatibility", can_compat)))
    gen_want = [w for w, need in (("fid", not sink.has("fid")), ("probs", not sink.has("is")),
                                  ("clip", need_gen_clip)) if need]
    gf = stream_image_features(X, gen_loader, N, gen_want)
    gen_emb = gf.get("clip")

    if not sink.has("fid"):
        rf = stream_image_features(X, grd_loader, len(grd_item_iids), ("fid",))
        sink.put("fid", fid_from_features(gf["fid"], rf["fid"]))
    if not sink.has("is"):
        sink.put("is", inception_metrics(gf["probs"],
                                         np.asarray([ctx.label_of(c) for c in cates])))
    if not sink.has("clip_score"):
        sink.put("clip_score", clip_score(gen_emb, X.clip_text_embs(_prompts(ctx, cates))))

    # outfit-level merged grids, streamed: one grid pair resident per index,
    # each through the uint8 round trip of a saved grid
    if not sink.has("clip_image_score") or not sink.has("lpips"):
        recs = [(rec["image_paths"], grd_dict[oid]["outfits"])
                for by_oid in manifest.values() for oid, rec in by_oid.items()]

        def to_grid(im):
            return merge_images_grid((im * 255).astype(np.uint8)).astype(np.float32) / 255.0

        grid_gen = lambda k: to_grid(np.stack([load_image01(p, ctx.img_size)
                                               for p in recs[k][0]]))
        grid_grd = lambda k: to_grid(np.stack([ctx.item_image_loader(int(i))
                                               for i in recs[k][1]]))
        n_outfits = len(recs)
        if not sink.has("clip_image_score"):
            mg = stream_image_features(X, grid_gen, n_outfits, ("clip",))["clip"]
            mr = stream_image_features(X, grid_grd, n_outfits, ("clip",))["clip"]
            sink.put("clip_image_score", clip_image_score(mg, mr))
        if not sink.has("lpips"):
            sink.put("lpips", float(np.mean(stream_lpips(X, grid_gen, grid_grd, n_outfits))))

    if not sink.has("personal_sim") and can_personal:
        _put_personal_sim(sink, ctx, gen_emb, uids, cates)
    need_c, need_g = not sink.has("compatibility"), not sink.has("grd_compatibility")
    if (need_c or need_g) and can_compat:
        rows, grd_rows, k = [], [], 0
        for by_oid in manifest.values():
            for oid, rec in by_oid.items():
                nimg = len(rec["image_paths"])
                rows.append(-np.arange(k, k + nimg, dtype=np.int64))
                k += nimg
                grd_rows.append(np.asarray(grd_dict[oid]["outfits"]))
        if need_c:
            sink.put("compatibility", _compat(X, rows, ctx, gen_emb))
        if need_g:
            sink.put("grd_compatibility", _compat(X, grd_rows, ctx))
    return sink.results()


def evaluate_grounding_fitb(run_path: str, ctx: EvalContext, grd_dict: Dict[int, dict],
                            out_path: Optional[str] = None,
                            run_name: Optional[str] = None) -> dict:
    """Grounded FITB: each generated image retrieves its nearest real
    candidate, and the retrieved item is scored
    (`evaluate_grounding_fitb.py:216-296`)."""
    manifest, sink = _open_run(run_path, out_path, run_name, "eval_results_grounding.npy")
    X = ctx.extractors
    if all(sink.has(m) for m in ("retrieval_acc", "clip_score", "clip_image_score", "lpips",
                                 "personal_sim", "compatibility")):
        return sink.results()   # resume: nothing left, no stream
    uids, oids, cates, _, paths = _flatten_fitb_manifest(manifest)
    N = len(paths)
    gen_emb = stream_image_features(X, lambda k: load_image01(paths[k], ctx.img_size), N,
                                    ("clip",))["clip"]
    cand = np.stack([np.asarray(ctx.retrieval_candidates[u][o], np.int64)
                     for u, o in zip(uids, oids)])
    acc, preds = retrieval_accuracy(gen_emb, ctx.cnn_features_clip[cand])
    retrieved = cand[np.arange(len(preds)), preds]
    if not sink.has("retrieval_acc"):
        sink.put("retrieval_acc", acc)

    ret_loader = lambda k: ctx.item_image_loader(int(retrieved[k]))
    need_ret = any(not sink.has(m) for m in ("clip_score", "clip_image_score", "personal_sim"))
    ret_emb = stream_image_features(X, ret_loader, N, ("clip",))["clip"] if need_ret else None
    grd_iids = _grd_item_iids(grd_dict, oids, cates)
    grd_loader = lambda k: ctx.item_image_loader(grd_iids[k])
    grd_emb = (stream_image_features(X, grd_loader, N, ("clip",))["clip"]
               if not sink.has("clip_image_score") else None)

    if not sink.has("clip_score"):
        sink.put("clip_score", clip_score(ret_emb, X.clip_text_embs(_prompts(ctx, cates))))
    if not sink.has("clip_image_score"):
        sink.put("clip_image_score", clip_image_score(ret_emb, grd_emb))
    if not sink.has("lpips"):
        sink.put("lpips", float(np.mean(stream_lpips(X, ret_loader, grd_loader, N))))
    if not sink.has("personal_sim") and ctx.history_clipembs is not None:
        _put_personal_sim(sink, ctx, ret_emb, uids, cates)
    if not sink.has("compatibility"):
        # each blank gets its own image's retrieved item
        rows, k = [], 0
        for by_oid in manifest.values():
            for rec in by_oid.values():
                row = np.asarray(rec["outfits"]).copy()
                nblank = int((row == 0).sum())
                row[row == 0] = retrieved[k:k + nblank]
                k += nblank
                rows.append(row)
        sink.put("compatibility", _compat(X, rows, ctx))
    return sink.results()


def evaluate_grounding_gor(run_path: str, ctx: EvalContext, grd_dict: Dict[int, dict],
                           out_path: Optional[str] = None, run_name: Optional[str] = None,
                           topN: Sequence[int] = (10, 20, 50, 100)) -> dict:
    """Grounded GOR: each generated image retrieves from its category's whole
    item pool (top-N recall of the ground-truth item), and the top-1 items
    are scored (`evaluate_grounding_gor.py:204-282`)."""
    manifest, sink = _open_run(run_path, out_path, run_name, "eval_results_grounding.npy")
    X = ctx.extractors
    metrics = tuple(f"recall@{N}" for N in topN) + ("clip_score", "personal_sim",
                                                    "compatibility")
    if all(sink.has(m) for m in metrics):
        return sink.results()   # resume: nothing left, no stream
    uids, oids, cates, _, paths = _flatten_fitb_manifest(manifest)
    n = len(paths)
    gen_emb = stream_image_features(X, lambda k: load_image01(paths[k], ctx.img_size), n,
                                    ("clip",))["clip"]
    # one product per category pool, not the reference's loop per row
    preds, recalls = topn_recall_grouped(gen_emb, cates, ctx.cate_iid_dict,
                                         ctx.cnn_features_clip,
                                         _grd_item_iids(grd_dict, oids, cates), topN=topN)
    for N, r in recalls.items():
        if not sink.has(f"recall@{N}"):
            sink.put(f"recall@{N}", r)

    ret_loader = lambda k: ctx.item_image_loader(int(preds[k]))
    need_ret = any(not sink.has(m) for m in ("clip_score", "personal_sim"))
    ret_emb = stream_image_features(X, ret_loader, n, ("clip",))["clip"] if need_ret else None
    if not sink.has("clip_score"):
        sink.put("clip_score", clip_score(ret_emb, X.clip_text_embs(_prompts(ctx, cates))))
    if not sink.has("personal_sim") and ctx.history_clipembs is not None:
        _put_personal_sim(sink, ctx, ret_emb, uids, cates)
    if not sink.has("compatibility"):
        rows, k = [], 0
        for by_oid in manifest.values():
            for rec in by_oid.values():
                nimg = len(rec["image_paths"])
                rows.append(preds[k:k + nimg])
                k += nimg
        sink.put("compatibility", _compat(X, rows, ctx))
    return sink.results()


# ---- the catalog's CLIP features (extract_hist_embs.py) ----------------------

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

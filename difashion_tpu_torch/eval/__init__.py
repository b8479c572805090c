"""Evaluation: the metric math (`metrics.py`), the towers that make the
features (`models/`), the batched extractors over them (`extractors.py`) and
the catalog CLIP features (`drivers.py`). Counterpart of
`difashion_tpu/eval/`; the JAX package's weight exporters need no module
here, since each tower's `state_dict()` is already in its source checkpoint's
names and layouts."""
from difashion_tpu_torch.eval.metrics import (
    activation_statistics,
    clip_image_score,
    clip_score,
    fid_from_features,
    frechet_distance,
    inception_metrics,
    personalization_sim,
    retrieval_accuracy,
    topn_recall,
    topn_recall_grouped,
)

__all__ = [
    "activation_statistics",
    "clip_image_score",
    "clip_score",
    "fid_from_features",
    "frechet_distance",
    "inception_metrics",
    "personalization_sim",
    "retrieval_accuracy",
    "topn_recall",
    "topn_recall_grouped",
]

"""Category prompts, built the two ways the reference builds them (copy of
`difashion_tpu/data/prompts.py`):
  * training and preprocessing: the special categories ("pants", "earrings")
    get "a pair of"; suffix ", on white background, high quality";
  * evaluation: a longer special list and no "high quality".
"""
from __future__ import annotations

from typing import Dict, Sequence

TRAIN_SPECIAL_CATES = ("pants", "earrings")
EVAL_SPECIAL_CATES = (
    "shoes", "pants", "sneakers", "boots", "earrings", "slippers", "sandals"
)


def _is_special(category: str, special: Sequence[str]) -> bool:
    return any(s in category for s in special)


def train_prompt(category: str) -> str:
    if _is_special(category, TRAIN_SPECIAL_CATES):
        return "A photo of a pair of " + category + ", on white background, high quality"
    return "A photo of a " + category + ", on white background, high quality"


def eval_prompt(category: str) -> str:
    if _is_special(category, EVAL_SPECIAL_CATES):
        return "A photo of a pair of " + category + ", on white background"
    return "A photo of a " + category + ", on white background"


def build_train_prompts(cids: Sequence[int], id_cate_dict: Dict[int, str]):
    return [train_prompt(id_cate_dict[c]) for c in cids]


def build_eval_prompts(cids: Sequence[int], id_cate_dict: Dict[int, str]):
    return [eval_prompt(id_cate_dict[c]) for c in cids]

"""The data side of DiFashion: the `.npy` schema readers, the prompts, the
tokenizers, the PIL image pipeline and the catalog precompute. Copies of
`difashion_tpu/data/` (the port imports nothing of the JAX package), with the
precompute on torch."""
from difashion_tpu_torch.data.datasets import (
    FashionData,
    HistLatentStore,
    OutfitTable,
    TrainLoader,
    load_npy,
    load_npy_dict,
)
from difashion_tpu_torch.data.prompts import (
    EVAL_SPECIAL_CATES,
    TRAIN_SPECIAL_CATES,
    build_eval_prompts,
    build_train_prompts,
    eval_prompt,
    train_prompt,
)
from difashion_tpu_torch.data.tokenizer import (
    CLIPBPETokenizer,
    HashTokenizer,
    load_tokenizer,
)

__all__ = [
    "FashionData",
    "HistLatentStore",
    "OutfitTable",
    "TrainLoader",
    "load_npy",
    "load_npy_dict",
    "EVAL_SPECIAL_CATES",
    "TRAIN_SPECIAL_CATES",
    "build_eval_prompts",
    "build_train_prompts",
    "eval_prompt",
    "train_prompt",
    "CLIPBPETokenizer",
    "HashTokenizer",
    "load_tokenizer",
]

"""The evaluation towers out to files: a complete `weights_dir` in the layout
that real weights arrive in. Counterpart of
`difashion_tpu/eval/models/exporters.py` and of
`tools/export_eval_weights.py` (the weights-arrival drill): with the
directory this writes, the strict `parity` command (no
`--allow_random_weights`) runs hands-free before any real weights exist.

Each tower's parameters already carry its source checkpoint's names and
layouts (`eval/extractors.py`), so a file is the tower's state dict, fp32
and contiguous, less what the source checkpoint does not hold (the
BatchNorms' `num_batches_tracked`) and less nothing else: the files hold
what the JAX tool writes, key for key, and no entry that
`extractors.py`'s translations drop on the way in (open_clip's
`logit_scale`, torchvision's `AuxLogits.*`, vgg16's `classifier.*`):

    open_clip_vit_h14.safetensors     OpenCLIP image + text towers
    fid_inception.safetensors         pytorch_fid's InceptionV3 (no fc)
    finetuned_inception.safetensors   torchvision InceptionV3, `num_classes` fc
    vgg16.safetensors                 torchvision vgg16 `features.*`
    lpips_vgg.safetensors             lpips' `lin{i}.model.1.weight` heads
    ifashion_evaluator.safetensors    the compatibility net (first of COMPAT_FILES)
    tokenizer/{vocab.json,merges.txt} a CLIP-shaped BPE (`write_clip_vocab`)
"""
from __future__ import annotations

import json
import os
import random
import time
from typing import Dict

import torch
from torch import nn

from difashion_tpu_torch.core.importer import write_safetensors
from difashion_tpu_torch.data.tokenizer import bytes_to_unicode
from difashion_tpu_torch.eval.extractors import COMPAT_FILES, build_towers


def file_state(tower: nn.Module) -> Dict[str, torch.Tensor]:
    """A tower's state dict as its source checkpoint holds it: fp32 tensors
    in their logical order, without `num_batches_tracked`."""
    return {k: v.detach().float().contiguous() for k, v in tower.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def write_clip_vocab(tok_dir: str, n_merges: int = 200, seed: int = 0) -> None:
    """A CLIP-shaped vocabulary: the byte alphabet, its `</w>` variants,
    `n_merges` chained merges drawn by `random.Random(seed)`, and the two
    special tokens. The JAX tool's walk, so its files come out byte for
    byte."""
    rng = random.Random(seed)
    alphabet = list(bytes_to_unicode().values())
    vocab = alphabet + [c + "</w>" for c in alphabet]
    tokens = set(vocab)
    merges = []
    mergeable = list(vocab)
    while len(merges) < n_merges:
        a = rng.choice(mergeable)
        if a.endswith("</w>"):
            continue
        b = rng.choice(mergeable)
        new = a + b
        if new in tokens or len(new) > 14:
            continue
        merges.append((a, b))
        tokens.add(new)
        vocab.append(new)
        mergeable.append(new)
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    os.makedirs(tok_dir, exist_ok=True)
    with open(os.path.join(tok_dir, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(os.path.join(tok_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))


def export_weights_dir(out: str, tiny: bool = True, seed: int = 0, num_classes: int = 50,
                       n_merges: int = 200, device="cuda") -> dict:
    """Build every tower with seeded random weights on `device` (ViT-H/14
    widths, or the tiny ones) and write the module docstring's directory.
    Returns {file name: {"tensors", "bytes", "seconds"}}."""
    os.makedirs(out, exist_ok=True)
    clip, fid, cls, lp, compat = build_towers(tiny, seed, num_classes, device)
    towers = {"open_clip_vit_h14": clip, "fid_inception": fid, "finetuned_inception": cls,
              "vgg16": lp.vgg, "lpips_vgg": lp.heads, COMPAT_FILES[0]: compat}
    report = {}
    for name, tower in towers.items():
        sd = file_state(tower)
        t0 = time.perf_counter()
        nbytes = write_safetensors(os.path.join(out, name + ".safetensors"), sd)
        report[name + ".safetensors"] = {"tensors": len(sd), "bytes": nbytes,
                                         "seconds": time.perf_counter() - t0}
        towers[name] = sd = None
    write_clip_vocab(os.path.join(out, "tokenizer"), n_merges=n_merges, seed=seed)
    return report

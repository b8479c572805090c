"""The FashionEvaluator compatibility net. Counterpart of
`difashion_tpu/eval/models/compat.py` (the reference's
`compatibility_evaluator/compatibility_net.py`): a per-item
Linear(cnn_feat_dim -> 1024), the C(olen, 2) item-pair concatenations in
`itertools.combinations` order, a 4-layer MLP (Linear, LayerNorm, ReLU,
dropout 0.35 off in eval) to 256, the mean over the pairs, the 4-layer eval
head, one logit per outfit (the caller applies the sigmoid).

Parameter names are the torch FashionEvaluator's (`feat_layer`,
`emb_layer.{0,1,4,5,...}`, `eval_layer.{0,...,12}`), so its checkpoints
(`ifashion_evaluator.pth`, `polyvore_evaluator.pth`) load with
`load_state_dict(strict=True)`.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch
from torch import nn


def _mlp(widths, cin: int, head: bool = False) -> nn.Sequential:
    layers = []
    for w in widths:
        layers += [nn.Linear(cin, w), nn.LayerNorm(w, eps=1e-5), nn.ReLU(), nn.Dropout(0.35)]
        cin = w
    if head:
        layers.append(nn.Linear(cin, 1))
    return nn.Sequential(*layers)


class FashionEvaluator(nn.Module):
    def __init__(self, cnn_feat_dim: int = 1024):
        super().__init__()
        self.feat_layer = nn.Linear(cnn_feat_dim, 1024)
        self.emb_layer = _mlp((512, 512, 256, 256), 2048)
        self.eval_layer = _mlp((128, 128, 32), 256, head=True)

    def forward(self, cnn_feats: torch.Tensor) -> torch.Tensor:
        """cnn_feats: [B, olen, cnn_feat_dim] -> logits [B]."""
        B, olen, _ = cnn_feats.shape
        feats = self.feat_layer(cnn_feats)
        pairs = list(itertools.combinations(range(olen), 2))   # 6 pairs for olen 4
        comb = torch.stack([torch.cat([feats[:, i], feats[:, j]], dim=-1) for i, j in pairs],
                           dim=1)                                 # [B, pairs, 2048]
        x = self.emb_layer(comb.reshape(B * len(pairs), -1))
        o_emb = x.reshape(B, len(pairs), -1).mean(dim=1)          # [B, 256]
        return self.eval_layer(o_emb).reshape(-1)


def init_fashion_evaluator(model: FashionEvaluator, generator: torch.Generator):
    """Seeded random weights (lecun-normal linears, zero biases, LayerNorm at
    identity): a stand-in for real weights."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / m.in_features ** 0.5)
                m.bias.zero_()
    return model.eval()


def gather_outfit_feats(outfits: np.ndarray, cnn_feats: np.ndarray,
                        cnn_feats_gen: Optional[np.ndarray]) -> np.ndarray:
    """The reference's pointer convention: iid > 0 indexes the catalog
    features, iid <= 0 the generated images' features at -iid. Two gathers
    and a masked select."""
    idx = np.asarray(outfits, np.int64)
    neg = idx <= 0
    out = cnn_feats[np.where(neg, 0, idx)]
    if neg.any():
        if cnn_feats_gen is None:
            raise ValueError("outfits contain generated-item pointers (iid <= 0) "
                             "but cnn_feats_gen is None")
        out[neg] = cnn_feats_gen[(-idx)[neg]]
    return out.astype(cnn_feats.dtype, copy=False)

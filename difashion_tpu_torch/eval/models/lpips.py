"""LPIPS (the VGG variant). Counterpart of
`difashion_tpu/eval/models/lpips.py`, the `lpips.LPIPS(net='vgg')` metric of
the reference: VGG16 features at the five ReLU stages (relu1_2, relu2_2,
relu3_3, relu4_3, relu5_3) of [-1, 1] images shifted and scaled by LPIPS's
constants, each unit-normalized over channels, the squared difference
weighted by the 1x1 linear heads, a spatial mean, summed over the stages.

Parameter names are the source checkpoints': `vgg.features.{i}.weight` with
torchvision vgg16's indices (0, 2, 5, ... 28), and the heads
`heads.lin{i}.model.1.weight` [1, C, 1, 1] as the lpips package stores them.
So `vgg` loads a torchvision vgg16 state dict and `heads` an lpips one, each
with `load_state_dict(strict=True)` (vgg16's classifier left out,
`eval/extractors.py`).
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

# torchvision VGG16's conv widths per stage; a max pool between stages
_VGG16_CFG = [(64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)]
LPIPS_CHANNELS = [64, 128, 256, 512, 512]
# LPIPS's ScalingLayer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """torchvision vgg16's `features` up to relu5_3 (indices 0..29); returns
    the five stage activations after their ReLU."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        self.taps = []
        cin = 3
        for si, stage in enumerate(_VGG16_CFG):
            if si:
                layers.append(nn.MaxPool2d(2, 2))
            for ch in stage:
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
                cin = ch
            self.taps.append(len(layers) - 1)
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                outs.append(x)
        return outs


class NetLinLayer(nn.Module):
    """lpips' head: dropout (off in eval), then a 1x1 conv to one channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPSHeads(nn.Module):
    def __init__(self):
        super().__init__()
        for i, c in enumerate(LPIPS_CHANNELS):
            setattr(self, f"lin{i}", NetLinLayer(c))
            nn.init.ones_(getattr(self, f"lin{i}").model[1].weight)

    def weights(self) -> List[torch.Tensor]:
        return [getattr(self, f"lin{i}").model[1].weight for i in range(len(LPIPS_CHANNELS))]


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        self.heads = LPIPSHeads()
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0, img1: [B, 3, H, W] in [-1, 1] -> distances [B] (fp32)."""
        f0 = self.vgg((img0 - self.shift) / self.scale)
        f1 = self.vgg((img1 - self.shift) / self.scale)
        total = 0.0
        for a, b, w in zip(f0, f1, self.heads.weights()):
            a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
            # the 1x1 head is a channel-weighted sum; then the spatial mean
            d = torch.einsum("bchw,c->bhw", ((a - b) ** 2).float(), w.float().reshape(-1))
            total = total + d.mean(dim=(1, 2))
        return total


def init_lpips(model: LPIPS, generator: torch.Generator) -> LPIPS:
    """Seeded random VGG weights (lecun-normal, zero bias), heads of ones
    (the JAX module's initialisation): a stand-in for real weights."""
    with torch.no_grad():
        for name, p in model.vgg.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) / p[0].numel() ** 0.5)
    return model.eval()

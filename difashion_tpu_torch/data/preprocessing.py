"""Host-side image preprocessing, a copy of
`difashion_tpu/data/preprocessing.py`. Two pipelines:
  * dataset preparation: RGBA -> white-background composite, pad to a white
    square, LANCZOS resize to 512 (the catalog images the precompute encodes);
  * the training transform: bilinear resize to `img_size`, crop, [0, 1], then
    2x - 1.

Outputs are NHWC float32 numpy arrays. PIL is imported inside the functions
that need it, so the package imports where PIL is not installed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def composite_on_white(img: "Image.Image") -> "Image.Image":
    """Alpha-composite onto a white background (transparent catalog PNGs)."""
    from PIL import Image

    if img.mode in ("RGBA", "LA") or (img.mode == "P" and "transparency" in img.info):
        rgba = img.convert("RGBA")
        bg = Image.new("RGBA", rgba.size, (255, 255, 255, 255))
        return Image.alpha_composite(bg, rgba).convert("RGB")
    return img.convert("RGB")


def pad_to_square_white(img: "Image.Image") -> "Image.Image":
    from PIL import Image

    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    out = Image.new("RGB", (side, side), (255, 255, 255))
    out.paste(img, ((side - w) // 2, (side - h) // 2))
    return out


def prepare_catalog_image(img: "Image.Image", size: int = 512) -> "Image.Image":
    """The dataset-prep pipeline: composite -> pad square -> LANCZOS resize."""
    from PIL import Image

    img = composite_on_white(img)
    img = pad_to_square_white(img)
    return img.resize((size, size), Image.LANCZOS)


def make_null_image(size: int = 512) -> np.ndarray:
    """The pure-white null image (catalog index 0), in [-1, 1]."""
    return np.ones((size, size, 3), np.float32)  # white == 1.0 after 2x-1 of 1.0


def to_model_input(img: "Image.Image", size: int = 512,
                   crop: str = "center",
                   rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Training transform: bilinear resize (short side to `size`), crop, [0,1] -> 2x-1.
    Returns [size, size, 3] float32 NHWC."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        nw, nh = size, max(size, round(h * size / w))
    else:
        nh, nw = size, max(size, round(w * size / h))
    img = img.resize((nw, nh), Image.BILINEAR)
    if crop == "random" and rng is not None:
        left = rng.randint(0, nw - size + 1)
        top = rng.randint(0, nh - size + 1)
    else:
        left, top = (nw - size) // 2, (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, np.float32) / 255.0
    return 2.0 * arr - 1.0


def load_catalog_image(path: str, size: int = 512) -> np.ndarray:
    """Load an already-prepared catalog image -> [-1,1] NHWC float32 (the
    training transform, centre crop)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return to_model_input(img, size=size)


def denormalize_to_uint8(imgs: np.ndarray) -> np.ndarray:
    """[*, H, W, 3] in [0,1] -> uint8."""
    return np.clip(np.asarray(imgs) * 255.0 + 0.5, 0, 255).astype(np.uint8)

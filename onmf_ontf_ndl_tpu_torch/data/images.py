"""Host-side image ingest; images live on the device thereafter.

Counterpart of ``onmf_ontf_ndl_tpu/data/images.py``: PIL open, RGB or L,
/255; ``.npy`` "matrix" inputs are +-1 spin fields mapped to [0, 1] by
(x+1)/2; block-mean downscaling with zero-padded edge blocks (skimage
``downscale_local_mean`` semantics).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from onmf_ontf_ndl_tpu_torch.models.state import entry_device

__all__ = ["load_image", "downscale_local_mean"]


def load_image(path: str, *, is_matrix: bool = False, is_color: bool = True,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Read an image (or a saved +-1 matrix) as a [0, 1] tensor on
    ``device`` (the card by default; a CPU run passes ``device="cpu"``)."""
    device = entry_device(device)
    if is_matrix:
        data = (np.load(path) + 1.0) / 2.0
    else:
        from PIL import Image

        with Image.open(path) as img:
            data = np.asarray(
                img.convert("RGB" if is_color else "L")) / 255.0
    return torch.as_tensor(data, dtype=dtype, device=device)


def downscale_local_mean(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Block-mean downscale by ``factor`` along the two leading axes; edge
    blocks past the image are zero-padded before averaging."""
    if factor <= 1:
        return img
    h, w = img.shape[0], img.shape[1]
    ph, pw = (-h) % factor, (-w) % factor
    # F.pad pads from the last axis backwards
    x = F.pad(img, [0, 0] * (img.dim() - 2) + [0, pw, 0, ph])
    nh, nw = (h + ph) // factor, (w + pw) // factor
    x = x.reshape((nh, factor, nw, factor) + tuple(img.shape[2:]))
    return x.mean(dim=(1, 3))

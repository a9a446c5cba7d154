"""Video / GIF frame ingest for streaming dictionary learning.

Counterpart of ``onmf_ontf_ndl_tpu/data/video.py``: every frame of a GIF
(or any multi-frame image PIL can open) read into one [0, 1] tensor on the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from onmf_ontf_ndl_tpu_torch.models.state import entry_device

__all__ = ["load_video_frames"]


def load_video_frames(path: str, *, max_frames: int | None = None,
                      is_color: bool = True, dtype=torch.float32,
                      device="cuda") -> torch.Tensor:
    """Read the frames of an animated image into an (F, H, W, 3) tensor
    (RGB), or (F, H, W) with ``is_color=False``, on ``device`` (the card by
    default; a CPU run passes ``device="cpu"``). Frames divide by 255 in
    float32, as the JAX loader's do, before the cast to ``dtype``."""
    from PIL import Image, ImageSequence

    device = entry_device(device)
    if max_frames is not None and max_frames <= 0:
        raise ValueError(f"max_frames must be positive, got {max_frames}")
    frames = []
    with Image.open(path) as img:
        for i, frame in enumerate(ImageSequence.Iterator(img)):
            if max_frames is not None and i >= max_frames:
                break
            f = frame.convert("RGB" if is_color else "L")
            frames.append(np.asarray(f, dtype=np.float32) / 255.0)
    return torch.as_tensor(np.stack(frames), dtype=dtype, device=device)

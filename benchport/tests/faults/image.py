"""Faults of the image app's cells."""

from __future__ import annotations

from .step import half_batch, stale_weights, unchanged_state


def altered_image(monkeypatch):
    """One pixel of each reconstruction altered where it is painted."""
    from onmf_ontf_ndl_tpu_torch.apps import image

    orig = image.overlap_average_grid

    def paint(*a, **k):
        out = orig(*a, **k)
        out[5, 5, 0] += 0.25
        return out

    monkeypatch.setattr(image, "overlap_average_grid", paint)


CPU = {"train": [unchanged_state, half_batch], "recon": [altered_image]}
CARD = {"train": [stale_weights]}

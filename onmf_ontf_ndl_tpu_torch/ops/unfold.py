"""Tensor matricization (mode-``i`` unfolding).

Counterpart of ``onmf_ontf_ndl_tpu/ops/unfold.py``, tensorly's convention:
move the unfolding mode to the front and flatten the remaining axes
row-major, ``unfold(X, m) = movedim(X, m, 0).reshape(X.shape[m], -1)``.
"""

from __future__ import annotations

import torch

__all__ = ["unfold", "fold"]


def unfold(X: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-``mode`` unfolding of a tensor into a matrix (negative modes
    count from the end)."""
    mode = mode % X.dim()
    return torch.movedim(X, mode, 0).reshape(X.shape[mode], -1)


def fold(M: torch.Tensor, mode: int, shape: tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`unfold` for a tensor of the given full shape."""
    mode = mode % len(shape)
    lead = (shape[mode],) + tuple(s for i, s in enumerate(shape) if i != mode)
    return torch.movedim(M.reshape(lead), 0, mode)

"""Dictionary update by column-wise block coordinate descent.

PyTorch counterpart of ``onmf_ontf_ndl_tpu/ops/dict_update.py``. Given the
streaming aggregates ``A`` (r, r) and ``B`` (r, d), one Gauss-Seidel pass
over the r columns of ``W`` (d, r):

    W[:, j] <- W[:, j] - (W @ A[:, j] - B[j, :]) / (A[j, j] + 1)
    W[:, j] <- max(W[:, j], 0)
    W[:, j] <- W[:, j] / max(1, |W[:, j]|_2)

The column order is sequential: later columns see the already-updated
earlier ones through ``W @ A[:, j]``.
"""

from __future__ import annotations

import torch

__all__ = ["dict_update_bcd"]


def dict_update_bcd(W: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor) -> torch.Tensor:
    """One BCD pass over all columns; returns a new (d, r) dictionary with
    nonnegative, norm <= 1 columns (``W`` is not modified)."""
    W = W.clone()
    for j in range(W.shape[1]):
        grad = W @ A[:, j] - B[j, :]
        col = torch.clamp_min(W[:, j] - grad / (A[j, j] + 1.0), 0.0)
        W[:, j] = col / torch.clamp_min(torch.linalg.vector_norm(col), 1.0)
    return W

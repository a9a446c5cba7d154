"""Metrics tracked by the reference applications (PyTorch counterpart of
``onmf_ontf_ndl_tpu/utils/metrics.py``)."""

from __future__ import annotations

import torch

__all__ = ["surrogate_error", "relative_recon_error", "code_covariance"]


def surrogate_error(W, A, B, C):
    """The online-NMF surrogate ``tr(W A W^T) - 2 tr(W B) + tr(C)``,
    without the d x d products."""
    return torch.sum((W @ A) * W) - 2.0 * torch.sum(W * B.T) + torch.trace(C)


def relative_recon_error(X, W, H):
    """``|X - W H|_F / |X|_F``."""
    return torch.linalg.norm(X - W @ H) / torch.linalg.norm(X)


def code_covariance(code):
    """Trace-normalized covariance of the code rows (the atoms'
    co-activation); a zero-trace (constant) code gives the zero matrix."""
    c = code - code.mean(dim=1, keepdim=True)
    n = code.shape[1] - 1
    cov = (c @ c.T) / max(n, 1)
    tr = torch.trace(cov)
    return cov / torch.where(tr > 0, tr, torch.ones_like(tr))

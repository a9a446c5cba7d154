"""Patch extraction and overlap-averaged reconstruction on the device.

Counterpart of ``onmf_ontf_ndl_tpu/ops/patches.py``. A data matrix holds one
k x k patch per column, flattened row-major in (row, col[, channel]) order.
The regular-grid forms use ``F.unfold``/``F.fold`` (on a float32 CUDA
tensor the overlap average is a hand-written kernel); the corner-based forms
use advanced indexing and ``index_put_(accumulate=True)``;
:func:`grid_patch_corners` and :func:`all_patch_corners` give the corners
of the two regular grids, so the corner-based forms reach the same patches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from onmf_ontf_ndl_tpu_torch.models.state import entry_device
from onmf_ontf_ndl_tpu_torch.ops.kernels import patch_kernel

__all__ = [
    "random_patch_corners",
    "grid_patch_corners",
    "all_patch_corners",
    "extract_patches",
    "extract_patches_grid",
    "overlap_average",
    "overlap_average_grid",
    "overlap_average_fold",
]


def random_patch_corners(gen: torch.Generator, img_shape, k: int, num: int,
                         *, device=None):
    """Uniform top-left corners for ``num`` random k x k patches, on the
    support {0, ..., H-k-1} of the reference's ``np.random.choice(H - k)``.
    The corners lie on ``device``, by default the device of ``gen``, which
    must live there."""
    if device is None:
        device = gen.device
    if img_shape[0] <= k or img_shape[1] <= k:
        raise ValueError(
            f"image {tuple(img_shape[:2])} too small for {k}x{k} patches "
            f"(needs both dims > patch_size)")
    a = torch.randint(0, img_shape[0] - k, (num,), generator=gen,
                      device=device)
    b = torch.randint(0, img_shape[1] - k, (num,), generator=gen,
                      device=device)
    return a, b


def _grid_corners(ii: torch.Tensor, jj: torch.Tensor):
    return ii.repeat_interleave(jj.shape[0]), jj.repeat(ii.shape[0])


def grid_patch_corners(img_shape, k: int, stride: int, *, device="cuda"):
    """Strided-grid corners in row-major order, exclusive of the last row
    and column start (the reference's ``np.arange(0, H - k, stride)``): the
    corners of ``extract_patches_grid(img, k, stride)``. On ``device`` (the
    card by default; a CPU run passes ``device="cpu"``)."""
    device = entry_device(device)
    return _grid_corners(
        torch.arange(0, img_shape[0] - k, stride, device=device),
        torch.arange(0, img_shape[1] - k, stride, device=device))


def all_patch_corners(img_shape, k: int, *, device="cuda"):
    """Every patch position (inclusive of H - k), row-major: the corners
    of ``extract_patches_grid(img, k, inclusive=True)``, the grey
    reconstruction's full-coverage grid."""
    device = entry_device(device)
    return _grid_corners(
        torch.arange(0, img_shape[0] - k + 1, device=device),
        torch.arange(0, img_shape[1] - k + 1, device=device))


def _patch_index(corners, k: int):
    a, b = corners
    di = torch.arange(k, device=a.device)
    rows = a[:, None, None] + di[None, :, None]   # (n, k, 1)
    cols = b[:, None, None] + di[None, None, :]   # (n, 1, k)
    return rows, cols


def extract_patches(img: torch.Tensor, corners, k: int) -> torch.Tensor:
    """Gather k x k patches at the given corners into a (d, n) matrix,
    d = k*k*C (or k*k for a grey (H, W) image)."""
    rows, cols = _patch_index(corners, k)
    patches = img[rows, cols]                     # (n, k, k[, C])
    return patches.reshape(corners[0].shape[0], -1).T


def overlap_average(patch_values: torch.Tensor, corners, k: int,
                    out_shape) -> torch.Tensor:
    """Canvas where every painted pixel is the mean of the patch values
    covering it; unpainted pixels are 0."""
    n = corners[0].shape[0]
    channels = out_shape[2] if len(out_shape) == 3 else 1
    vals = patch_values.T.reshape(n, k, k, channels)
    rows, cols = _patch_index(corners, k)
    rows, cols = rows.expand(n, k, k), cols.expand(n, k, k)
    acc = torch.zeros((out_shape[0], out_shape[1], channels),
                      dtype=patch_values.dtype, device=patch_values.device)
    acc.index_put_((rows, cols), vals, accumulate=True)
    cnt = torch.zeros((out_shape[0], out_shape[1]), dtype=patch_values.dtype,
                      device=patch_values.device)
    cnt.index_put_((rows, cols), torch.ones_like(rows, dtype=cnt.dtype),
                   accumulate=True)
    out = acc / torch.clamp_min(cnt, 1.0)[..., None]
    return out.reshape(tuple(out_shape))


def _grid_counts(img_shape, k: int, stride: int, inclusive: bool):
    """Grid starts per axis: ``arange(0, H-k, s)`` (exclusive, the
    reference's strided recon grid) or every position (inclusive)."""
    def count(m):
        if inclusive:
            return m - k + 1
        return max(0, -(-(m - k) // stride))
    return count(img_shape[0]), count(img_shape[1])


def extract_patches_grid(img: torch.Tensor, k: int, stride: int = 1, *,
                         inclusive: bool = False) -> torch.Tensor:
    """Regular-grid patch extraction through ``F.unfold``; returns (d, n)
    in the same corner order and flattening as :func:`extract_patches`."""
    if inclusive:
        stride = 1  # the full-coverage grid is stride-1 by definition
    x = img[None, None] if img.dim() == 2 else img.permute(2, 0, 1)[None]
    C = x.shape[1]
    ni, nj = _grid_counts(img.shape, k, stride, inclusive)
    if ni == 0 or nj == 0:
        return img.new_zeros((k * k * C, 0))
    cols = F.unfold(x, k, stride=stride)          # (1, C*k*k, NI*NJ)
    NI = (img.shape[0] - k) // stride + 1
    NJ = (img.shape[1] - k) // stride + 1
    # features come in (C, kh, kw) order; reorder to (kh, kw, C)
    p = cols[0].reshape(C, k, k, NI, NJ)[:, :, :, :ni, :nj]
    return p.permute(1, 2, 0, 3, 4).reshape(k * k * C, ni * nj)


def overlap_average_grid(patch_values: torch.Tensor, k: int, stride: int,
                         out_shape, *, inclusive: bool = False) -> torch.Tensor:
    """Overlap average for a regular patch grid; equal to
    :func:`overlap_average` at the grid's corners. A float32 CUDA tensor
    takes the hand-written gather (``ops/kernels/patch_kernel.py``), any
    other :func:`overlap_average_fold`."""
    if inclusive:
        stride = 1  # must mirror extract_patches_grid
    ni, nj = _grid_counts(out_shape, k, stride, inclusive)
    if patch_values.shape[1] != ni * nj:
        raise ValueError(
            f"expected {ni * nj} patches for this grid, got "
            f"{patch_values.shape[1]}")
    if patch_values.is_cuda and patch_values.dtype == torch.float32:
        return patch_kernel.overlap_average(patch_values, k, stride, ni, nj,
                                            out_shape)
    return overlap_average_fold(patch_values, k, stride, ni, nj, out_shape)


def overlap_average_fold(patch_values: torch.Tensor, k: int, stride: int,
                         ni: int, nj: int, out_shape) -> torch.Tensor:
    """The plain overlap average of an ni x nj grid at ``stride`` through
    ``F.fold``: the values folded from a zeroed full grid, over the fold
    of its ones."""
    H, W = out_shape[0], out_shape[1]
    C = out_shape[2] if len(out_shape) == 3 else 1
    if ni == 0 or nj == 0:
        return patch_values.new_zeros(tuple(out_shape))
    NI, NJ = (H - k) // stride + 1, (W - k) // stride + 1
    # (kh, kw, C, ni, nj) -> fold's (C, kh, kw) features on the full grid
    vals = patch_values.reshape(k, k, C, ni, nj).permute(2, 0, 1, 3, 4)
    full = patch_values.new_zeros((C, k, k, NI, NJ))
    full[:, :, :, :ni, :nj] = vals
    acc = F.fold(full.reshape(1, C * k * k, NI * NJ), (H, W), k,
                 stride=stride)[0]                # (C, H, W)
    ones = patch_values.new_zeros((1, k, k, NI, NJ))
    ones[:, :, :, :ni, :nj] = 1.0
    cnt = F.fold(ones.reshape(1, k * k, NI * NJ), (H, W), k,
                 stride=stride)[0, 0]
    out = (acc / torch.clamp_min(cnt, 1.0)).permute(1, 2, 0)
    return out.reshape(tuple(out_shape))

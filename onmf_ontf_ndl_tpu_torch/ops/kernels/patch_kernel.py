"""A hand-written CUDA overlap average of a regular patch grid: the paint
of an image reconstruction.

No Pallas kernel stands behind it: the JAX package's
``overlap_average_grid`` (``onmf_ontf_ndl_tpu/ops/patches.py``) pads and
adds k^2 shifted slices. ``ops/patches.py::overlap_average_grid`` calls
:func:`overlap_average` for a float32 CUDA tensor and
``ops/patches.py::overlap_average_fold`` (``F.fold``) for any other; the
fold is the plain version the tests hold the kernel against.

:func:`overlap_average` runs ``csrc/patch_kernels.cu``: a thread a pixel
gathers, channel by channel and in ascending (kh, kw), the values of the
patches that cover it straight from the (k*k*C, ni*nj) matrix that
``W @ H`` writes, and divides by their number, taken in closed form from
the grid; it writes every pixel of the canvas once (0 where no patch
covers it), with no atomics: two calls give the same bits. It counts one
launch a call in ``_lib.LAUNCHES["overlap_average"]``.
"""

from __future__ import annotations

import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (
    LAUNCHES, _raise_on_error, _stream, build)

__all__ = ["overlap_average"]


def overlap_average(patch_values: torch.Tensor, k: int, stride: int,
                    ni: int, nj: int, out_shape) -> torch.Tensor:
    """The (H, W[, C]) canvas of the ni x nj grid of k x k patches at
    ``stride`` whose values ``patch_values`` (k*k*C, ni*nj), float32 on a
    CUDA device, holds in ``ops/patches.py``'s layout: rows (kh, kw, C),
    columns the corners row-major. Each pixel is the mean of the values
    covering it, 0 where none does."""
    out_shape = tuple(out_shape)
    H, W = out_shape[0], out_shape[1]
    C = out_shape[2] if len(out_shape) == 3 else 1
    if patch_values.dtype != torch.float32 or not patch_values.is_cuda:
        raise TypeError(f"overlap_average: needs a float32 CUDA tensor, got "
                        f"{patch_values.dtype} on {patch_values.device}")
    if tuple(patch_values.shape) != (k * k * C, ni * nj):
        raise ValueError(f"overlap_average: expected values of shape "
                         f"{(k * k * C, ni * nj)}, got "
                         f"{tuple(patch_values.shape)}")
    vals = patch_values.contiguous()
    dev = vals.device
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    lib = build()["lib"]
    with torch.cuda.device(dev):
        err = lib.onmf_overlap_average(vals.data_ptr(), out.data_ptr(), H, W,
                                       C, k, stride, ni, nj, _stream(vals))
    _raise_on_error("overlap_average", err)
    LAUNCHES["overlap_average"] += 1
    return out

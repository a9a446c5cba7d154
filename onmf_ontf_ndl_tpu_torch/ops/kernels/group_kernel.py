"""A hand-written CUDA grouping of a network reconstruction's paints by
directed node pair.

No Pallas kernel stands behind it: the JAX package groups with ``lax.sort``
and sums (``onmf_ontf_ndl_tpu/apps/network.py::_group_painted``). A
reconstruction of M samples of a k-node motif paints ``vals_T[q * k + r,
m]`` (``vals_T`` (k^2, M)) onto the pair ``(embs[m, q], embs[m, r])``
(``embs`` (M, k) node indices below n) for every slot (q, r) of every
sample; with ``include_self=False`` (and k > 1) the self slots q = r are
left out. The grouping is each painted pair's sum and number of paints, in
ascending (i, j).

On a CUDA tensor :func:`group_pairs` runs the kernels of
``csrc/group_kernels.cu``: the device writes each paint's key ``i * n + j``
(32 bits where n^2 <= 2^32, else 64) and value, sorts the pairs stably
over the key's significant bits alone (cub's radix sort, its scratch a
tensor on the current stream), and sums each run of equal keys in an order
fixed by the number of pairs and the tiling, with no atomics: two calls on
the same input give the same bits. The dense form writes each pair's mean
and count straight into two zeroed (n, n) canvases and reads nothing back;
the
sparse form reads the number of pairs once. It counts one launch a
grouping in ``_lib.LAUNCHES["group_pairs"]``. On a CPU tensor it runs
:func:`group_pairs_plain`, the int64 key sort and segment sum.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (
    LAUNCHES, _on_cpu, _raise_on_error, _stream, build)

__all__ = ["group_pairs", "group_pairs_plain"]

MAX_PAINTS = 2**31 - 1     # cub's item count is an int


def group_pairs_plain(embs, vals_T, n: int, include_self: bool = True):
    """Plain PyTorch :func:`group_pairs` (sparse form): one int64 key sort
    (``i * n + j``: no wrap at any n) and a sorted segment sum."""
    M, k = embs.shape
    eT = embs.T
    if include_self or k == 1:
        ii = eT[:, None, :].expand(k, k, M).reshape(-1)
        jj = eT[None, :, :].expand(k, k, M).reshape(-1)
        vv = vals_T.reshape(-1)
    else:
        qs, rs = np.nonzero(~np.eye(k, dtype=bool))
        ii = eT[torch.as_tensor(qs, device=eT.device)].reshape(-1)
        jj = eT[torch.as_tensor(rs, device=eT.device)].reshape(-1)
        vv = vals_T[torch.as_tensor(qs * k + rs, device=eT.device)].reshape(-1)
    skey, order = torch.sort(ii * n + jj, stable=True)
    keys, cnt = torch.unique_consecutive(skey, return_counts=True)
    sums = torch.segment_reduce(vv[order], "sum", lengths=cnt)
    return keys // n, keys % n, sums, cnt.to(vv.dtype)


def _check(name: str, t: torch.Tensor, dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise TypeError(f"group_pairs: {name} must be a contiguous {dtype} "
                        f"tensor of shape {shape}, got {t.dtype} "
                        f"{tuple(t.shape)}")


def group_pairs(embs, vals_T, n: int, include_self: bool = True,
                canvas=None):
    """Group the paints of ``embs`` (M, k) and ``vals_T`` (k^2, M) by pair
    (see the module docstring). Sparse form (``canvas=None``): ``(ii, jj,
    sums, cnt)``, one entry a painted pair, ascending in (i, j); ``sums``
    and ``cnt`` in the values' type. Dense form: ``canvas`` is two zeroed
    (n, n) tensors of the values' type, ``(recon, count)``; each painted
    pair's mean paint and paint count are written into them, and they are
    returned. Sums and counts, not means, so groups merge exactly; the
    self slots left out by ``include_self=False`` only ever paint
    self-loops, which the simple graph drops.

    On a CUDA tensor: the kernels, for int64 ``embs`` and float32 values;
    on a CPU tensor: :func:`group_pairs_plain`."""
    canvas = tuple(canvas) if canvas is not None else None
    if _on_cpu(embs, vals_T, *(canvas or ())):
        grouped = group_pairs_plain(embs, vals_T, n, include_self)
        if canvas is None:
            return grouped
        ii, jj, sums, cnt = grouped
        recon, count = canvas
        recon[ii, jj] = sums / cnt
        count[ii, jj] = cnt
        return canvas
    embs, vals_T = embs.contiguous(), vals_T.contiguous()
    M, k = embs.shape
    _check("embs", embs, torch.int64, (M, k))
    _check("vals_T", vals_T, torch.float32, (k * k, M))
    if canvas is not None:
        for name, t in zip(("recon", "count"), canvas):
            _check(name, t, torch.float32, (n, n))
    skip_self = not include_self and k > 1
    paints = M * k * (k - 1 if skip_self else k)
    if paints > MAX_PAINTS:
        raise ValueError(f"group_pairs: {paints} paints exceed the sort's "
                         f"{MAX_PAINTS}; reconstruct in chunks")
    dev = embs.device
    if paints == 0:
        if canvas is not None:
            return canvas
        index = torch.empty(0, dtype=torch.int64, device=dev)
        value = torch.empty(0, dtype=torch.float32, device=dev)
        return index, index.clone(), value, value.clone()
    wide = n * n > 2**32
    end_bit = (n * n - 1).bit_length()
    lib = build()["lib"]
    with torch.cuda.device(dev):
        stream = _stream(embs)
        keys = torch.empty((2, paints), device=dev,
                           dtype=torch.int64 if wide else torch.int32)
        vals = torch.empty((2, paints), dtype=torch.float32, device=dev)
        nbytes = ctypes.c_size_t()
        _raise_on_error("group_pairs", lib.onmf_group_sort_bytes(
            paints, int(wide), end_bit, ctypes.byref(nbytes)))
        temp = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
        selected = ctypes.c_int()
        _raise_on_error("group_pairs", lib.onmf_group_sort(
            embs.data_ptr(), vals_T.data_ptr(), M, k, int(skip_self), n,
            int(wide), end_bit, keys[0].data_ptr(), keys[1].data_ptr(),
            vals[0].data_ptr(), vals[1].data_ptr(), temp.data_ptr(),
            nbytes.value, ctypes.byref(selected), stream))
        keys, vals = keys[selected.value], vals[selected.value]
        tiles = -(-paints // lib.onmf_group_tile())
        parts = torch.empty(5 * tiles, dtype=torch.int32, device=dev)
        if canvas is not None:
            recon, count = canvas
            err = lib.onmf_group_sum(
                keys.data_ptr(), vals.data_ptr(), paints, int(wide), n, None,
                parts.data_ptr(), recon.data_ptr(), count.data_ptr(), None,
                None, None, None, stream)
            out = canvas
        else:
            heads = torch.empty(tiles, dtype=torch.int32, device=dev)
            offset = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
            _raise_on_error("group_pairs", lib.onmf_group_heads(
                keys.data_ptr(), paints, int(wide), heads.data_ptr(),
                offset.data_ptr(), stream))
            pairs = int(offset[-1])            # the one read by the host
            out = (torch.empty(pairs, dtype=torch.int64, device=dev),
                   torch.empty(pairs, dtype=torch.int64, device=dev),
                   torch.empty(pairs, dtype=torch.float32, device=dev),
                   torch.empty(pairs, dtype=torch.float32, device=dev))
            err = lib.onmf_group_sum(
                keys.data_ptr(), vals.data_ptr(), paints, int(wide), n,
                offset.data_ptr(), parts.data_ptr(), None, None,
                *(t.data_ptr() for t in out), stream)
    _raise_on_error("group_pairs", err)
    LAUNCHES["group_pairs"] += 1
    return out

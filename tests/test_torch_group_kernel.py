"""The grouping of a reconstruction's paints by pair on the CPU: the dense
form's canvases against the sparse form, the sparse form against a NumPy
grouping, and what the card's kernels may not use. The kernels themselves
are held on the card (``tests/test_torch_cuda.py -m cuda -k group``)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu_torch.apps.network import _group_painted
from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib


@pytest.mark.parametrize("M,k,n", [(50, 3, 7), (200, 5, 40), (30, 1, 4),
                                   (20, 4, 1)])
def test_dense_canvas_equals_the_sparse_grouping(M, k, n):
    rng = np.random.default_rng(M + k + n)
    embs = torch.as_tensor(rng.integers(0, n, (M, k)))
    vals = torch.as_tensor(rng.random((k * k, M)))
    _lib.reset_launches()
    ii, jj, sums, cnt = _group_painted(embs, vals, n)
    canvas = [torch.zeros((n, n), dtype=vals.dtype) for _ in range(2)]
    recon, count = _group_painted(embs, vals, n, canvas=canvas)
    assert recon is canvas[0] and count is canvas[1]
    want = torch.zeros((n, n), dtype=vals.dtype), torch.zeros((n, n))
    want[0][ii, jj] = sums / cnt
    want[1][ii, jj] = cnt.float()
    assert torch.equal(recon, want[0])
    assert torch.equal(count.float(), want[1])
    assert int(count.sum()) == M * k * k
    # the sparse form against a NumPy grouping of the same paints
    e, v = embs.numpy(), vals.numpy()
    key = (e[:, :, None] * n + e[:, None, :]).reshape(M, k * k).T.ravel()
    want_keys, inv, want_cnt = np.unique(key, return_inverse=True,
                                         return_counts=True)
    want_sums = np.bincount(inv, weights=v.ravel(), minlength=len(want_keys))
    np.testing.assert_array_equal(ii.numpy(), want_keys // n)
    np.testing.assert_array_equal(jj.numpy(), want_keys % n)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    np.testing.assert_allclose(sums.numpy(), want_sums, rtol=1e-12)
    assert _lib.LAUNCHES["group_pairs"] == 0


def test_group_kernels_take_no_atomics():
    """The run sums add in an order the tiling fixes: no atomic add (nor
    any other atomic) in the grouping's source, comments aside."""
    src = (Path(_lib.__file__).parent / "csrc" / "group_kernels.cu")
    code = "\n".join(line.split("//")[0]
                     for line in src.read_text().splitlines())
    assert "atomic" not in code.lower()

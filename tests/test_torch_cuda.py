"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerance: rtol 2e-4 / atol 2e-5, float32 summation order.
"""

import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck

TOL = dict(rtol=2e-4, atol=2e-5)


def make(d, r, n, seed):
    rng = np.random.default_rng(seed)
    W = rng.random((d, r)).astype(np.float32)
    X = rng.random((d, n)).astype(np.float32)
    H0 = rng.random((r, n)).astype(np.float32)
    return W.T @ W, W.T @ X, H0


def _t(a, device):
    return torch.from_numpy(np.array(a)).to(device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [25, 100])
@pytest.mark.parametrize("n", [ck.TN, 4 * ck.TN + 37])
def test_cuda_coder_kernels_match_plain(cuda, r, n):
    A, B, H0 = make(300, r, n, seed=r + n)
    A, B, H0 = _t(A, cuda), _t(B, cuda), _t(H0, cuda)
    ck.reset_launches()
    got = ck.coder_sweeps(A, B, H0, 0.1, sub_iter=10)
    got_es = ck.coder_sweeps_earlystop(A, B, H0, 0.1, 0.01, sub_iter=10)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["coder_sweeps"] == 1
    assert ck.LAUNCHES["coder_sweeps_earlystop"] == 1
    torch.testing.assert_close(got, ck.coder_sweeps_plain(A, B, H0, 0.1),
                               **TOL)
    # same tile width TN in both: the per-tile decisions agree
    torch.testing.assert_close(
        got_es, ck.coder_sweeps_earlystop_plain(A, B, H0, 0.1, 0.01), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,r", [(300, 25), (2000, 100), (75, 9)])
def test_cuda_dict_kernel_matches_plain(cuda, d, r):
    rng = np.random.default_rng(d)
    W = _t(rng.random((d, r)).astype(np.float32), cuda)
    A = _t(rng.random((r, r)).astype(np.float32), cuda)   # asymmetric
    B = _t(rng.random((r, d)).astype(np.float32), cuda)
    got = ck.dict_update_sweep(W, A, B)
    torch.testing.assert_close(got, ck.dict_update_sweep_plain(W, A, B),
                               **TOL)


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    A, B, H0 = make(20, 6, 8, seed=0)
    with pytest.raises(TypeError):
        ck.coder_sweeps(_t(A, cuda).double(), _t(B, cuda).double(),
                        _t(H0, cuda).double())
    with pytest.raises(ValueError):
        A, B, H0 = make(20, ck.MAX_RANK_EARLYSTOP + 1, 8, seed=0)
        ck.coder_sweeps_earlystop(_t(A, cuda), _t(B, cuda), _t(H0, cuda))


@pytest.mark.cuda
def test_cuda_refused_launch_raises(cuda, monkeypatch):
    # past the shared-memory limit the launch is refused: the wrapper must
    # raise, and the next launch must still work
    monkeypatch.setattr(ck, "MAX_RANK_EARLYSTOP", 200)
    A, B, H0 = make(300, 150, 256, seed=1)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        ck.coder_sweeps_earlystop(_t(A, cuda), _t(B, cuda), _t(H0, cuda))
    A, B, H0 = make(300, 25, 256, seed=1)
    A, B, H0 = _t(A, cuda), _t(B, cuda), _t(H0, cuda)
    torch.testing.assert_close(ck.coder_sweeps_earlystop(A, B, H0),
                               ck.coder_sweeps_earlystop_plain(A, B, H0),
                               **TOL)

"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerance: rtol 2e-4 / atol 2e-5, float32 summation order; the bf16 FISTA
product at rtol 2e-3 / atol 2e-4 (a float32 sum in another order can carry
a bf16-rounded input across a rounding boundary). The checkerboard kernel
draws the same bits as its plain version: equal site for site.
"""

import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck
from onmf_ontf_ndl_tpu_torch.ops.kernels import ising_kernel as ik

TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-3, atol=2e-4)


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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "stop", "bf16"])
@pytest.mark.parametrize("r", [25, 100])
@pytest.mark.parametrize("n", [ck.TN, 4 * ck.TN + 37])
def test_cuda_fista_kernel_matches_plain(cuda, mode, r, n):
    A, B, H0 = make(300, r, n, seed=3 * r + n)
    A, B, H0 = _t(A, cuda), _t(B, cuda), _t(H0, cuda)
    kw = dict(sub_iter=20, use_stopping=mode == "stop",
              bf16_matmul=mode == "bf16")
    ck.reset_launches()
    got = ck.fista_sweeps(A, B, H0, 0.1, 0.01, **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fista_sweeps"] == 1
    torch.testing.assert_close(
        got, ck.fista_sweeps_plain(A, B, H0, 0.1, 0.01, **kw),
        **(BF16_TOL if mode == "bf16" else TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 16, 200, 1026])
def test_cuda_checkerboard_kernel_equals_plain(cuda, n):
    rng = np.random.default_rng(n)
    lat = _t(rng.choice(np.array([1, -1], np.int8), (n, n)), cuda)
    lat0 = lat.clone()
    ck.reset_launches()
    got = ik.checkerboard_sweeps(12345, lat, 7, J=1.0, H=0.1, T=2.3)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["checkerboard_sweeps"] == 14
    want = ik.checkerboard_sweeps_plain(12345, lat, 7, J=1.0, H=0.1, T=2.3)
    assert torch.equal(got, want)
    assert torch.equal(lat, lat0)   # the input lattice is left as it was


@pytest.mark.cuda
def test_cuda_new_wrappers_raise_instead_of_falling_back(cuda):
    A, B, H0 = make(20, ck.MAX_RANK_FISTA_STOP + 1, 8, seed=0)
    with pytest.raises(ValueError):
        ck.fista_sweeps(_t(A, cuda), _t(B, cuda), _t(H0, cuda))
    with pytest.raises(TypeError):
        ik.checkerboard_sweeps(0, torch.ones((4, 4), device=cuda), 1)
    with pytest.raises(ValueError, match="even"):
        ik.checkerboard_sweeps(
            0, torch.ones((5, 5), dtype=torch.int8, device=cuda), 1)

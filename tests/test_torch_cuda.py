"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerance: rtol 2e-4 / atol 2e-5, float32 summation order; the bf16 FISTA
product at rtol 2e-3 / atol 2e-4 (a float32 sum in another order can carry
a bf16-rounded input across a rounding boundary); at the large ranks one
bf16 iteration at the f32 tolerance and ten at atol 1.5e-3, as
``chip_smoke.py`` checks them. At small ranks one such rounding moves a
column about as far as that (r = 8, n = 4133 on an NVIDIA H100 80GB HBM3:
1.2e-3 for the kernel, 1.7e-3 in one column for the plain version
against itself with its rows permuted; 2.1e-3 in 6 of 131,109 columns;
``chip_compare.py . new bf16``), so ``assert_bf16_close`` holds every
column to the tolerance or to one rounding. The checkerboard kernel
draws the same bits as its plain version: equal site for site, on every
route and vector width; so do its banded entry's bands, 1 to 4 of them,
with the halo rows copied, against the whole lattice. A small network run (20x20 torus) must launch the
coder and dictionary kernels, and its training on the card (float32) must
agree with the CPU (float64) from the same draws within 1e-3 relative; so
must a tiny video run, and a reconstruction in 2 chunks must give the CPU's
pairs and counts exactly and its means within rtol 1e-3 / atol 1e-4. The
overlap average's gather kernel holds the float64 ``F.fold`` form on the
CPU at the f32 tolerance (float32 sums of at most k^2 values), and so do
both apps' colour reconstructions on the card against their CPU runs.
"""

import functools

import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck
from onmf_ontf_ndl_tpu_torch.ops.kernels import ising_kernel as ik

TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-3, atol=2e-4)
BF16_TEN_TOL = dict(rtol=0.0, atol=1.5e-3)   # as chip_smoke.py's BF16_TOL


def make(d, r, n, seed):
    rng = np.random.default_rng(seed)
    W = rng.random((d, r)).astype(np.float32)
    X = rng.random((d, n)).astype(np.float32)
    H0 = rng.random((r, n)).astype(np.float32)
    return W.T @ W, W.T @ X, H0


def _t(a, device):
    return torch.from_numpy(np.array(a)).to(device)


def asymmetric_inputs(r, device):
    """(A, B, H0) with an A that is not symmetric: a near-identity Gram
    plus a shear, 500 columns. Past r = 256 the dictionary has 2 r rows, B
    is scaled by 1 / sqrt(d) and the shear by sqrt(256 / r), which keep
    |H| ~ 10 (see test_cuda_fista_takes_an_asymmetric_A)."""
    wide = r > 256
    d = 2 * r if wide else 300
    rng = np.random.default_rng(r)
    W = rng.standard_normal((d, r)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0)
    B = np.abs(W).T @ rng.random((d, 500)).astype(np.float32)
    if wide:
        B /= np.float32(np.sqrt(d))
    H0 = rng.random((r, 500)).astype(np.float32)
    shear = 0.1 * float(np.sqrt(256 / r)) if wide else 0.1
    A = W.T @ W + np.triu(
        shear * rng.standard_normal((r, r)).astype(np.float32), 1)
    assert not np.array_equal(A, A.T)
    return _t(A, device), _t(B, device), _t(H0, device)


def assert_bf16_close(kernel, plain, A, iters, tol):
    """``kernel(k)`` against ``plain(k)`` (the (r, n) results of k fixed bf16
    FISTA iterations) at k = ``iters``, column by column. Both round the
    same A and Y to bf16 and sum in float32, in another order, so a Y
    within a float32 rounding of a bf16 boundary can round apart: that
    column then moves by ``inv_L |A[:, j]|`` times one bf16 step of Y. A
    column agrees within ``tol``, or (few may: one in 500) it agrees at the
    float32 tolerance up to some iteration and leaves it there by at most
    two such steps. Returns the number of such columns."""
    got, want = kernel(iters), plain(iters)
    assert bool(torch.isfinite(got).all())
    bad = (~torch.isclose(got, want, **tol)).any(0).nonzero()[:, 0]
    if bad.numel() == 0:
        return 0
    assert bad.numel() <= max(1, got.shape[1] // 500), bad.numel()
    gs = [kernel(k)[:, bad] for k in range(1, iters + 1)]
    ws = [plain(k)[:, bad] for k in range(1, iters + 1)]
    scale = float(ck._inv_lipschitz(A) * A.abs().max())
    for i in range(bad.numel()):
        parted = next(k for k in range(iters) if not torch.allclose(
            gs[k][:, i], ws[k][:, i], **TOL))
        assert parted >= 1   # the first iteration rounds the same inputs
        # |Y| <= 2 max |H| of the two iterates before; bf16 keeps 8 bits
        y_max = max(2 * float(torch.stack(
            [ws[parted - 1][:, i], ws[max(parted - 2, 0)][:, i]]
        ).abs().max()), 2.0 ** -126)
        step = 2.0 ** (np.floor(np.log2(y_max)) - 7)
        jump = float((gs[parted][:, i] - ws[parted][:, i]).abs().max())
        assert jump <= 2 * scale * step, (int(bad[i]), parted, jump, step)
    return int(bad.numel())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(25, ck.TN), (25, 4 * ck.TN + 37),
                                 (100, ck.TN), (100, 4 * ck.TN + 37),
                                 (25, 16384), (100, 1000), (1, 1), (1, 500),
                                 (8, 100), (8, 131109), (25, 1), (25, 100),
                                 (25, 500), (25, 131109), (33, 1),
                                 (33, 500), (100, 100), (100, 500),
                                 (101, 100), (101, 500), (128, 1),
                                 (128, 500), (128, 131109)])
def test_cuda_coder_kernels_match_plain(cuda, r, n):
    # every instantiation of the lanes kernels (r = 1..128: 2 or 4 lanes of
    # 8, 16, 25 or 32 rows), a lone column, ragged last tiles and fewer
    # columns than a tile; the fixed-sweep coder also at 50 sweeps, where a
    # carried residual has the most time to drift
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
    if n <= 16384:
        torch.testing.assert_close(
            ck.coder_sweeps(A, B, H0, 0.1, sub_iter=50),
            ck.coder_sweeps_plain(A, B, H0, 0.1, sub_iter=50), **TOL)
    # same tile width TN in both: the per-tile decisions agree
    torch.testing.assert_close(
        got_es, ck.coder_sweeps_earlystop_plain(A, B, H0, 0.1, 0.01), **TOL)


def dict_inputs(d, r, psd, device):
    """(W, A, B) for a dictionary pass: an asymmetric A (any A must
    match), or A and B as training forms them: H H^T / n and H X^T / n from
    the code H of 500 columns X on a normalised W, by the coder kernel."""
    rng = np.random.default_rng(d + 1000 * r)
    W = rng.random((d, r)).astype(np.float32)
    if not psd:
        A = rng.random((r, r)).astype(np.float32)
        B = rng.random((r, d)).astype(np.float32)
        return _t(W, device), _t(A, device), _t(B, device)
    W /= np.linalg.norm(W, axis=0)
    W, X = _t(W, device), _t(rng.random((d, 500)).astype(np.float32), device)
    H = ck.coder_sweeps(W.T @ W, W.T @ X,
                        torch.zeros((r, 500), device=device), 0.1)
    return W, (H @ H.T) / 500, (H @ X.T) / 500


@pytest.mark.cuda
@pytest.mark.parametrize("psd", [False, True])
@pytest.mark.parametrize("d,r", [(300, 25), (2000, 100), (75, 9),
                                 (441, 25), (400, 100), (1200, 100),
                                 (300, 300),
                                 # the panel's edges (r = 1, k - 1, k,
                                 # k + 1, r not a multiple of k) and
                                 # fewer rows than a warp
                                 (33, 1), (50, 7), (50, 8), (64, 9),
                                 (100, 13), (1, 1), (20, 7), (31, 25)])
def test_cuda_dict_kernel_matches_plain(cuda, d, r, psd):
    # one CTA, a cluster of CTAs ((400, 100), (1200, 100)) and, past the
    # cluster's shared memory, the single-block kernel ((2000, 100),
    # (300, 300))
    W, A, B = dict_inputs(d, r, psd, cuda)
    ck.reset_launches()
    got = ck.dict_update_sweep(W, A, B)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["dict_update_sweep"] == 1
    torch.testing.assert_close(got, ck.dict_update_sweep_plain(W, A, B),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,r", [(300, 25), (441, 25), (400, 100),
                                 (1200, 100), (20, 7), (50, 8), (300, 300)])
def test_cuda_dict_kernel_counts_its_columns_and_panels(cuda, d, r):
    """Each call counts one run, its r columns and, in the panel form, its
    rank-k updates of G (one after each panel but the last), on every
    route; a replayed graph counts as a launch does."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib

    W, A, B = dict_inputs(d, r, False, cuda)
    route, _ = ck.dict_route(d, r)
    panels = 0 if route == "single" else (r - 1) // ck._DICT_PANEL
    _lib.reset_launches()
    eager = ck.dict_update_sweep(W, A, B)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ck.dict_update_sweep(W, A, B)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ck.dict_update_sweep(W, A, B)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    runs = _lib.device_runs()
    calls = 3   # eager, the side stream's, one replay (a capture runs none)
    assert _lib.LAUNCHES["dict_update_sweep"] == 3   # the replay calls none
    assert runs["dict_update_sweep"] == calls
    assert runs["dict.columns"] == calls * r
    assert runs["dict.panel_updates"] == calls * panels


@pytest.mark.cuda
@pytest.mark.parametrize("r", [25, 256])
def test_cuda_earlystop_multi_tile_converged(cuda, r):
    # many tiles, each freezing on its own relative-change test: every
    # tile's iterate must meet the global rule's guarantee (slack over
    # stop = 0.05 as in the Pallas kernel's test: the probe sweep takes the
    # larger i = 0 step); the shared kernel (r = 25) and the wide one
    from onmf_ontf_ndl_tpu_torch.ops.coder import _spectral_norm, _sweep

    A, B, H0 = make(300, r, 16 * ck.TN + 37, seed=11)
    A, B, H0 = _t(A, cuda), _t(B, cuda), _t(H0, cuda)
    ck.reset_launches()
    H = ck.coder_sweeps_earlystop(A, B, H0, 0.0, 0.05, sub_iter=50)
    assert ck.LAUNCHES["coder_sweeps_earlystop"] == 1
    probe = _sweep(H.clone(), A, B, 0.0, 1.0 / np.sqrt(10.0))
    assert bool((H >= 0).all())
    assert float(_spectral_norm(probe - H) / _spectral_norm(H)) <= 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "earlystop"])
@pytest.mark.parametrize("r", [25, 100, 101, 128, 129, 256, 257, 512, 1248])
def test_cuda_coder_takes_an_asymmetric_A(cuda, r, mode):
    # the plain version reads row k of A (A[k, :] @ H), and so does every
    # kernel: an A that is not symmetric must agree too (the shared kernels
    # up to r = 100 and 128, the wide kernel's regimes, the JAX limit)
    A, B, H0 = asymmetric_inputs(r, cuda)
    name = "coder_sweeps" if mode == "fixed" else "coder_sweeps_earlystop"
    args = (A, B, H0, 0.1) if mode == "fixed" else (A, B, H0, 0.1, 0.01)
    ck.reset_launches()
    got = getattr(ck, name)(*args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[name] == 1
    torch.testing.assert_close(got, getattr(ck, name + "_plain")(*args),
                               **TOL)


@pytest.mark.cuda
def test_cuda_coder_wide_config_matches_the_library(cuda):
    # the Python twin, which sizes the workspace, against the kernel
    # library's own shape at every rank of the wide kernel, both modes
    import ctypes

    lib = ck.build()["lib"]
    out = (ctypes.c_int * 10)()
    for use_stopping, first in ((True, 101), (False, 129)):
        for r in range(first, ck.MAX_RANK + 1):
            lib.onmf_coder_wide_config(r, int(use_stopping), out)
            assert tuple(out) == tuple(
                int(v) for v in ck.coder_wide_config(r, use_stopping)), r


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    A, B, H0 = make(20, 6, 8, seed=0)
    with pytest.raises(TypeError):
        ck.coder_sweeps(_t(A, cuda).double(), _t(B, cuda).double(),
                        _t(H0, cuda).double())
    with pytest.raises(ValueError, match="do not agree"):
        A, B, H0 = make(20, 150, 8, seed=0)
        ck.coder_sweeps_earlystop(_t(A, cuda), _t(B, cuda),
                                  _t(H0[:, :5], cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,r,n", [
    (mode, r, n) for mode in ("fixed", "earlystop", "fista_fixed",
                              "fista_stop", "fista_bf16")
    for r in (101, 128, 129, 256) for n in (ck.TN, 131072 + 37)] + [
    # FISTA's wide kernel on both sides of its regime boundary (Y in shared
    # memory up to FW_RESIDENT_MAX_RANK, streamed past it) and at the JAX
    # kernels' limit, three tiles with a ragged one there
    (mode, r, n) for mode in ("fista_fixed", "fista_stop", "fista_bf16")
    for r, n in [(r, n) for r in (ck.FW_RESIDENT_MAX_RANK,
                                  ck.FW_RESIDENT_MAX_RANK + 1, 512)
                 for n in (ck.TN, 131072 + 37)] + [(ck.MAX_RANK, 300)]] + [
    # the wide Gauss-Seidel kernel on both sides of each boundary of
    # coder_wide_config (slots, the Grams in shared memory, Gram blocks,
    # lanes) and at the JAX kernels' limit, three tiles with a ragged one
    (mode, r, 2 * ck.TN + 37) for mode in ("fixed", "earlystop")
    for r in (136, 137, 176, 177, 192, 193, 257, 512, 513, ck.MAX_RANK)])
def test_cuda_coder_kernels_take_large_ranks(cuda, mode, r, n):
    # every case above a kernel's shared-memory limit raised ValueError
    # before the workspace kernels; now each launches a kernel and agrees
    # with its plain version
    A, B, H0 = make(300, r, n, seed=r + n)
    A, B, H0 = _t(A, cuda), _t(B, cuda), _t(H0, cuda)
    if mode in ("fixed", "earlystop"):
        name = "coder_sweeps" if mode == "fixed" else "coder_sweeps_earlystop"
        kernel = getattr(ck, name)
        plain = getattr(ck, name + "_plain")
        args, kw = ((A, B, H0, 0.1) if mode == "fixed"
                    else (A, B, H0, 0.1, 0.01)), {}
    else:
        name, kernel, plain = "fista_sweeps", ck.fista_sweeps, \
            ck.fista_sweeps_plain
        args = (A, B, H0, 0.1, 0.01)
        kw = dict(sub_iter=10, use_stopping=mode == "fista_stop",
                  bf16_matmul=mode == "fista_bf16")
    ck.reset_launches()
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[name] == 1
    if mode == "fista_bf16":
        # chip_smoke.py's two stages: one iteration at the f32 tolerance
        # (both round the same inputs; the products are exact in f32), ten
        # at bf16 precision
        one = dict(kw, sub_iter=1)
        torch.testing.assert_close(kernel(*args, **one),
                                   plain(*args, **one), **TOL)
        torch.testing.assert_close(got, plain(*args, **kw),
                                   **BF16_TEN_TOL)
    else:
        torch.testing.assert_close(got, plain(*args, **kw), **TOL)


@pytest.mark.cuda
def test_cuda_coders_at_the_jax_limit_launch_kernels(cuda):
    # r = MAX_RANK, the largest rank the JAX wrappers keep in a kernel
    A, B, H0 = make(300, ck.MAX_RANK, ck.TN, seed=4)
    A, B, H0 = _t(A, cuda), _t(B, cuda), _t(H0, cuda)
    for name, kw in (("coder_sweeps", {}),
                     ("coder_sweeps_earlystop", dict(stopping_diff=0.01)),
                     ("fista_sweeps", dict(use_stopping=False)),
                     ("fista_sweeps", dict(use_stopping=True))):
        ck.reset_launches()
        got = getattr(ck, name)(A, B, H0, 0.1, sub_iter=3, **kw)
        torch.cuda.synchronize()
        assert ck.LAUNCHES[name] == 1
        torch.testing.assert_close(
            got, getattr(ck, name + "_plain")(A, B, H0, 0.1, sub_iter=3,
                                              **kw), **TOL)


@pytest.mark.cuda
def test_cuda_coders_past_the_jax_limit_run_the_plain_maths(cuda):
    # r = MAX_RANK + 1: the JAX wrappers hand the same maths to XLA; the
    # port runs it with torch on the card and counts no launch
    from onmf_ontf_ndl_tpu_torch.ops.coder import _code_impl, _fista_impl

    r = ck.MAX_RANK + 1
    A, B, H0 = make(300, r, 64, seed=5)
    A, B, H0 = _t(A, cuda), _t(B, cuda), _t(H0, cuda)
    ck.reset_launches()
    got = [ck.coder_sweeps(A, B, H0, 0.1, sub_iter=3),
           ck.coder_sweeps_earlystop(A, B, H0, 0.1, 0.01, sub_iter=3),
           ck.fista_sweeps(A, B, H0, 0.1, 0.01, sub_iter=3)]
    assert not any(ck.LAUNCHES.values())
    want = [_code_impl(A, B, H0, 0.1, None, None, 3, False, False),
            _code_impl(A, B, H0, 0.1, 0.01, None, 3, True, False),
            _fista_impl(A, B, H0, 0.1, 0.01, 3, True)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def _torus_edges(m):
    u = np.arange(m * m).reshape(m, m)
    return np.concatenate([
        np.stack([u.ravel(), np.roll(u, -1, 0).ravel()], 1),
        np.stack([u.ravel(), np.roll(u, -1, 1).ravel()], 1)])


@pytest.mark.cuda
def test_cuda_network_path_launches_kernels_and_matches_cpu(cuda):
    from onmf_ontf_ndl_tpu_torch.apps.network import (NetworkReconstructor,
                                                      ndl_train)
    from onmf_ontf_ndl_tpu_torch.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu_torch.models.state import init_state

    g = csr_graph_from_edges(_torus_edges(20), device="cpu")
    ck.reset_launches()
    rec = NetworkReconstructor(
        source=g, n_components=16, MCMC_iterations=8, sub_iterations=10,
        sample_size=200, batch_size=40, k1=0, k2=2, alpha=0.1,
        num_chains=8, device=cuda)
    W = rec.train_dict()
    edges = rec.reconstruct_network(recons_iter=20000, num_chains=64)
    acc = rec.compute_recons_accuracy()
    dense = rec.reconstruct_network(recons_iter=20000, num_chains=64,
                                    sparse=False)
    torch.cuda.synchronize()
    for name in ("coder_sweeps_earlystop", "coder_sweeps",
                 "dict_update_sweep"):
        assert ck.LAUNCHES[name] > 0, name
    assert W.device.type == "cuda" and bool((W >= 0).all())
    assert edges.shape[1] == 2 and acc > 0.9
    assert dense.shape == (400, 400) and rec.compute_recons_accuracy() > 0.9

    # the same short training on the card (float32) and on the CPU
    # (float64) from the same patches and draws, fixed sweeps; 1e-3 relative
    rng = np.random.default_rng(9)
    k2, r, S = 9, 16, 200
    W0 = rng.random((k2, r))
    draws = [((rng.random((k2, S)) < 0.4).astype(np.float64),
              [(rng.integers(0, S, 40), rng.random((r, 40)))
               for _ in range(9)]) for _ in range(4)]
    out = {}
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        dr = [(torch.as_tensor(X, dtype=dtype, device=device),
               [(torch.as_tensor(i, device=device),
                 torch.as_tensor(h, dtype=dtype, device=device))
                for i, h in inner]) for X, inner in draws]
        st = init_state(0, k2, r, device=device, dtype=dtype, W=W0)
        st, code, _ = ndl_train(
            st, g.to(device), torch.tensor([0, 1, 2], device=device),
            rec.B, mcmc_iterations=4, sample_size=S, inner_iterations=10,
            batch_size=40, alpha=0.1, use_stopping=False, subsample=True,
            draws=dr)
        out[str(device)] = st.W.double().cpu()
    rel = (out[str(cuda)] - out["cpu"]).norm() / out["cpu"].norm()
    assert float(rel) <= 1e-3


@pytest.mark.cuda
def test_cuda_chunked_reconstruction_matches_cpu(cuda):
    # chunks=2 on injected samples: the card (float32, coder kernel) against
    # the CPU (float64) pair for pair; then NetworkReconstructor's chunks=2
    # from its own generator
    from onmf_ontf_ndl_tpu_torch.apps.network import (
        NetworkReconstructor, reconstruct_network_sparse_chunked)
    from onmf_ontf_ndl_tpu_torch.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu_torch.samplers.motif import path_adj

    g = csr_graph_from_edges(_torus_edges(20), device="cpu")
    rng = np.random.default_rng(3)
    B, M, r = path_adj(0, 2), 3000, 16
    base = rng.integers(0, 400, (M, 1))
    embs = (base + rng.integers(0, 3, (M, 3)) * 20) % 400
    W, H0 = rng.random((9, r)), rng.random((r, M))
    out = {}
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        e = torch.as_tensor(embs, device=device)
        h = torch.as_tensor(H0, dtype=dtype, device=device)
        ck.reset_launches()
        out[str(device)] = reconstruct_network_sparse_chunked(
            torch.as_tensor(W, dtype=dtype, device=device), g.to(device),
            None, B, recons_iter=M, chunks=2,
            embs=[e[:1000], e[1000:]],
            H0=[h[:, :1000].contiguous(), h[:, 1000:].contiguous()])
        assert ck.LAUNCHES["coder_sweeps"] == (2 if device == cuda else 0)
    got, want = out[str(cuda)], out["cpu"]
    for i in (0, 1, 3):
        assert torch.equal(got[i].cpu().double(), want[i].double())
    torch.testing.assert_close(got[2].cpu().double(), want[2], rtol=1e-3,
                               atol=1e-4)

    ck.reset_launches()
    rec = NetworkReconstructor(
        source=g, n_components=16, MCMC_iterations=8, sub_iterations=10,
        sample_size=200, batch_size=40, k1=0, k2=2, alpha=0.1,
        num_chains=8, device=cuda)
    rec.train_dict()
    edges = rec.reconstruct_network(recons_iter=20000, num_chains=64,
                                    chunks=2)
    torch.cuda.synchronize()
    assert edges.shape[1] == 2 and rec.compute_recons_accuracy() > 0.9
    with pytest.raises(ValueError, match="chunk 1/2"):
        rec.reconstruct_network(recons_iter=20000, num_chains=64, chunks=2,
                                cap=10)


# The grouping's cases: (name, M, k, n, include_self, hub). The first
# `hub` samples sit on node n - 1 alone, so the pair (n - 1, n - 1) gets
# hub * k * (k or k - 1) paints, a run over many tiles of the run sum.
GROUP_CASES = [
    ("k21", 10_000, 21, 4039, True, 0),
    ("hub", 50_000, 5, 4039, True, 45_000),     # 1,125,000 paints of a pair
    ("no_self", 10_000, 21, 4039, False, 200),
    ("k1", 5_000, 1, 4039, False, 0),
    ("n1", 3_000, 4, 1, True, 0),
    ("empty", 0, 21, 4039, True, 0),
    ("wide_key", 20_000, 3, 3_000_000, False, 100),
]


def _paints(M, k, n, hub, seed):
    """(embs (M, k) int64, vals_T (k^2, M) float32 in [0, 2)): half the
    samples on all n nodes, half on the first 64 (runs of tens of paints),
    the first ``hub`` on node n - 1."""
    rng = np.random.default_rng(seed)
    embs = rng.integers(0, n, (M, k))
    embs[M // 2:] = rng.integers(0, min(n, 64), (M - M // 2, k))
    embs[:hub] = n - 1
    return embs, (2 * rng.random((k * k, M))).astype(np.float32)


def _sum_bound(exact):
    """How far a float32 sum of a run's c paints may lie from the float64
    sum ``exact[2]`` (of positive values, so it is also the sum of their
    magnitudes): any order of c - 1 float32 additions errs by at most
    gamma_(c-1) = (c - 1) u / (1 - (c - 1) u) times it, u = 2^-24; plus
    the float64 sum's own rounding, c 2^-53 times it."""
    c = exact[3].double()
    g = (c - 1).clamp(min=0) * 2.0**-24
    return (g / (1 - g) + c * 2.0**-53) * exact[2]


@pytest.mark.cuda
@pytest.mark.parametrize("name,M,k,n,include_self,hub", GROUP_CASES,
                         ids=[c[0] for c in GROUP_CASES])
def test_cuda_group_pairs_equals_the_torch_grouping(cuda, name, M, k, n,
                                                    include_self, hub):
    """The kernels' sparse grouping against the torch grouping on the same
    CUDA inputs: pairs and counts exactly equal, each sum within float32
    rounding of the float64 segment sum (:func:`_sum_bound`); a second
    call equal bit for bit; one launch counted a call on the card, none on
    the CPU."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib
    from onmf_ontf_ndl_tpu_torch.ops.kernels.group_kernel import (
        group_pairs, group_pairs_plain)

    embs, vals = _paints(M, k, n, hub, seed=len(name))
    e, v = _t(embs, cuda), _t(vals, cuda)
    _lib.reset_launches()
    if M:
        group_pairs(_t(embs, "cpu"), _t(vals, "cpu"), n,
                    include_self=include_self)
        assert _lib.LAUNCHES["group_pairs"] == 0
    got = group_pairs(e, v, n, include_self=include_self)
    again = group_pairs(e, v, n, include_self=include_self)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["group_pairs"] == (2 if M else 0)
    assert [t.dtype for t in got] == [torch.int64, torch.int64,
                                      torch.float32, torch.float32]
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if not M:
        assert all(t.numel() == 0 for t in got)
        return
    want = group_pairs_plain(e, v, n, include_self)
    exact = group_pairs_plain(e, v.double(), n, include_self)
    for i in (0, 1, 3):
        assert torch.equal(got[i], want[i]), i
    err = (got[2].double() - exact[2]).abs()
    bound = _sum_bound(exact)
    assert bool((err <= bound).all()), float((err - bound).max())
    if hub:
        per = k if include_self or k == 1 else k - 1
        assert int(got[3].max()) >= hub * k * per


@pytest.mark.cuda
@pytest.mark.parametrize("name,M,k,n,include_self,hub", [
    ("hub", 50_000, 5, 4039, True, 45_000),
    ("hub_no_self", 50_000, 5, 4039, False, 45_000),
    ("wide_key", 20_000, 3, 3_000_000, True, 10_000)])
def test_cuda_group_pairs_sums_integer_paints_exactly(cuda, name, M, k, n,
                                                      include_self, hub):
    """Paints of whole values 0 to 3: every partial sum of a run is a whole
    number below 2^24 (the hub's run of over a million paints sums to at
    most 3.4M), so float32 adds them exactly in any order, and each sum,
    a hub run over hundreds of tiles included, must equal the float64 sum
    exactly: a tile's partial lost or counted twice shows. The dense form's
    means are then the float32 quotient of those exact sums."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels.group_kernel import (
        group_pairs, group_pairs_plain)

    embs, _ = _paints(M, k, n, hub, seed=len(name))
    vals = np.random.default_rng(M + k).integers(0, 4, (k * k, M))
    e, v = _t(embs, cuda), _t(vals.astype(np.float32), cuda)
    ii, jj, sums, cnt = group_pairs(e, v, n, include_self=include_self)
    exact = group_pairs_plain(e, v.double(), n, include_self)
    assert torch.equal(ii, exact[0]) and torch.equal(jj, exact[1])
    assert torch.equal(cnt.double(), exact[3])
    assert torch.equal(sums.double(), exact[2])
    per = k if include_self else k - 1
    assert int(cnt.max()) >= hub * k * per
    if n * n <= 2**26:
        canvas = [torch.zeros((n, n), device=cuda) for _ in range(2)]
        recon, count = group_pairs(e, v, n, include_self=include_self,
                                   canvas=canvas)
        assert torch.equal(recon[ii, jj], sums / cnt)
        assert torch.equal(count[ii, jj], cnt)
        assert int((count > 0).sum()) == len(ii)


@pytest.mark.cuda
@pytest.mark.parametrize("name,M,k,n,hub", [
    ("k21", 10_000, 21, 4039, 0), ("hub", 50_000, 5, 4039, 45_000),
    ("n1", 3_000, 4, 1, 0), ("empty", 0, 21, 4039, 0)])
def test_cuda_group_pairs_writes_the_dense_canvas(cuda, name, M, k, n, hub):
    """The dense form (the canvases ``reconstruct_network`` returns): equal
    bit for bit to ``recon[ii, jj] = sums / cnt``, ``count[ii, jj] = cnt``
    of the kernels' own sparse form (the same sums), 0 elsewhere, and a
    second call equal; against the torch path's scatter, the counts equal
    and the means within the float32 bound of the float64 sums
    (:func:`_sum_bound`) over the count, and one rounding of the
    division."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels.group_kernel import (
        group_pairs, group_pairs_plain)

    embs, vals = _paints(M, k, n, hub, seed=len(name))
    e, v = _t(embs, cuda), _t(vals, cuda)
    canvas = [torch.zeros((n, n), device=cuda) for _ in range(2)]
    recon, count = group_pairs(e, v, n, canvas=canvas)
    assert recon is canvas[0] and count is canvas[1]
    again = group_pairs(e, v, n, canvas=[torch.zeros_like(recon)
                                         for _ in range(2)])
    assert torch.equal(recon, again[0]) and torch.equal(count, again[1])
    if not M:
        assert not recon.any() and not count.any()
        return
    ii, jj, sums, cnt = group_pairs(e, v, n)
    want = torch.zeros_like(recon), torch.zeros_like(count)
    want[0][ii, jj] = sums / cnt
    want[1][ii, jj] = cnt
    assert torch.equal(recon, want[0]) and torch.equal(count, want[1])
    torch_path = group_pairs_plain(e, v, n)
    exact = group_pairs_plain(e, v.double(), n)
    assert torch.equal(count[torch_path[0], torch_path[1]], torch_path[3])
    mean = exact[2] / exact[3]
    err = (recon[exact[0], exact[1]].double() - mean).abs()
    bound = _sum_bound(exact) / exact[3] + 2.0**-23 * mean
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.cuda
def test_cuda_grouping_reads_back_only_the_sparse_pair_count(cuda,
                                                            monkeypatch):
    """On the card neither form runs the torch grouping's operations
    (sort, run lengths, segment sum, indexed assignment: each made to
    raise here); with CUDA's sync debug mode set to raise, the dense form
    runs through, and the sparse form raises at its one host read (the
    pair count)."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels.group_kernel import group_pairs

    embs, vals = _paints(10_000, 21, 4039, 0, seed=3)
    e, v = _t(embs, cuda), _t(vals, cuda)
    canvas = [torch.zeros((4039, 4039), device=cuda) for _ in range(2)]
    group_pairs(e, v, 4039, canvas=canvas)      # the build, outside
    torch.cuda.synchronize()

    def refused(*args, **kwargs):
        raise AssertionError("the torch grouping ran on the card")

    for name in ("sort", "unique_consecutive", "segment_reduce"):
        monkeypatch.setattr(torch, name, refused)
    monkeypatch.setattr(torch.Tensor, "__setitem__", refused)
    torch.cuda.set_sync_debug_mode("error")
    try:
        group_pairs(e, v, 4039, canvas=canvas)
        with pytest.raises(RuntimeError, match="synchroniz"):
            group_pairs(e, v, 4039)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# (name, H, W, C, k, stride, inclusive): every k of {1, 3, 10, 20} at every
# stride of {1, 2, 3, 5}, grey and colour, on a non-square image; the full
# grid; k = H - 1; a tall image; an empty grid; the two reconstruction
# cells' shapes (image-recon: stride 1, k = 10; tensor-recon: stride 2,
# k = 20)
PAINT_CASES = [(f"k{k}_s{s}_c{c}", 37, 45, c, k, s, False)
               for k in (1, 3, 10, 20) for s in (1, 2, 3, 5) for c in (1, 3)]
PAINT_CASES += [
    ("inclusive_k1_c1", 37, 45, 1, 1, 1, True),
    ("inclusive_k3_c1", 37, 45, 1, 3, 1, True),
    ("inclusive_k10_c3", 37, 45, 3, 10, 1, True),
    ("inclusive_k20_c3", 37, 45, 3, 20, 1, True),
    ("k_h_minus_1", 21, 30, 3, 20, 1, False),
    ("k_h_minus_1_inclusive", 21, 30, 1, 20, 1, True),
    ("tall_s3", 61, 17, 3, 5, 3, False),
    ("empty", 10, 12, 3, 10, 1, False),
    ("image_recon", 1024, 1024, 3, 10, 1, False),
    ("tensor_recon", 1024, 1024, 3, 20, 2, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,H,W,C,k,stride,inclusive", PAINT_CASES,
                         ids=[c[0] for c in PAINT_CASES])
def test_cuda_overlap_average_equals_the_fold(cuda, monkeypatch, name, H, W,
                                              C, k, stride, inclusive):
    """The overlap average of a float32 CUDA tensor (the gather kernel)
    against the ``F.fold`` form in float64 on the CPU: within ``TOL``, the
    canvas float32 and contiguous, a second call equal bit for bit, one
    launch counted a call on the card, none on the CPU, and no fold on the
    card."""
    from onmf_ontf_ndl_tpu_torch.ops import patches
    from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib

    shape = (H, W, C) if C > 1 else (H, W)
    ni, nj = patches._grid_counts(shape, k, 1 if inclusive else stride,
                                  inclusive)
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    vals = torch.rand((k * k * C, ni * nj), generator=gen, device=cuda)
    _lib.reset_launches()
    want = patches.overlap_average_grid(vals.double().cpu(), k, stride, shape,
                                        inclusive=inclusive)
    assert _lib.LAUNCHES["overlap_average"] == 0

    def refused(*args, **kwargs):
        raise AssertionError("F.fold ran on the card")

    monkeypatch.setattr(patches.F, "fold", refused)
    got = patches.overlap_average_grid(vals, k, stride, shape,
                                       inclusive=inclusive)
    again = patches.overlap_average_grid(vals, k, stride, shape,
                                         inclusive=inclusive)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["overlap_average"] == 2
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert got.is_contiguous() and got.device == vals.device
    assert torch.equal(got, again)
    torch.testing.assert_close(got.double().cpu(), want, **TOL)
    if ni * nj == 0:
        assert not bool(got.any())


@pytest.mark.cuda
@pytest.mark.parametrize("inclusive", [False, True])
def test_cuda_float64_overlap_average_takes_the_fold(cuda, inclusive):
    """A float64 CUDA tensor keeps the ``F.fold`` form: nothing launched,
    and the CPU's fold within float64 rounding."""
    from onmf_ontf_ndl_tpu_torch.ops import patches
    from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib

    shape, k, stride = (37, 45, 3), 5, 2
    ni, nj = patches._grid_counts(shape, k, 1 if inclusive else stride,
                                  inclusive)
    vals = torch.rand((k * k * 3, ni * nj), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(9))
    _lib.reset_launches()
    got = patches.overlap_average_grid(vals.to(cuda), k, stride, shape,
                                       inclusive=inclusive)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["overlap_average"] == 0
    assert got.dtype == torch.float64 and got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), patches.overlap_average_grid(
        vals, k, stride, shape, inclusive=inclusive))


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["image", "tensor"])
def test_cuda_colour_reconstruction_paints_with_the_kernel(cuda, monkeypatch,
                                                          app):
    """A colour reconstruction of each app on the card (float32) against
    its CPU run (float64) from the same dictionary and initial codes (the
    coder's H0 drawn with numpy): within ``TOL``, and one launch of the
    overlap average a job on the card, none on the CPU."""
    from onmf_ontf_ndl_tpu_torch.apps import image
    from onmf_ontf_ndl_tpu_torch.apps.image_tensor import (
        ImageReconstructorTensor)
    from onmf_ontf_ndl_tpu_torch.models.state import init_state
    from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib

    rng = np.random.default_rng(27)
    img = rng.random((48, 56, 3))
    k, r, stride = (6, 12, 1) if app == "image" else (8, 16, 2)
    W0 = rng.random((3 * k * k, r)) * (rng.random((3 * k * k, r)) < 0.3)
    code = image.nonneg_code

    def coded(X, W, *, generator, **kw):
        H0 = np.random.default_rng(X.shape[1]).random((W.shape[1],
                                                       X.shape[1]))
        return code(X, W, torch.as_tensor(H0, dtype=W.dtype,
                                          device=W.device), **kw)

    monkeypatch.setattr(image, "nonneg_code", coded)
    out = {}
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        kw = dict(data=img, patch_size=k, n_components=r, device=device,
                  dtype=dtype)
        if app == "image":
            rec = image.ImageReconstructor(**kw)
            rec.state = init_state(0, 3 * k * k, r, device=device,
                                   dtype=dtype, W=W0)
        else:
            rec = ImageReconstructorTensor(**kw)
            rec.W = torch.as_tensor(W0, dtype=dtype, device=device)
        _lib.reset_launches()
        for _ in range(2):
            got = rec.reconstruct_image_color(data=img,
                                              recons_resolution=stride)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["overlap_average"] == (2 if device == cuda
                                                    else 0)
        assert tuple(got.shape) == img.shape and got.dtype == dtype
        out[str(device)] = got.double().cpu()
    torch.testing.assert_close(out[str(cuda)], out["cpu"], **TOL)


@pytest.mark.cuda
def test_cuda_video_path_launches_kernels_and_matches_cpu(cuda):
    # a tiny video run on the card (float32, kernels) against the CPU
    # (float64) from the same draws, fixed sweeps; 1e-3 relative
    from onmf_ontf_ndl_tpu_torch.apps.video import (VideoDictionaryLearner,
                                                    train_video_dict)
    from onmf_ontf_ndl_tpu_torch.models.state import init_state

    rng = np.random.default_rng(12)
    frames = rng.random((5, 40, 48, 3))
    k, r, num, inner = 6, 12, 64, 5
    W0 = rng.random((3 * k * k, r))
    draws = [((rng.integers(0, 40 - k, num), rng.integers(0, 48 - k, num)),
              [(rng.integers(0, num, 32), rng.random((r, 32)))
               for _ in range(inner - 1)]) for _ in range(10)]
    out = {}
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        dr = [(tuple(torch.as_tensor(c, device=device) for c in cs),
               [(torch.as_tensor(i, device=device),
                 torch.as_tensor(h, dtype=dtype, device=device))
                for i, h in steps]) for cs, steps in draws]
        ck.reset_launches()
        st = train_video_dict(
            init_state(0, 3 * k * k, r, device=device, dtype=dtype, W=W0),
            torch.as_tensor(frames, dtype=dtype, device=device),
            num_patches=num, inner_iterations=inner, batch_size=32,
            patch_size=k, epochs=2, alpha=0.1, use_stopping=False,
            subsample=True, draws=dr)
        assert st.t == 10 * inner
        if device == cuda:
            assert ck.LAUNCHES["coder_sweeps"] == 40
            assert ck.LAUNCHES["dict_update_sweep"] == 40
        out[str(device)] = st.W.double().cpu()
    rel = (out[str(cuda)] - out["cpu"]).norm() / out["cpu"].norm()
    assert float(rel) <= 1e-3

    ck.reset_launches()
    rec = VideoDictionaryLearner(frames=frames, n_components=r,
                                 patch_size=k, num_patches=num, device=cuda)
    W = rec.train_dict()
    frame = rec.reconstruct_frame(1, stride=2)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["coder_sweeps_earlystop"] == 5 * 9
    assert ck.LAUNCHES["coder_sweeps"] == 1
    assert W.device.type == "cuda" and bool((W >= 0).all())
    assert frame.shape == (40, 48, 3) and bool(torch.isfinite(frame).all())


@pytest.mark.cuda
def test_cuda_refused_launch_raises(cuda, monkeypatch):
    # past the shared-memory limit the shared kernel's launch is refused:
    # the wrapper must raise, and the next launch must still work
    monkeypatch.setitem(ck.SMEM_MAX_RANK, "coder_sweeps_earlystop", 200)
    A, B, H0 = make(300, 150, 256, seed=1)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        ck.coder_sweeps_earlystop(_t(A, cuda), _t(B, cuda), _t(H0, cuda))
    A, B, H0 = make(300, 25, 256, seed=1)
    A, B, H0 = _t(A, cuda), _t(B, cuda), _t(H0, cuda)
    torch.testing.assert_close(ck.coder_sweeps_earlystop(A, B, H0),
                               ck.coder_sweeps_earlystop_plain(A, B, H0),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,r,n", [
    (mode, r, n) for mode in ("fixed", "stop", "bf16") for r in (25, 100)
    for n in (ck.TN, 4 * ck.TN + 37)] + [
    # the tiled kernel's thread counts (64 to 512), a lone column, fewer
    # columns than a tile, a ragged last tile of many; one-tile stop runs
    # at the tensor path's 100 iterations
    (mode, r, n) for mode in ("fixed", "stop")
    for r in (1, 8, 25, 33, 100, 101, 128) for n in (1, 100, 500)] + [
    ("fixed", 25, 131109), ("stop", 25, 131109), ("fixed", 128, 131109),
    ("stop100", 25, 100), ("stop100", 100, 100), ("stop100", 100, 1)] + [
    # the bf16 product at the other thread counts, a few tiles and many
    ("bf16", r, n) for r in (1, 8, 33, 128) for n in (500, 4133)])
def test_cuda_fista_kernel_matches_plain(cuda, mode, r, n):
    A, B, H0 = make(300, r, n, seed=3 * r + n)
    A, B, H0 = _t(A, cuda), _t(B, cuda), _t(H0, cuda)
    kw = dict(sub_iter=100 if mode == "stop100" else 20,
              use_stopping=mode.startswith("stop"),
              bf16_matmul=mode == "bf16")
    ck.reset_launches()
    got = ck.fista_sweeps(A, B, H0, 0.1, 0.01, **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fista_sweeps"] == 1
    torch.testing.assert_close(
        got, ck.fista_sweeps_plain(A, B, H0, 0.1, 0.01, **kw),
        **(BF16_TOL if mode == "bf16" else TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8, 25, 33, 100, 128])
@pytest.mark.parametrize("n", [500, 4133, 16384])
def test_cuda_fista_bf16_parts_only_at_a_rounding(cuda, r, n):
    # chip_smoke.py's inputs (a normalised dictionary's Grams) and its two
    # bf16 stages: one iteration at the f32 tolerance, ten at atol 1.5e-3,
    # the few columns past it held to one rounding
    rng = np.random.default_rng(7 * r + n)
    W = rng.random((300, r)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0)
    A = _t(W.T @ W, cuda)
    B = _t(W.T @ rng.random((300, n)).astype(np.float32), cuda)
    H0 = _t(rng.random((r, n)).astype(np.float32), cuda)

    def run(fn):
        return lambda k: fn(A, B, H0, 0.1, 0.01, sub_iter=k,
                            use_stopping=False, bf16_matmul=True)

    kernel, plain = run(ck.fista_sweeps), run(ck.fista_sweeps_plain)
    torch.testing.assert_close(kernel(1), plain(1), **TOL)
    assert_bf16_close(kernel, plain, A, 10, BF16_TEN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("use_stopping", [False, True])
@pytest.mark.parametrize("r", [8, 25, 100, 128, 256, 384, 385, 512, 1248])
def test_cuda_fista_takes_an_asymmetric_A(cuda, r, use_stopping):
    # the step size comes from A v and the product is A Y, as the plain
    # version forms them: an A that is not symmetric must agree too (the
    # step-size kernel in shared memory and, at r = 256, from device
    # memory). A near-identity Gram plus a shear: 16 power steps have not
    # converged, and on the transpose they end at another step size, which
    # moves the result by 2e-3 (r = 8) to 1.2 (r = 256). Past r = 256 (the
    # wide kernel's regimes and the JAX limit) the same inputs reach
    # |H| ~ 150-450 (300 rows give a singular Gram past r = 300, and the
    # shear grows as sqrt(r)), where float32 cancellation alone puts the
    # plain version 5e-5 to 2e-4 from float64 on small entries: there the
    # dictionary has 2 r rows, the shear is scaled by sqrt(256 / r) and B
    # by 1 / sqrt(d), which keeps |H| ~ 10 (plain float32 within 6e-6 of
    # float64 at r = 384 to 1248)
    A, B, H0 = asymmetric_inputs(r, cuda)
    kw = dict(sub_iter=10, use_stopping=use_stopping)
    ck.reset_launches()
    got = ck.fista_sweeps(A, B, H0, 0.1, 0.01, **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fista_sweeps"] == 1
    torch.testing.assert_close(
        got, ck.fista_sweeps_plain(A, B, H0, 0.1, 0.01, **kw), **TOL)


# (n, sweeps) whose routes by checkerboard_route are one CTA, a cluster and
# device memory, at every vector width: n % 16 == 0, n % 8 == 0 (rows not
# 16-byte aligned), and neither (n / 2 not a multiple of 4: a Philox call
# straddles two rows)
@pytest.mark.cuda
@pytest.mark.parametrize("n,sweeps", [
    (2, 7), (6, 7), (16, 7), (18, 7), (24, 5), (32, 4), (200, 1), (202, 17),
    (200, 16), (208, 16), (256, 16), (482, 3), (1026, 3), (1032, 3),
    (1040, 3)])
def test_cuda_checkerboard_kernel_equals_plain(cuda, n, sweeps):
    rng = np.random.default_rng(n)
    lat = _t(rng.choice(np.array([1, -1], np.int8), (n, n)), cuda)
    lat0 = lat.clone()
    route, ctas = ik.checkerboard_route(n, sweeps)
    ck.reset_launches()
    got = ik.checkerboard_sweeps(12345, lat, sweeps, J=1.0, H=0.1, T=2.3)
    torch.cuda.synchronize()
    # one launch for a resident call, two a sweep from device memory
    assert ck.LAUNCHES["checkerboard_sweeps"] == (
        2 * sweeps if route == "global" else 1)
    want = ik.checkerboard_sweeps_plain(12345, lat, sweeps, J=1.0, H=0.1,
                                        T=2.3)
    assert torch.equal(got, want)
    assert torch.equal(lat, lat0)   # the input lattice is left as it was


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 24, 64, 202, 200, 1022, 1024])
def test_cuda_checkerboard_every_route_equals_plain(cuda, n):
    # the routes that checkerboard_route does not pick at this n, too
    import ctypes

    rng = np.random.default_rng(n)
    lat = _t(rng.choice(np.array([1, -1], np.int8), (n, n)), cuda)
    want = ik.checkerboard_sweeps_plain(9, lat, 3, J=1.0, H=-0.2, T=1.7)
    thr = (ctypes.c_uint * 10)(*ik.acceptance_thresholds(1.0, -0.2, 1.7))
    ran = []
    for ctas in (0, 1, 2, 4, 8):
        if ctas and not ik._resident_fits(n, ctas):
            continue
        got = lat.clone()
        assert ik._launch(got, n, 3, 9, thr, ctas) == (1 if ctas else 6)
        torch.cuda.synchronize()
        assert torch.equal(got, want), ctas
        ran.append(ctas)
    assert 0 in ran and len(ran) >= 2


@pytest.mark.cuda
def test_cuda_checkerboard_refuses_a_band_that_does_not_fit(cuda):
    import ctypes

    thr = (ctypes.c_uint * 10)(*ik.acceptance_thresholds(1.0, 0.0, 2.0))
    lat = torch.ones((1024, 1024), dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        ik._launch(lat, 1024, 1, 0, thr, 1)
    assert bool((lat == 1).all())


@pytest.mark.cuda
def test_cuda_new_wrappers_raise_instead_of_falling_back(cuda):
    A, B, H0 = make(20, 150, 8, seed=0)
    with pytest.raises(ValueError, match="do not agree"):
        ck.fista_sweeps(_t(A, cuda), _t(B, cuda), _t(H0[:, :5], cuda))
    with pytest.raises(TypeError):
        ik.checkerboard_sweeps(0, torch.ones((4, 4), device=cuda), 1)
    with pytest.raises(ValueError, match="even"):
        ik.checkerboard_sweeps(
            0, torch.ones((5, 5), dtype=torch.int8, device=cuda), 1)


# the banded entry of the sampler (parallel/ising_sharded.py): bands of a
# lattice in one process, the halo rows copied between them, against the
# plain whole-lattice sweeps: n % 16 == 0, and n = 200 (n % 8 == 0, with
# bands of 100 and 50 rows: n / 2 % 4 == 0) and 6 (a Philox call straddles
# rows and bands start inside one)
@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 200, 1024, 6])
@pytest.mark.parametrize("bands", [1, 2, 3, 4])
def test_cuda_banded_checkerboard_equals_plain(cuda, n, bands):
    from onmf_ontf_ndl_tpu_torch.parallel.ising_sharded import (
        banded_checkerboard_sweeps)

    if n % bands:
        pytest.skip(f"{bands} equal bands do not split {n} rows")
    rng = np.random.default_rng(n + bands)
    lat = _t(rng.choice(np.array([1, -1], np.int8), (n, n)), cuda)
    ck.reset_launches()
    got = banded_checkerboard_sweeps(77, lat, 5, bands, J=1.0, H=0.1, T=2.3)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["checkerboard_sweeps_band"] == 2 * 5 * bands
    assert ck.LAUNCHES["checkerboard_sweeps"] == 0
    want = ik.checkerboard_sweeps_plain(77, lat, 5, J=1.0, H=0.1, T=2.3)
    assert int((want != lat).sum()) > 0
    assert torch.equal(got, want)
    # one band and colour against the band's plain version, misaligned
    # rows too (the site-at-a-time path)
    rows = n // bands
    buf = torch.empty(rows * n + 1, dtype=torch.int8, device=cuda)
    band = buf[1:].view(rows, n)
    band.copy_(lat[:rows])
    above, below = lat[-1].clone(), lat[rows % n].clone()
    want = ik.checkerboard_band_half_plain(5, band, above, below, 0, 3, 1)
    assert torch.equal(ik.checkerboard_band_half(5, band, above, below, 0, 3,
                                                 1), want)


@pytest.mark.cuda
def test_cuda_band_never_runs_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA band")

    monkeypatch.setattr(ik, "checkerboard_band_half_plain", refuse)
    lat = torch.ones((16, 16), dtype=torch.int8, device=cuda)
    ck.reset_launches()
    ik.checkerboard_band_half(1, lat[:8], lat[-1], lat[8], 0, 0, 0, T=5.0)
    assert ck.LAUNCHES["checkerboard_sweeps_band"] == 1
    with pytest.raises(TypeError):
        ik.checkerboard_band_half(1, lat[:8].float(), lat[-1], lat[8], 0, 0,
                                  0)
    with pytest.raises(ValueError, match="rows"):
        ik.checkerboard_band_half(1, lat[:8], lat[-1], lat[8], 9, 0, 0)


@pytest.mark.cuda
def test_cuda_multihost_takes_nccl(cuda, tmp_path):
    import torch.distributed as dist

    from onmf_ontf_ndl_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=f"file://{tmp_path}/pg",
                         num_processes=1, process_id=0)
    try:
        assert dist.get_backend() == "nccl"
        assert multihost.process_count() == 1
        assert torch.cuda.current_device() == 0
    finally:
        multihost.shutdown()
    assert not multihost.is_initialized()


@pytest.mark.cuda
@pytest.mark.parametrize("stop", [None, 0.01])
def test_cuda_auto_train_dict_on_a_one_rank_mesh_equals_train_dict(
        cuda, tmp_path, stop):
    # {"dp": 1, "tp": 1} over one NCCL rank: the step gathers over tp and
    # sums over dp, each the identity, and makes train_dict's products on
    # its shapes, captured with its collectives: the state equal bit for
    # bit, the code to index_add_'s float32 rounding (as
    # _assert_runs_equal holds it), the generators' next draws equal
    from onmf_ontf_ndl_tpu_torch.models import onmf
    from onmf_ontf_ndl_tpu_torch.models.state import init_state
    from onmf_ontf_ndl_tpu_torch.parallel import auto, multihost

    X = torch.rand((60, 3000), generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    kw = dict(iterations=7, batch_size=512, stopping_diff=stop, alpha=0.1,
              beta=0.9)
    multihost.initialize(coordinator_address=f"file://{tmp_path}/pg",
                         num_processes=1, process_id=0)
    try:
        mesh = multihost.global_mesh({"dp": 1, "tp": 1})
        onmf._GRAPHS.clear()
        for seed in (3, 5):             # a capture, then a replay
            got, got_code = auto.auto_train_dict(
                init_state(seed, 60, 12, device=cuda), X, mesh=mesh,
                tp_axis="tp", **kw)
            assert [k[-1].tp is not None for k in onmf._GRAPHS] == [True]
            want, want_code = onmf.train_dict(
                init_state(seed, 60, 12, device=cuda), X, **kw)
            torch.cuda.synchronize()
            got = auto.unshard_state(got)
            for f in "WABC":
                assert torch.equal(getattr(got, f), getattr(want, f)), f
            assert got.t == want.t == 7.0
            torch.testing.assert_close(got_code, want_code, rtol=1e-5,
                                       atol=1e-6)
            assert torch.equal(torch.rand(8, generator=got.gen, device=cuda),
                               torch.rand(8, generator=want.gen, device=cuda))
            onmf._GRAPHS.pop(next(k for k in onmf._GRAPHS
                                  if k[-1].tp is None))
    finally:
        multihost.shutdown()


# ------------------------------------------- the captured training loop
# Captured against eager (``_train_loop(capture=False)``) from one state and
# one generator state: the same kernels on the same inputs in the same
# order, so W, A, B and C are equal bit for bit; the code is summed by
# index_add_, whose atomics add in another order from run to run (float32
# rounding: rtol 1e-5 / atol 1e-6); the objectives are reductions of equal
# inputs.
CAPTURE_CASES = {
    "iid_stop": dict(coder="bcd", stop=0.01),
    "iid_fixed_metrics": dict(coder="bcd", stop=None, metrics=True),
    "iid_fista": dict(coder="fista", stop=None),
    "iid_fista_stop_xxt": dict(coder="fista", stop=0.01, xxt=True),
    "iid_fista_bf16": dict(coder="fista_bf16", stop=None),
    "block_stop": dict(coder="bcd", stop=0.01, sampling="block"),
    "block_fixed_fresh": dict(coder="bcd", stop=None, sampling="block",
                              dict_from="fresh"),
    "block_fista": dict(coder="fista", stop=None, sampling="block"),
    "full_batch_xxt": dict(coder="bcd", stop=0.01, subsample=False,
                           xxt=True),
    "no_code": dict(coder="bcd", stop=0.01, track_code=False),
    "draws": dict(coder="bcd", stop=0.01, draws=True, metrics=True),
    "draws_full_batch": dict(coder="fista", stop=None, draws=True,
                             subsample=False),
}


def _train(dev, X, capture, seed=3, steps=6, batch=512, coder="bcd",
           stop=None, sampling="iid", dict_from="stale", xxt=False,
           subsample=True, track_code=True, metrics=False, draws=False):
    from onmf_ontf_ndl_tpu_torch.models import onmf
    from onmf_ontf_ndl_tpu_torch.models.state import init_state

    d, n = X.shape
    r = 12
    st = init_state(seed, d, r, device=dev, track_xxt=xxt)
    given = None
    if draws:
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        width = batch if subsample else n
        given = [(torch.randint(0, n, (batch,), generator=g, device=dev)
                  if subsample else None,
                  torch.rand((r, width), generator=g, device=dev))
                 for _ in range(steps)]
    code = torch.rand((r, n), generator=torch.Generator(
        device=dev).manual_seed(seed + 2), device=dev)
    out = onmf._train_loop(st, X, code, 0.1, 0.9, stop, steps + 1, batch,
                           subsample, 10, track_code, dict_from,
                           backend="cuda", track_metrics=metrics,
                           sampling=sampling, draws=given, coder=coder,
                           capture=capture)
    torch.cuda.synchronize()
    return out


def _assert_runs_equal(got, want):
    for f in "WABC":
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert got[0].t == want[0].t
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    assert torch.equal(torch.rand(8, generator=got[0].gen,
                                  device=got[0].W.device),
                       torch.rand(8, generator=want[0].gen,
                                  device=want[0].W.device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_cuda_captured_training_equals_eager(cuda, case):
    from onmf_ontf_ndl_tpu_torch.models import onmf

    X = torch.rand((60, 3000), generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    onmf._GRAPHS.clear()
    kw = CAPTURE_CASES[case]
    _assert_runs_equal(_train(cuda, X, True, **kw),
                       _train(cuda, X, False, **kw))
    assert len(onmf._GRAPHS) == 1
    # a second call replays the graph it captured
    entry = next(iter(onmf._GRAPHS.values()))
    _assert_runs_equal(_train(cuda, X, True, seed=5, **kw),
                       _train(cuda, X, False, seed=5, **kw))
    assert next(iter(onmf._GRAPHS.values())) is entry


@pytest.mark.cuda
@pytest.mark.parametrize("subsample", [True, False])
def test_cuda_captured_training_equals_eager_on_a_transposed_x(cuda,
                                                               subsample):
    """Data in a transposed layout (an app's patches are a transposed
    view), at the Ising app's patch shape: the captured step's own copy of
    it keeps that layout, so its products see the strides the eager
    route's see and round alike; a graph keys on the strides."""
    from onmf_ontf_ndl_tpu_torch.models import onmf

    X = torch.rand((1000, 400), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda).T
    onmf._GRAPHS.clear()
    kw = dict(coder="bcd", stop=0.01, subsample=subsample, xxt=True,
              batch=50, track_code=False)
    for data in (X, X.contiguous()):
        _assert_runs_equal(_train(cuda, data, True, **kw),
                           _train(cuda, data, False, **kw))
    assert len(onmf._GRAPHS) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("own", [True, False])
def test_cuda_captured_graph_takes_new_data(cuda, own, monkeypatch):
    """New data of the same shape replays the graph (an owned buffer takes
    a copy) or, for data read in place, captures anew; the graph keeps the
    address of data it reads in place, not the tensor. Each replay counts
    one launch a step of each kernel on the path, and the kernels' own
    count of their runs on the card agrees."""
    import gc
    import weakref

    from onmf_ontf_ndl_tpu_torch.models import onmf
    from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (RUN_KERNELS,
                                                          device_runs)
    from onmf_ontf_ndl_tpu_torch.utils.capture import tensor_at
    from onmf_ontf_ndl_tpu_torch.utils.profiling import Throughput

    if not own:
        monkeypatch.setattr(onmf, "_OWN_X_BYTES", 0)
    onmf._GRAPHS.clear()
    gen = torch.Generator(device=cuda).manual_seed(1)
    X1, X2 = (torch.rand((60, 3000), generator=gen, device=cuda)
              for _ in range(2))
    _train(cuda, X1, True, stop=0.01)
    entry = next(iter(onmf._GRAPHS.values()))
    assert entry.buffers.owns_x is own
    assert (entry.buffers.X is None) is not own
    assert entry.reads == (() if own else (tensor_at(X1),))
    x1 = weakref.ref(X1)
    del X1
    gc.collect()
    assert x1() is None             # the cache does not keep the data
    ck.reset_launches()
    got = _train(cuda, X2, True, stop=0.01, steps=6)
    Throughput.fence(got)
    assert torch.cuda.current_stream().query()
    assert (next(iter(onmf._GRAPHS.values())) is entry) is own
    assert ck.LAUNCHES["coder_sweeps_earlystop"] == 6
    assert ck.LAUNCHES["dict_update_sweep"] == 6
    assert ck.LAUNCHES["coder_sweeps"] == ck.LAUNCHES["fista_sweeps"] == 0
    runs = device_runs()
    assert {k: runs[k] for k in RUN_KERNELS} \
        == {k: ck.LAUNCHES[k] for k in RUN_KERNELS}
    _assert_runs_equal(got, _train(cuda, X2, False, stop=0.01, steps=6))
    ck.reset_launches()
    _train(cuda, X2, True, stop=0.01, steps=6)       # a hit either way
    assert ck.LAUNCHES["dict_update_sweep"] == 6
    assert device_runs()["dict_update_sweep"] == 6
    entry = next(iter(onmf._GRAPHS.values()))
    # another step count is another graph (the tables hold each step)
    ck.reset_launches()
    _assert_runs_equal(_train(cuda, X2, True, stop=0.01, steps=5),
                       _train(cuda, X2, False, stop=0.01, steps=5))
    assert next(reversed(onmf._GRAPHS.values())) is not entry
    assert len(onmf._GRAPHS) == 2
    assert ck.LAUNCHES["dict_update_sweep"] == 2 * 5
    assert device_runs()["dict_update_sweep"] == 2 * 5


@pytest.mark.cuda
def test_cuda_graph_cache_stays_small(cuda):
    from onmf_ontf_ndl_tpu_torch.models import onmf

    onmf._GRAPHS.clear()
    X = torch.rand((60, 3000), device=cuda)
    for batch in (128, 256, 384, 512, 640, 768):
        _train(cuda, X, True, batch=batch, steps=2)
    assert len(onmf._GRAPHS) == onmf._GRAPHS.size


@pytest.mark.cuda
def test_cuda_debug_nans_takes_the_eager_route(cuda):
    from onmf_ontf_ndl_tpu_torch.models import onmf
    from onmf_ontf_ndl_tpu_torch.utils.debug import debug_nans

    onmf._GRAPHS.clear()
    X = torch.rand((60, 3000), device=cuda)
    _train(cuda, X, True, stop=0.01)
    assert onmf._GRAPHS
    with debug_nans():
        assert not onmf._GRAPHS         # entering drops the captured steps
        got = _train(cuda, X, True, stop=0.01)
    assert not onmf._GRAPHS
    _assert_runs_equal(got, _train(cuda, X, False, stop=0.01))
    X[0, :] = float("nan")
    with debug_nans(), pytest.raises(FloatingPointError, match="t=1"):
        _train(cuda, X, True, subsample=False)
    assert not onmf._GRAPHS


# --------------------------------------------------- the captured chain
# Captured against eager (``run_chains(capture=False)``) from one set of
# chains and one generator state: the same moves on the same draws, so the
# trail, the final embeddings and the generator's next draw are equal bit
# for bit.
def _chain_graphs(device, m=12):
    from onmf_ontf_ndl_tpu_torch.data import graphs as tg

    edges = _torus_edges(m)
    # a few chords, so that degrees differ and Glauber moves have more than
    # one common neighbour to choose from
    chords = np.stack([np.arange(0, m * m, 7), np.arange(3, m * m + 3, 7)
                       % (m * m)], 1)
    edges = np.concatenate([edges, chords])
    return {"dense": tg.graph_from_edgelist(edges, device=device),
            "csr": tg.csr_graph_from_edges(edges, device=device),
            "bitset": tg.bitset_graph_from_edges(edges, device=device)}


def _chains(g, B, C, seed, steps, capture, use_glauber):
    """``steps`` moves of C chains from pivots of ``seed``: (trail, the
    generator's next draw)."""
    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    dev = g.deg.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.randint(0, g.num_nodes, (C,), generator=gen, device=dev)
    emb0 = tm.tree_sample(gen, tm.tree_parents(B), g, x0)
    trail = tm.run_chains(gen, g, emb0, B, steps, use_glauber=use_glauber,
                          capture=capture)
    torch.cuda.synchronize()
    return trail, torch.rand(8, generator=gen, device=dev)


def _assert_chains_equal(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[0][:, -1], want[0][:, -1])
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 21])
@pytest.mark.parametrize("rep", ["dense", "csr", "bitset"])
@pytest.mark.parametrize("use_glauber", [True, False],
                         ids=["glauber", "pivot"])
def test_cuda_captured_chains_equal_eager(cuda, use_glauber, rep, k):
    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    g = _chain_graphs(cuda)[rep]
    B = tm.path_adj(0, k - 1)
    tm._CHAIN_GRAPHS.clear()
    kw = dict(C=32, steps=40, use_glauber=use_glauber)
    _assert_chains_equal(_chains(g, B, seed=1, capture=True, **kw),
                         _chains(g, B, seed=1, capture=False, **kw))
    assert len(tm._CHAIN_GRAPHS) == 1       # one block of the run's moves
    entry = next(iter(tm._CHAIN_GRAPHS.values()))
    assert entry.buffers.trail.shape == (32, 40, k)
    # one launch of the chain kernel a replay, nothing else
    assert entry.launches == {n: int(n == "chain_move")
                              for n in entry.launches}
    # a second call replays the graph it captured, from other chains and
    # another generator; a shorter and a longer run and one of a single
    # move have blocks of their own moves, so graphs of their own
    _assert_chains_equal(_chains(g, B, seed=2, capture=True, **kw),
                         _chains(g, B, seed=2, capture=False, **kw))
    assert len(tm._CHAIN_GRAPHS) == 1
    assert next(iter(tm._CHAIN_GRAPHS.values())) is entry
    for seed, steps in ((3, 7), (4, 97), (5, 1)):
        kw["steps"] = steps
        _assert_chains_equal(_chains(g, B, seed=seed, capture=True, **kw),
                             _chains(g, B, seed=seed, capture=False, **kw))
    assert len(tm._CHAIN_GRAPHS) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("use_glauber", [True, False],
                         ids=["glauber", "pivot"])
def test_cuda_captured_blocks_with_a_remainder(cuda, use_glauber,
                                               monkeypatch):
    """A run longer than its block: blocks of M replayed, then a graph of
    the rest; equal to the eager route and to the moves run one at a time
    (the frozen moves of before the blocks); the kernel's own runs are the
    replays, one a block."""
    from test_torch_chain_kernel import FROZEN, frozen_tree_sample

    from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import device_runs
    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    g = _kernel_graphs(cuda)["ba"]["csr"]
    B = tm.path_adj(0, 20)
    parents = tm.tree_parents(B)
    C, steps = 64, 61
    kind = tm._chain_kind(use_glauber, 21)
    # a move's draws and trail row: 20 or 16 + 4 * 20 bytes, and 8 * 21
    per_move = C * ({"glauber": 20, "pivot": 96}[kind] + 8 * 21)
    # blocks of 9 moves: 6 of them, then one of 7
    monkeypatch.setattr(tm, "_BLOCK_BYTES", 9 * per_move)
    assert tm._chain_block_moves(C, 21, kind, steps) == 9
    assert tm._chain_blocks(steps, 9) == [(9, 6), (7, 1)]
    tm._CHAIN_GRAPHS.clear()
    x0 = torch.randint(0, g.num_nodes, (C,), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(4))
    runs = {}
    for route, kw in (("captured", {}), ("captured again", {}),
                      ("eager", dict(capture=False))):
        gen = torch.Generator(device=cuda).manual_seed(5)
        emb0 = tm.tree_sample(gen, parents, g, x0)
        ck.reset_launches()
        trail = tm.run_chains(gen, g, emb0, B, steps,
                              use_glauber=use_glauber, **kw)
        runs[route] = (trail, torch.rand(8, generator=gen, device=cuda))
        # one kernel run a block, the replayed ones included
        assert device_runs()["chain_move"] == 7
        assert ck.LAUNCHES["chain_move"] == 7
    assert len(tm._CHAIN_GRAPHS) == 2        # the block's and the rest's
    gen = torch.Generator(device=cuda).manual_seed(5)
    emb, trail = frozen_tree_sample(gen, parents, g, x0), []
    for _ in range(steps):
        emb = FROZEN[use_glauber](gen, B, parents, g, emb)
        trail.append(emb)
    runs["frozen"] = (torch.stack(trail, 1),
                      torch.rand(8, generator=gen, device=cuda))
    for route in ("captured again", "eager", "frozen"):
        _assert_chains_equal(runs["captured"], runs[route])


@pytest.mark.cuda
def test_cuda_ndl_train_captured_equals_eager(cuda):
    """``ndl_train`` with its chains and steps replayed against
    ``capture=False``: W, A and B equal bit for bit, the chains equal, the
    state generator's next draw equal; through the ensemble (8 chains) and
    one chain, the early stop and fixed sweeps."""
    from onmf_ontf_ndl_tpu_torch.apps.network import ndl_train
    from onmf_ontf_ndl_tpu_torch.models.state import init_state
    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    g = _chain_graphs(cuda)["csr"]
    B = tm.path_adj(0, 2)
    for num_chains, stop in ((8, True), (1, False)):
        out = {}
        for capture in (True, False):
            st = init_state(5, 9, 6, device=cuda)
            emb0 = tm.tree_sample(torch.Generator(device=cuda).manual_seed(
                6), tm.tree_parents(B), g,
                torch.arange(num_chains, device=cuda))
            st, code, emb = ndl_train(
                st, g, emb0 if num_chains > 1 else emb0[0], B,
                mcmc_iterations=4, sample_size=64, inner_iterations=6,
                batch_size=16, alpha=0.1, num_chains=num_chains,
                use_stopping=stop, capture=capture)
            torch.cuda.synchronize()
            out[capture] = (st, code, emb,
                            torch.rand(8, generator=st.gen, device=cuda))
        (st1, code1, emb1, r1), (st0, code0, emb0_, r0) = out[True], out[False]
        for f in "WAB":
            assert torch.equal(getattr(st1, f), getattr(st0, f)), f
        assert st1.t == st0.t
        torch.testing.assert_close(code1, code0, rtol=1e-5, atol=1e-6)
        assert torch.equal(emb1, emb0_) and torch.equal(r1, r0)


@pytest.mark.cuda
def test_cuda_rebuilt_graph_is_captured_anew(cuda):
    """A graph rebuilt from the same edges sits at new addresses: its
    chains are captured anew, and the cache holds the first graph's
    tensors while it keeps their entry."""
    import gc
    import weakref

    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    B = tm.path_adj(0, 2)
    tm._CHAIN_GRAPHS.clear()
    g1 = _chain_graphs(cuda)["csr"]
    kw = dict(C=16, steps=20, use_glauber=True)
    want = _chains(g1, B, seed=1, capture=False, **kw)
    _assert_chains_equal(_chains(g1, B, seed=1, capture=True, **kw), want)
    entry = next(iter(tm._CHAIN_GRAPHS.values()))
    held = weakref.ref(g1.nbr_flat)
    del g1
    gc.collect()
    assert held() is not None          # the entry keeps what it reads
    g2 = _chain_graphs(cuda)["csr"]
    _assert_chains_equal(_chains(g2, B, seed=1, capture=True, **kw), want)
    assert len(tm._CHAIN_GRAPHS) == 2
    assert next(reversed(tm._CHAIN_GRAPHS.values())) is not entry
    assert entry.reads[0] is held()


@pytest.mark.cuda
def test_cuda_chain_cache_stays_within_its_size(cuda):
    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    g = _chain_graphs(cuda)["csr"]
    B = tm.path_adj(0, 2)
    tm._CHAIN_GRAPHS.clear()
    size = tm._CHAIN_GRAPHS.size
    for C in range(1, size + 3):
        _chains(g, B, C=C, seed=C, steps=3, capture=True, use_glauber=True)
        assert len(tm._CHAIN_GRAPHS) == min(C, size)
    # the least recently used went first
    assert [key[0][0] for key in tm._CHAIN_GRAPHS] == list(
        range(3, size + 3))


@pytest.mark.cuda
def test_cuda_failing_chain_capture_raises(cuda, monkeypatch):
    """A block that fails while it is captured raises out of run_chains;
    nothing is cached and no block falls back to the eager loop."""
    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    g = _chain_graphs(cuda)["dense"]
    B = tm.path_adj(0, 2)
    tm._CHAIN_GRAPHS.clear()
    move = tm._chain_block
    calls = []

    def failing(ch, gen, *args):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            raise RuntimeError("refused while capturing")
        move(ch, gen, *args)

    monkeypatch.setattr(tm, "_chain_block", failing)
    with pytest.raises(RuntimeError, match="refused while capturing"):
        _chains(g, B, C=8, seed=1, steps=10, capture=True, use_glauber=True)
    assert calls == [False, True]      # one eager block, then the capture
    assert not tm._CHAIN_GRAPHS
    monkeypatch.setattr(tm, "_chain_block", move)
    _assert_chains_equal(
        _chains(g, B, C=8, seed=1, steps=10, capture=True, use_glauber=True),
        _chains(g, B, C=8, seed=1, steps=10, capture=False,
                use_glauber=True))


# ----------------------------------------------------- the chain kernel
# csrc/motif_kernels.cu against its plain version (chain_moves_plain, the
# apply half of samplers/motif.py's moves) from the same draws, and the
# kernel's chains against the plain route's and the moves' before the
# split: equal bit for bit. The smoke's Barabasi-Albert graph has hubs of
# up to 797 neighbours (a Glauber candidate row of 25 chunks of a warp);
# a 30 x 30 torus has none.
@functools.cache
def _kernel_graphs(device):
    from chip_smoke import ba_edges, torus_edges
    from onmf_ontf_ndl_tpu_torch.data import graphs as tg

    out = {}
    for name, edges in (("ba", ba_edges(4039, 22, 0)),
                        ("torus", torus_edges(30))):
        out[name] = {
            "dense": tg.graph_from_edgelist(edges, device=device),
            "csr": tg.csr_graph_from_edges(edges, device=device),
            "bitset": tg.bitset_graph_from_edges(edges, device=device)}
    return out


def _draws(kind, gen, g, B, emb):
    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    C, k = emb.shape
    n, x, parents = g.num_nodes, emb[:, 0], tm.tree_parents(B)
    if kind == "glauber":
        return tm._glauber_draws(gen, C, k, n, emb.device)
    if kind == "walk":
        return tm._walk_draws(gen, n, x)
    if kind == "pivot":
        return tm._walk_draws(gen, n, x) + tm._tree_draws(gen, parents, n, x)
    return tm._tree_draws(gen, parents, n, x)


def _block_draws(kind, gen, g, B, emb, moves):
    """``moves`` moves' draws stacked into (M, ...) tensors, in the plain
    moves' order (their shapes do not depend on the chains)."""
    return tuple(torch.stack(d) for d in zip(
        *[_draws(kind, gen, g, B, emb) for _ in range(moves)]))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 21])
@pytest.mark.parametrize("rep", ["dense", "csr", "bitset"])
@pytest.mark.parametrize("graph", ["ba", "torus"])
def test_cuda_chain_kernel_equals_plain(cuda, graph, rep, k):
    """Blocks of moves: the kernel against chain_moves_plain on the same
    chains and draws, the block's (C, M, k) trail written in full; 8
    chains (a team of warps a Glauber chain where the graph has hubs) and
    1,024 (a warp a chain); M at the route's value for a run of 50 moves
    (all 50) and a remainder of 7; the tree (tree_sample) at M = 1 without
    a trail and at 7 with one."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels import motif_kernel as mk
    from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import device_runs
    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    g = _kernel_graphs(cuda)[graph][rep]
    B = tm.path_adj(0, k - 1)
    parents = tm.tree_parents(B)
    tbl = tm._neighbor_table_on(B, cuda) if k > 1 else None
    ck.reset_launches()
    launched = 0
    for C in (8, 1024):
        gen = torch.Generator(device=cuda).manual_seed(k + C)
        emb = tm.tree_sample(gen, parents, g, torch.randint(
            0, g.num_nodes, (C,), generator=gen, device=cuda))
        launched += 1                                   # tree_sample's
        emb[:4, 0] = torch.topk(g.deg, 4).indices      # the hubs
        for kind in ("glauber" if k > 1 else "walk", "pivot", "tree"):
            M = tm._chain_block_moves(C, k, "walk" if kind == "tree"
                                      else kind, 50)
            assert M == 50
            for moves, with_trail in (((M, True), (7, True)) if kind != "tree"
                                      else ((1, False), (7, True))):
                draws = _block_draws(kind, gen, g, B, emb, moves)
                trail = None
                if with_trail:
                    trail = torch.full((C, moves, k), -1, dtype=torch.int64,
                                       device=cuda)
                out = {}
                for name, fn in (("plain", mk.chain_moves_plain),
                                 ("kernel", mk.chain_moves)):
                    t = None if trail is None else trail.clone()
                    out[name] = (fn(kind, emb.clone(), draws, g, tbl,
                                    parents, t), t)
                launched += 1
                torch.cuda.synchronize()
                (got, got_t), (want, want_t) = out["kernel"], out["plain"]
                assert torch.equal(got, want), (kind, C, moves,
                                                (got != want).sum())
                if with_trail:
                    assert torch.equal(got_t, want_t), (kind, C, moves)
                    assert torch.equal(got_t[:, -1], got)
                    assert bool((got_t >= 0).all())
                emb = got
    with pytest.raises(TypeError, match="trail"):     # not the block's
        mk.chain_moves("tree", emb, draws, g, tbl, parents, torch.empty(
            (C, draws[0].shape[0] + 1, k), dtype=torch.int64, device=cuda))
    assert ck.LAUNCHES["chain_move"] == launched
    assert device_runs()["chain_move"] == launched


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 21])
@pytest.mark.parametrize("rep", ["dense", "csr", "bitset"])
@pytest.mark.parametrize("use_glauber", [True, False],
                         ids=["glauber", "pivot"])
def test_cuda_kernel_chains_equal_the_plain_moves(cuda, use_glauber, rep, k):
    """run_chains on the kernel (captured and eager) against
    ``backend="torch"`` (captured) and the moves before the split, from
    one generator state: trail, final embeddings, next draw."""
    from test_torch_chain_kernel import FROZEN, frozen_tree_sample

    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    g = _kernel_graphs(cuda)["ba"][rep]
    B = tm.path_adj(0, k - 1)
    parents = tm.tree_parents(B)
    tm._CHAIN_GRAPHS.clear()
    x0 = torch.randint(0, g.num_nodes, (256,), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(2))
    runs = {}
    for route, kw in (("kernel", {}), ("eager", dict(capture=False)),
                      ("torch", dict(backend="torch"))):
        gen = torch.Generator(device=cuda).manual_seed(3)
        emb0 = tm.tree_sample(gen, parents, g, x0)
        trail = tm.run_chains(gen, g, emb0, B, 30, use_glauber=use_glauber,
                              **kw)
        torch.cuda.synchronize()
        runs[route] = (trail, torch.rand(8, generator=gen, device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(3)
    emb, trail = frozen_tree_sample(gen, parents, g, x0), []
    for _ in range(30):
        emb = FROZEN[use_glauber](gen, B, parents, g, emb)
        trail.append(emb)
    runs["frozen"] = (torch.stack(trail, 1),
                      torch.rand(8, generator=gen, device=cuda))
    for route in ("eager", "torch", "frozen"):
        _assert_chains_equal(runs["kernel"], runs[route])
    assert len(tm._CHAIN_GRAPHS) == 2       # the kernel's and the plain's


@pytest.mark.cuda
def test_cuda_chains_run_no_plain_arithmetic(cuda, monkeypatch):
    """On a CUDA tensor every block of run_chains (both routes) and
    tree_sample runs the kernel: the plain version is never called, and
    the kernel's own run count equals the wrapper's launches."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels import motif_kernel as mk
    from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import device_runs
    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    def refuse(*args, **kw):
        raise AssertionError("the plain move ran on the card")

    monkeypatch.setattr(tm, "chain_moves_plain", refuse)
    monkeypatch.setattr(mk, "chain_moves_plain", refuse)
    g = _chain_graphs(cuda)["csr"]
    tm._CHAIN_GRAPHS.clear()
    ck.reset_launches()
    for use_glauber, k in ((True, 3), (False, 21), (True, 1)):
        _chains(g, tm.path_adj(0, k - 1), C=64, seed=k, steps=25,
                capture=True, use_glauber=use_glauber)
        _chains(g, tm.path_adj(0, k - 1), C=64, seed=k, steps=5,
                capture=False, use_glauber=use_glauber)
    # per case: a tree_sample and one block of 25 captured moves (run
    # eagerly while captured, so no replay), a tree_sample and one block of
    # 5 eager moves; then the same 25 again: one replay
    assert ck.LAUNCHES["chain_move"] == 3 * (1 + 1 + 1 + 1)
    for use_glauber, k in ((True, 3), (False, 21), (True, 1)):
        _chains(g, tm.path_adj(0, k - 1), C=64, seed=k, steps=25,
                capture=True, use_glauber=use_glauber)
    assert ck.LAUNCHES["chain_move"] == 3 * (1 + 1 + 1 + 1) + 3 * (1 + 1)
    assert device_runs()["chain_move"] == ck.LAUNCHES["chain_move"]


# ------------------------------------------------------- the apps' rounds
# models/onmf.py::_run_rounds: each app's round captured once as a CUDA
# graph and replayed a round at a time, against the same rounds in a
# Python loop (capture=False): W, A, B and C, the chains, the lattices,
# the dictionary stack and the errors equal bit for bit, the code to
# float32 rounding (index_add_ adds in no fixed order), the generators'
# next draws equal; one capture per key, one replay per round after the
# first, and the wrappers' launch counts equal to the kernels' own runs.

def _round_graph(app):
    from onmf_ontf_ndl_tpu_torch.models import onmf

    entries = [e for key, e in onmf._ROUND_GRAPHS.items()
               if key[0][0] == app]
    assert len(entries) == 1, (app, len(entries))
    return entries[0]


def _assert_state_equal(got, want):
    for f in "WABC":
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.t == want.t
    assert torch.equal(torch.rand(8, generator=got.gen, device=got.W.device),
                       torch.rand(8, generator=want.gen,
                                  device=want.W.device))


def _counts_match_runs():
    from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib

    torch.cuda.synchronize()
    runs = _lib.device_runs()
    assert {k: ck.LAUNCHES[k] for k in _lib.RUN_KERNELS} \
        == {k: runs[k] for k in _lib.RUN_KERNELS}


@functools.cache
def _round_inputs(device):
    """The image, the frames and the graph of ``_app_run``, made once: a
    round graph reads them in place, so runs on them share it."""
    g = torch.Generator(device=device).manual_seed(100)
    return (torch.rand((60, 64, 3), generator=g, device=device),
            torch.rand((3, 40, 48, 3), generator=g, device=device),
            _chain_graphs(device)["csr"])


def _app_run(cuda, app, capture, seed=0, rounds=5):
    """(state, the app's other outputs) of a small run of ``app``."""
    from onmf_ontf_ndl_tpu_torch.apps import (image, image_tensor, ising,
                                              network, video)
    from onmf_ontf_ndl_tpu_torch.models.state import init_state
    from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

    g = torch.Generator(device=cuda).manual_seed(100 + seed)
    img, frames, gr = _round_inputs(cuda)
    if app == "image":
        st = image.train_image_dict(
            init_state(seed, 75, 8, device=cuda), img,
            outer_iterations=rounds, num_patches=300, inner_iterations=6,
            batch_size=64, patch_size=5, subsample=True, capture=capture)
        return st, ()
    if app == "tensor":
        st = image_tensor._train_tensor(
            init_state(seed, 48, 8, device=cuda), img,
            outer_iterations=rounds, num_patches=40, inner_iterations=3,
            batch_size=40, patch_size=4, mode=2, joint=True, alpha=2.0,
            beta=1.0, sub_iter=100, coder="fista", capture=capture)
        return st, ()
    if app == "video":
        st = video.train_video_dict(
            init_state(seed, 75, 8, device=cuda), frames, num_patches=100,
            inner_iterations=5, batch_size=100, patch_size=5,
            epochs=-(-rounds // 3), capture=capture)
        return st, ()
    if app == "ising":
        from onmf_ontf_ndl_tpu_torch.samplers.ising import init_lattice

        lat = init_lattice(g, 32)
        st, stack, errors, lat, traj = ising.ising_trajectory_learning(
            init_state(seed, 36, 8, device=cuda, track_xxt=True), lat, g,
            ising_iterations=rounds, nsteps=2000, num_patches=300,
            inner_iterations=5, batch_size=300, patch_size=6, T=2.5,
            keep_trajectory=True, capture=capture)
        return st, (stack, errors, lat, traj, torch.rand(4, generator=g,
                                                         device=cuda))
    B = tm.path_adj(0, 2)
    emb0 = tm.tree_sample(g, tm.tree_parents(B), gr,
                          torch.arange(8, device=cuda))
    st, code, emb = network.ndl_train(
        init_state(seed, 9, 6, device=cuda), gr, emb0, B,
        mcmc_iterations=rounds, sample_size=64, inner_iterations=6,
        batch_size=16, alpha=0.1, num_chains=8, subsample=True,
        capture=capture)
    return st, (code, emb)


ROUND_APPS = ("image", "tensor", "video", "ising", "network")


@pytest.mark.cuda
@pytest.mark.parametrize("app", ROUND_APPS)
def test_cuda_captured_rounds_equal_eager(cuda, app):
    from onmf_ontf_ndl_tpu_torch.models import onmf

    onmf._ROUND_GRAPHS.clear()
    for seed in (0, 1):       # the second run replays the first's graph
        ck.reset_launches()
        got = _app_run(cuda, app, True, seed)
        _counts_match_runs()
        want = _app_run(cuda, app, False, seed)
        _assert_state_equal(got[0], want[0])
        for i, (a, b) in enumerate(zip(got[1], want[1])):
            if app == "network" and i == 0:           # the code
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            else:
                assert a.dtype == b.dtype and torch.equal(a, b), i
        entry = _round_graph(app)
        rounds = 6 if app == "video" else 5
        assert entry.replays == (rounds - 1 if seed == 0 else 2 * rounds - 1)
    assert len(onmf._ROUND_GRAPHS) == 1


@pytest.mark.cuda
def test_cuda_rounds_replay_a_graph_of_their_capacity(cuda):
    """Runs of 3 and 4 rounds share a graph of capacity 4 (the chunks of a
    checkpointed run); 5 rounds capture one of capacity 8; each run equals
    its eager rounds."""
    from onmf_ontf_ndl_tpu_torch.models import onmf

    onmf._ROUND_GRAPHS.clear()
    for rounds, graphs in ((3, 1), (4, 1), (5, 2)):
        got = _app_run(cuda, "ising", True, rounds=rounds)
        want = _app_run(cuda, "ising", False, rounds=rounds)
        _assert_state_equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a, b)
        assert len(onmf._ROUND_GRAPHS) == graphs
    assert sorted(key[-2] for key in onmf._ROUND_GRAPHS) == [4, 8]


@pytest.mark.cuda
def test_cuda_stack_rounds_are_captured(cuda):
    """``ImageReconstructor(is_stack=True)`` trains through the video
    rounds: one graph, a replay a matrix after the first."""
    from onmf_ontf_ndl_tpu_torch.apps.image import ImageReconstructor
    from onmf_ontf_ndl_tpu_torch.models import onmf

    stack = torch.rand((4, 40, 40), generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    onmf._ROUND_GRAPHS.clear()
    rec = ImageReconstructor(data=stack, is_stack=True, n_components=6,
                             iterations=8, sub_iterations=5,
                             num_patches=200, patch_size=5, device=cuda)
    W = rec.train_dict()
    assert _round_graph("video").replays == 2 * 4 - 1
    assert rec.state.t == 8 * 5 and bool(torch.isfinite(W).all())


@pytest.mark.cuda
def test_cuda_failing_round_capture_raises(cuda, monkeypatch):
    """A round that fails while it is captured raises out of the app;
    nothing is cached and no round falls back to the eager loop."""
    from onmf_ontf_ndl_tpu_torch.apps import image
    from onmf_ontf_ndl_tpu_torch.models import onmf

    onmf._ROUND_GRAPHS.clear()
    extract = image.extract_patches
    calls = []

    def failing(*args):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            raise RuntimeError("refused while capturing")
        return extract(*args)

    monkeypatch.setattr(image, "extract_patches", failing)
    with pytest.raises(RuntimeError, match="refused while capturing"):
        _app_run(cuda, "image", True)
    assert calls == [False, True]      # one eager round, then the capture
    assert not onmf._ROUND_GRAPHS


@pytest.mark.cuda
@pytest.mark.parametrize("n,sweeps", [(16, 5), (6, 3), (32, 4), (200, 16),
                                      (200, 1), (24, 1), (1024, 2)])
def test_cuda_device_seed_equals_host_seed(cuda, n, sweeps):
    """The device-seed entry on every route (resident on one CTA, on a
    cluster, device memory; each vector width) equals the host-seed entry
    site for site, also replayed from a CUDA graph with the seed written
    on the device between replays."""
    rng = np.random.default_rng(n)
    lat = torch.from_numpy(rng.choice(np.array([1, -1], np.int8),
                                      (n, n))).to(cuda)
    seeds = (0, 12345, 2**31 - 2, 2**32 - 1)
    for seed in seeds:
        want = ik.checkerboard_sweeps(seed, lat, sweeps, 1.0, 0.1, 2.3)
        got = ik.checkerboard_sweeps(torch.tensor([seed], device=cuda), lat,
                                     sweeps, 1.0, 0.1, 2.3)
        assert torch.equal(got, want), seed
    buf = torch.zeros(1, dtype=torch.int64, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ik.checkerboard_sweeps(buf, lat, sweeps, 1.0, 0.1, 2.3)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ik.checkerboard_sweeps(buf, lat, sweeps, 1.0, 0.1, 2.3)
    for seed in seeds:
        buf.fill_(seed)
        graph.replay()
        assert torch.equal(out, ik.checkerboard_sweeps(
            seed, lat, sweeps, 1.0, 0.1, 2.3)), seed


# ------------------------------------- the program's own trace record


def _early_stop(kind, A, B, H0, stop, sub_iter):
    if kind == "coder":
        return ck.coder_sweeps_earlystop(A, B, H0, 0.0, stop,
                                         sub_iter=sub_iter)
    return ck.fista_sweeps(A, B, H0, 0.0, stop, sub_iter=sub_iter,
                           use_stopping=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, r", [("coder", 25), ("coder", 128),
                                     ("fista", 25), ("fista", 128)],
                         ids=["lanes", "wide", "fista", "fista_wide"])
def test_cuda_early_stop_counts_its_column_sweeps(cuda, kind, r):
    """The kernels' own count of the early stop's work: with stop 0 no
    tile converges, so each runs ``sub_iter`` sweeps; with a stop no tile
    can miss each stops after its first; the columns once a launch. A
    replay from a CUDA graph counts as a launch does. FISTA counts into
    its own slots (``fista.*``) and leaves the Gauss-Seidel coders'
    (``coder_es.*``) at 0, and they leave FISTA's."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib

    n, sub_iter = 4 * ck.TN + 37, 7
    A, B, H0 = (_t(a, cuda) for a in make(300, r, n, r))
    route = "fista_sweeps_stop" if kind == "fista" \
        else "coder_sweeps_earlystop"
    assert ck.kernel_route(route, r) == ("shared" if r <= 100
                                         else "workspace")
    own, other = ("fista.column_iters", "fista.columns"), (
        "coder_es.column_sweeps", "coder_es.columns")
    if kind != "fista":
        own, other = other, own

    def counted(fn):
        _lib.reset_launches()
        fn()
        runs = _lib.device_runs()
        assert (runs[other[0]], runs[other[1]]) == (0, 0)
        return runs[own[0]], runs[own[1]]

    assert counted(lambda: _early_stop(kind, A, B, H0, 0.0, sub_iter)) \
        == (sub_iter * n, n)
    assert counted(lambda: _early_stop(kind, A, B, H0, 1e6, sub_iter)) \
        == (n, n)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _early_stop(kind, A, B, H0, 0.0, sub_iter)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _early_stop(kind, A, B, H0, 0.0, sub_iter)

    def replays():
        for _ in range(3):
            graph.replay()

    assert counted(replays) == (3 * sub_iter * n, 3 * n)


def _es_form(monkeypatch, S):
    """Force the early-stop coder's form: 1 CTA a tile, or a cluster of
    S (the route, coder_es_cluster, would pick by shape)."""
    monkeypatch.setattr(ck, "coder_es_cluster", lambda r, n, sms=132: S)


def _es_counted(A, B, H0, stop, sub_iter):
    """The early-stop coder's code and its own counts of the call."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib

    _lib.reset_launches()
    H = ck.coder_sweeps_earlystop(A, B, H0, 0.1, stop, sub_iter=sub_iter)
    runs = _lib.device_runs()
    return H, (runs["coder_es.column_sweeps"], runs["coder_es.columns"],
               runs["coder_es.cluster_columns"])


def _es_tile_sweeps(A, B, H0, stop, sub_iter):
    """Each tile's sweeps, from a launch on its columns alone."""
    n = B.shape[1]
    out = []
    for t0 in range(0, n, ck.TN):
        c = slice(t0, min(n, t0 + ck.TN))
        _, (col_sweeps, cols, _) = _es_counted(
            A, B[:, c].contiguous(), H0[:, c].contiguous(), stop, sub_iter)
        out.append(col_sweeps // cols)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("stop,sub_iter", [(0.01, 10), (0.05, 50)])
@pytest.mark.parametrize("r,n,S", [(100, 1000, 8), (100, 129, 8),
                                   (40, 2 * ck.TN + 37, 4),
                                   (40, 2 * ck.TN + 37, 8),
                                   (64, 504, 4),
                                   (100, 3 * ck.TN + 37, 8)])
def test_cuda_earlystop_cluster_equals_one_cta(cuda, monkeypatch, r, n, S,
                                               stop, sub_iter):
    """The cluster form (forced) against the one-CTA form of the kernel:
    the same sweeps a tile, and where they agree the same code bit for bit
    (the columns' arithmetic is the same; a tile within rounding of the
    threshold may stop a sweep apart, within the tolerance then); the same
    counts of sweeps and columns, every column counted as the cluster
    form's."""
    A, B, H0 = (_t(a, cuda) for a in make(300, r, n, seed=r + n))
    _es_form(monkeypatch, 1)
    one, one_counts = _es_counted(A, B, H0, stop, sub_iter)
    one_sweeps = _es_tile_sweeps(A, B, H0, stop, sub_iter)
    _es_form(monkeypatch, S)
    got, counts = _es_counted(A, B, H0, stop, sub_iter)
    sweeps = _es_tile_sweeps(A, B, H0, stop, sub_iter)
    assert one_counts[2] == 0 and counts[2] == n
    assert counts[:2] == one_counts[:2]
    assert sweeps == one_sweeps
    for t, (a, b) in enumerate(zip(sweeps, one_sweeps)):
        c = slice(t * ck.TN, min(n, (t + 1) * ck.TN))
        if a == b:
            assert torch.equal(got[:, c], one[:, c]), t
        else:
            torch.testing.assert_close(got[:, c], one[:, c], **TOL)
    torch.testing.assert_close(
        got, ck.coder_sweeps_earlystop_plain(A, B, H0, 0.1, stop,
                                             sub_iter=sub_iter), **TOL)


@pytest.mark.cuda
def test_cuda_earlystop_cluster_replays_from_a_graph(cuda):
    """The cluster form captured in a CUDA graph and replayed twice: each
    replay gives the eager code bit for bit and counts as a launch does."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib

    r, n = 100, 1000
    A, B, H0 = (_t(a, cuda) for a in make(300, r, n, seed=7))
    assert ck.coder_es_cluster(r, n, _lib._sm_count(cuda)) > 1
    eager, counts = _es_counted(A, B, H0, 0.01, 10)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ck.coder_sweeps_earlystop(A, B, H0, 0.1, 0.01)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ck.coder_sweeps_earlystop(A, B, H0, 0.1, 0.01)
    _lib.reset_launches()
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    runs = _lib.device_runs()
    assert (runs["coder_es.column_sweeps"], runs["coder_es.columns"],
            runs["coder_es.cluster_columns"]) == tuple(2 * c for c in counts)
    assert counts[2] == n


@pytest.mark.cuda
@pytest.mark.parametrize("r,S", [(25, 4), (32, 8), (64, 2), (100, 4),
                                 (100, 16), (101, 8)])
def test_cuda_earlystop_cluster_refuses_sizes_it_lacks(cuda, monkeypatch, r,
                                                       S):
    """The cluster form is built for 32 < r <= 100 on 4 or 8 CTAs a tile (8
    past r = 64): a cluster outside that (forced) is refused with an
    error, not run."""
    A, B, H0 = (_t(a, cuda) for a in make(300, r, 504, seed=r))
    _es_form(monkeypatch, S)
    with pytest.raises(RuntimeError, match="coder_sweeps_earlystop"):
        ck.coder_sweeps_earlystop(A, B, H0, 0.1, 0.01)


@pytest.mark.cuda
def test_cuda_span_holds_its_kernel_on_the_profilers_clock(cuda, tmp_path):
    """One clock for the spans and the profiler's device events: a span
    around a sleeping kernel and a synchronise holds that kernel's
    interval, ten times out of ten, starting less than 1 ms before it; its
    CUDA events time the kernel. A first span takes the session's first
    device activity (the profiler's buffers, 1-2 ms of host on the card)
    before the ten."""
    from onmf_ontf_ndl_tpu_torch.utils import profiling

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("first", on=cuda):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        for _ in range(10):
            with profiling.span("probe", on=cuda):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
    kernels = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if str(e.device_type()).endswith("CUDA")
        and e.duration_ns() > 200_000)
    probes = [s for s in profiling.spans() if s.name == "probe"]
    assert len(kernels) == len(probes) == 10
    for (ks, ke), p in zip(kernels, probes):
        assert p.start_ns <= ks and ke <= p.end_ns, (p, ks, ke)
        assert ks - p.start_ns < 1_000_000, (p, ks)
        assert p.device_ms * 1e6 >= 0.95 * (ke - ks), (p, ks, ke)


def _card_network(cuda):
    from onmf_ontf_ndl_tpu_torch.apps.network import NetworkReconstructor

    rng = np.random.default_rng(5)
    A = np.triu(rng.random((60, 60)) < 0.1, 1)
    A = (A | A.T).astype(np.float64)
    for i in range(60):
        A[i, (i + 1) % 60] = A[(i + 1) % 60, i] = 1.0
    return NetworkReconstructor(
        adjacency=A, n_components=5, MCMC_iterations=3, sub_iterations=6,
        sample_size=300, batch_size=300, k1=0, k2=4, num_chains=4,
        device=cuda)


@pytest.mark.cuda
def test_cuda_spans_add_no_device_operation(cuda, tmp_path, monkeypatch):
    """A traced training call and reconstruction job: the spans are
    recorded with their device times, no device operation of the trace
    (nor the breakdown the benchmark reduces it to) carries a span's name,
    the tracer adds no device operation but the counter snapshots' copies
    (the same run with every span off beside it), and the early stop's
    counts over the calls equal the kernels' own."""
    from collections import Counter
    from types import SimpleNamespace

    from benchport import tracing
    from torch.profiler import ProfilerActivity, profile

    from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib
    from onmf_ontf_ndl_tpu_torch.utils import profiling

    net = _card_network(cuda)

    def run():
        with torch.profiler.record_function(tracing.MARK):
            net.train_dict()
            net.reconstruct_network(recons_iter=2000, sparse=False)
            torch.cuda.synchronize()

    run()
    _lib.reset_launches()
    with profiling.trace(str(tmp_path)) as prof:
        run()
    counts, runs = profiling.counters(), _lib.device_runs()
    reduced = tracing.reduce(prof, 1, 2)
    spans = profiling.spans()
    names = {s.name for s in spans}
    assert names >= {"train.call", "train.weights", "train.fill",
                     "train.replay", "train.copy_out", "recon.job",
                     "recon.chains", "recon.patches", "recon.code",
                     "recon.group", "recon.paint"}
    assert not {n for n, _, _ in reduced.device} & names
    assert not {n for n, _ in reduced.breakdown["device_ops"]} & names
    timed = {s.name: s.device_ms for s in spans if s.device_ms is not None}
    assert set(timed) >= {"train.replay", "recon.job", "recon.group"}
    assert all(v > 0 for v in timed.values())
    assert counts["coder_es.columns"] == runs["coder_es.columns"] > 0
    assert counts["coder_es.column_sweeps"] \
        == runs["coder_es.column_sweeps"]
    assert 1 <= counts["coder_es.column_sweeps"] \
        / counts["coder_es.columns"] <= 10
    assert counts["graph.round.replays"] == 3
    monkeypatch.setattr(profiling, "_torch_profiler",
                        SimpleNamespace(_is_profiler_enabled=False))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as bare:
        run()
    on = Counter(n for n, _, _ in reduced.device)
    off = Counter(n for n, _, _ in tracing.reduce(bare, 1, 2).device)
    added = on - off
    assert not off - on, off - on
    assert all("Memcpy DtoH" in n for n in added), added
    assert sum(added.values()) == 2 * 2      # 2 calls, start and end

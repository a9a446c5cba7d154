"""The three sweep kernels of onmf_ontf_ndl_tpu_torch.ops.kernels.

On the CPU the wrappers run their plain PyTorch versions; those are held
in float32 against the JAX Pallas kernels run with ``interpret=True`` (as
tests/test_pallas_kernels.py runs them), at the Pallas kernels' own
tolerance rtol 2e-4 / atol 2e-5 (float32 summation order). The real
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from onmf_ontf_ndl_tpu.ops.coder import _code_impl as jax_code_impl
from onmf_ontf_ndl_tpu.ops.dict_update import (
    dict_update_bcd as jax_dict_update_bcd)
from onmf_ontf_ndl_tpu.ops.pallas.coder_kernel import (
    coder_sweeps as jax_coder_sweeps,
    coder_sweeps_earlystop as jax_coder_sweeps_earlystop,
    dict_update_sweep as jax_dict_update_sweep,
)
from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck
from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend

torch.set_num_threads(1)

RNG = np.random.default_rng(31)
TOL = dict(rtol=2e-4, atol=2e-5)


def make(d=48, r=25, n=200, seed=None):
    rng = RNG if seed is None else np.random.default_rng(seed)
    W = rng.random((d, r)).astype(np.float32)
    X = rng.random((d, n)).astype(np.float32)
    H0 = rng.random((r, n)).astype(np.float32)
    return W.T @ W, W.T @ X, H0, W, X


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


@pytest.mark.parametrize("alpha", [0.0, 1.0])
@pytest.mark.parametrize("n", [64, 200, 513])
def test_coder_sweeps_plain_matches_pallas(alpha, n):
    A, B, H0, _, _ = make(n=n)
    got = ck.coder_sweeps(_t(A), _t(B), _t(H0), alpha, sub_iter=10).numpy()
    want = np.asarray(jax_coder_sweeps(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), alpha, sub_iter=10,
        interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stop", [0.01, 0.05, 0.2])
@pytest.mark.parametrize("n", [64, ck.TN])
def test_earlystop_plain_matches_pallas_single_tile(stop, n):
    # n <= TN here and <= the Pallas tile: both decide on one tile, so the
    # iterates agree to float32 tolerance (same sweep count)
    A, B, H0, _, _ = make(n=n)
    got = ck.coder_sweeps_earlystop(_t(A), _t(B), _t(H0), 0.1, stop,
                                    sub_iter=10).numpy()
    want = np.asarray(jax_coder_sweeps_earlystop(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), 0.1, stop,
        sub_iter=10, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def _one_more_sweep_change(A, B, H):
    """Relative spectral change of one more full-matrix sweep."""
    one_more = np.asarray(jax_code_impl(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H), jnp.float32(0.0),
        jnp.float32(0.0), jnp.float32(0.0), 1, False, False))
    return np.linalg.norm(one_more - H, 2) / np.linalg.norm(H, 2)


def test_earlystop_plain_multi_tile_converged():
    # four TN-column tiles, each freezing on its own test: every tile's
    # final iterate must satisfy the convergence guarantee of the global
    # rule. Slack over stop=0.05 as in test_pallas_kernels.py: the probe
    # sweep uses the i=0 step 1/sqrt(10), larger than each tile's last.
    A, B, H0, _, _ = make(n=4 * ck.TN)
    g = ck.coder_sweeps_earlystop(_t(A), _t(B), _t(H0), 0.0, 0.05,
                                  sub_iter=50).numpy()
    assert (g >= 0).all()
    assert _one_more_sweep_change(A, B, g) <= 0.1


def test_dict_update_plain_matches_pallas_symmetric():
    d, r = 75, 25
    W = RNG.random((d, r)).astype(np.float32)
    H = RNG.random((r, 40)).astype(np.float32)
    X = (W @ H + 0.01 * RNG.random((d, 40))).astype(np.float32)
    A, B = H @ H.T, H @ X.T
    got = ck.dict_update_sweep(_t(W), _t(A), _t(B)).numpy()
    want = np.asarray(jax_dict_update_sweep(
        jnp.asarray(W), jnp.asarray(A), jnp.asarray(B), interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_dict_update_plain_matches_pallas_asymmetric():
    d, r = 40, 9
    W = RNG.random((d, r)).astype(np.float32)
    A = RNG.random((r, r)).astype(np.float32)
    B = RNG.random((r, d)).astype(np.float32)
    got = ck.dict_update_sweep(_t(W), _t(A), _t(B)).numpy()
    want = np.asarray(jax_dict_update_sweep(
        jnp.asarray(W), jnp.asarray(A), jnp.asarray(B), interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_wrappers_take_the_plain_path_without_launching():
    from onmf_ontf_ndl_tpu_torch.ops.kernels import ising_kernel

    ck.reset_launches()
    A, B, H0, W, X = make(n=30)
    ck.coder_sweeps(_t(A), _t(B), _t(H0))
    ck.coder_sweeps_earlystop(_t(A), _t(B), _t(H0))
    ck.fista_sweeps(_t(A), _t(B), _t(H0))
    ck.dict_update_sweep(_t(W), _t(A), _t(H0 @ X.T))
    ising_kernel.checkerboard_sweeps(0, torch.ones((4, 4), dtype=torch.int8),
                                     1)
    lat = torch.ones((4, 4), dtype=torch.int8)
    ising_kernel.checkerboard_band_half(0, lat[:2], lat[3], lat[2], 0, 0, 0)
    from onmf_ontf_ndl_tpu_torch.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu_torch.ops.kernels.motif_kernel import chain_moves

    g = csr_graph_from_edges([[0, 1], [1, 2]], device="cpu")
    chain_moves("walk", torch.zeros((2, 1), dtype=torch.int64),
                (torch.rand(1, 2), torch.rand(1, 2),
                 torch.zeros((1, 2), dtype=torch.int64)), g)
    from onmf_ontf_ndl_tpu_torch.ops.kernels.group_kernel import group_pairs

    group_pairs(torch.zeros((2, 2), dtype=torch.int64), torch.ones((4, 2)),
                3, canvas=(torch.empty((3, 3)), torch.empty((3, 3))))
    from onmf_ontf_ndl_tpu_torch.ops.patches import overlap_average_grid

    overlap_average_grid(torch.ones((12, 4)), 2, 1, (4, 4, 3))
    assert ck.LAUNCHES == {"coder_sweeps": 0, "coder_sweeps_earlystop": 0,
                           "fista_sweeps": 0, "dict_update_sweep": 0,
                           "checkerboard_sweeps": 0,
                           "checkerboard_sweeps_band": 0, "chain_move": 0,
                           "group_pairs": 0, "overlap_average": 0}


def test_argument_checks():
    A, B, H0, _, _ = make(r=ck.MAX_RANK + 1, n=8)
    with pytest.raises(ValueError, match=f"r <= {ck.MAX_RANK}"):
        ck._check_coder("coder_sweeps", _t(A), _t(B), _t(H0), ck.MAX_RANK)
    A, B, H0, _, _ = make(r=6, n=8)
    with pytest.raises(ValueError, match="do not agree"):
        ck._check_coder("coder_sweeps", _t(A), _t(B), _t(H0[:, :5]), 128)
    with pytest.raises(TypeError, match="float32"):
        ck._check_coder("coder_sweeps", _t(A).double(), _t(B), _t(H0), 128)
    with pytest.raises(ValueError, match="contiguous"):
        ck._check_coder("coder_sweeps", _t(A).T, _t(B), _t(H0), 128)
    with pytest.raises(ValueError, match="different devices"):
        ck._on_cpu(_t(A), _t(B).to("meta"))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        resolve_backend("cuda", _t(A))


def test_kernel_route_by_rank_alone():
    # the shared-memory kernels up to their limits, the workspace kernels
    # up to the JAX kernels' limit round_up(r, 8)^2 * 4 B <= 6 MiB, the
    # plain maths past it (as the JAX wrappers do)
    assert ck.MAX_RANK == max(r for r in range(1, 2000)
                              if (-(-r // 8) * 8) ** 2 * 4 <= 6 << 20)
    for name, limit in (("coder_sweeps", 128), ("coder_sweeps_earlystop", 100),
                        ("fista_sweeps", 128), ("fista_sweeps_stop", 100)):
        assert ck.kernel_route(name, 1) == "shared"
        assert ck.kernel_route(name, limit) == "shared"
        assert ck.kernel_route(name, limit + 1) == "workspace"
        assert ck.kernel_route(name, 256) == "workspace"
        assert ck.kernel_route(name, ck.MAX_RANK) == "workspace"
        assert ck.kernel_route(name, ck.MAX_RANK + 1) == "unfused"


def test_coder_es_cluster_by_shape_alone():
    # one CTA a tile where the tiles could fill half the card (the large
    # batches), up to r = 32 and past the shared kernel's ranks; else the
    # largest power of two from the form's least whose clusters take at
    # most 7/8 of the SMs, up to the portable cluster size of 8
    for r in (25, 100):
        for n in (131109, 16384):
            assert ck.coder_es_cluster(r, n) == 1
    assert ck.coder_es_cluster(100, 1000) == 8     # ising-train, 8 tiles
    assert ck.coder_es_cluster(25, 504) == 1       # ndl-train, 4 tiles
    assert ck.ES_MAX_CLUSTER == 8
    assert ck.coder_es_cluster(40, 300) == 8       # 3 tiles
    assert ck.coder_es_cluster(100, 129) == 8      # 2 tiles
    assert ck.coder_es_cluster(100, 1000, sms=66) == 1
    assert ck.coder_es_cluster(64, 1000, sms=66) == 4
    for sms in (66, 132):
        for r in (1, 7, 25, 32, 33, 40, 64, 65, 100, 101, 160):
            for n in (1, 128, 129, 300, 504, 1000, 1920, 3584, 5000,
                      16384, 131109):
                S, tiles = ck.coder_es_cluster(r, n, sms), -(-n // ck.TN)
                if S == 1:
                    continue
                assert 33 <= r <= 100 and 2 * tiles <= sms
                assert S & (S - 1) == 0
                assert 0 < ck._es_cluster_min(r) <= S <= ck.ES_MAX_CLUSTER
                assert tiles * S <= sms and 8 * tiles * S <= 7 * sms
                # the largest such: twice as many would not fit
                assert (2 * S > ck.ES_MAX_CLUSTER
                        or 8 * tiles * 2 * S > 7 * sms)
    # the least: 4, and 8 past r = 64, where 32 lanes a pair of columns
    # would give a CTA of 4 more than 256 threads; none up to r = 32 and
    # past r = 100, where the form is not built
    assert [ck._es_cluster_min(r) for r in (1, 32, 33, 64, 65, 100, 101)] \
        == [0, 0, 4, 4, 8, 8, 0]


@pytest.mark.parametrize("coder", ["earlystop", "fista_stop"])
def test_stopping_plain_two_tiles_at_rank_160_matches_pallas(coder):
    # r = 160 is past the shared-memory kernels; the Pallas tile is set to
    # the port's TN, so both decide per tile on the same two column sets
    from onmf_ontf_ndl_tpu.ops.pallas.coder_kernel import (
        fista_sweeps as jax_fista_sweeps)

    A, B, H0, _, _ = make(d=200, r=160, n=2 * ck.TN, seed=160)
    if coder == "earlystop":
        got = ck.coder_sweeps_earlystop(_t(A), _t(B), _t(H0), 0.1, 0.01,
                                        sub_iter=6).numpy()
        want = jax_coder_sweeps_earlystop(
            jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), 0.1, 0.01,
            sub_iter=6, block_n=ck.TN, interpret=True)
    else:
        got = ck.fista_sweeps(_t(A), _t(B), _t(H0), 0.1, 0.01, sub_iter=20,
                              use_stopping=True).numpy()
        want = jax_fista_sweeps(
            jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), 0.1, 0.01,
            sub_iter=20, use_stopping=True, block_n=ck.TN, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# ------------------------------------------------ the kernels' algorithms
# float64 NumPy emulations of the two kernel designs, held against the JAX
# functions at 1e-12 (the designs sum in another order; in float64 that is
# rounding only).
def _emulate_dict_residual(W, A, B, ctas, k=None):
    """dict_update_kernel's panel form: G = W A once; the columns in panels
    of ``k`` (the kernel's panel width); at a panel's start its columns of
    G less B's rows; per column j the new column from that G and the input
    column, its norm as the sum of the warps' partial sums (32 rows a
    warp, the rows split over ``ctas`` CTAs, the CTAs' warps in rank
    order), the column's rank-1 part added to the panel's later columns
    alone; after the panel one rank-k update of G past it."""
    k = k or ck._DICT_PANEL
    d, r = W.shape
    rows = -(-d // max(ctas, 1))
    out = W.copy()
    G = W @ A
    for j0 in range(0, r, k):
        j1 = min(r, j0 + k)
        Gp = G[:, j0:j1] - B[j0:j1].T
        delta = np.zeros((d, j1 - j0))
        for q, j in enumerate(range(j0, j1)):
            col = np.maximum(W[:, j] - Gp[:, q] / (A[j, j] + 1.0), 0.0)
            tot = sum(float(np.sum(col[w:min(w + 32, c + rows, d)] ** 2))
                      for c in range(0, d, rows)
                      for w in range(c, min(c + rows, d), 32))
            new = col / max(1.0, np.sqrt(tot))
            delta[:, q] = new - W[:, j]
            out[:, j] = new
            Gp[:, q + 1:] += np.outer(delta[:, q], A[j, j + 1:j1])
        G[:, j1:] += delta @ A[j0:j1, j1:]
    return out


@pytest.mark.parametrize("d,r,sym", [(40, 9, False), (75, 25, True),
                                     (400, 100, False), (1200, 30, False),
                                     # the panel's edges: r = 1, k - 1, k,
                                     # k + 1, r not a multiple of k
                                     (33, 1, False), (50, 7, True),
                                     (50, 8, False), (64, 9, True),
                                     (300, 25, True), (441, 25, False),
                                     (100, 13, False), (400, 100, True)])
def test_residual_dict_emulation_matches_jax_dict_update_bcd(d, r, sym):
    rng = np.random.default_rng(d + r)
    W = rng.random((d, r))
    if sym:
        H = rng.random((r, 60))
        A, B = H @ H.T, H @ (W @ H + 0.01 * rng.random((d, 60))).T
    else:   # an asymmetric A must match too
        A, B = rng.random((r, r)), rng.random((r, d))
    got = _emulate_dict_residual(W, A, B, ck.dict_route(d, r)[1])
    want = np.asarray(jax_dict_update_bcd(jnp.asarray(W), jnp.asarray(A),
                                          jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    plain = ck.dict_update_sweep_plain(_t(W), _t(A), _t(B)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-12, atol=1e-12)


def _power(G, v, iters):
    """warm_pair for one Gram: ``iters`` normalised steps, then the
    Rayleigh quotient."""
    for _ in range(iters):
        w = G @ v
        v = w / max(np.linalg.norm(w), 1e-30)
    return float(v @ (G @ v)) / max(float(v @ v), 1e-30), v


def _cluster_power(parts, v, iters):
    """_power on G = sum_j X_j X_j^T, its products formed from the CTAs'
    columns in rank order: w = sum_j X_j (X_j^T v)."""
    def product(v):
        w = parts[0] @ (parts[0].T @ v)
        for X in parts[1:]:
            w = w + X @ (X.T @ v)
        return w

    for _ in range(iters):
        w = product(v)
        v = w / max(np.linalg.norm(w), 1e-30)
    w = product(v)
    return float(v @ w) / max(float(v @ v), 1e-30), v


def _cluster_decision(D, o, vd, vh, v0, stop, pi_iters, S):
    """coder_es_lanes_kernel's decision on a cluster of S CTAs, each with
    TN / S of the tile's columns: the products from the columns, summed in
    rank order; the diagonals summed in rank order give the traces and
    the largest diagonal entry, which decide where they can; else the
    Grams summed in rank order give the Gershgorin bounds."""
    ct = ck.TN // S
    Dp = [D[:, j * ct:(j + 1) * ct] for j in range(S)]
    Op = [o[:, j * ct:(j + 1) * ct] for j in range(S)]

    def ranked(fn, parts):
        out = fn(parts[0])
        for X in parts[1:]:
            out = out + fn(X)
        return out

    s2 = stop * stop
    diag_d = ranked(lambda X: np.sum(X * X, axis=1), Dp)
    diag_h = ranked(lambda X: np.sum(X * X, axis=1), Op)
    tr_d, tr_h = float(diag_d.sum()), float(diag_h.sum())
    lb_d, vd = _cluster_power(Dp, vd + 0.05 * v0, 1)
    lb_h, vh = _cluster_power(Op, vh + 0.05 * v0, 1)
    if tr_d <= s2 * lb_h:
        return True, vd, vh
    if diag_d.max() > s2 * lb_h and lb_d > s2 * tr_h:
        return False, vd, vh
    Gd, Gh = ranked(lambda X: X @ X.T, Dp), ranked(lambda X: X @ X.T, Op)
    ub_d = min(tr_d, np.abs(Gd).sum(1).max())
    ub_h = min(tr_h, np.abs(Gh).sum(1).max())
    conv = ub_d <= s2 * lb_h
    if not conv and not lb_d > s2 * ub_h:
        num, vd = _cluster_power(Dp, vd, pi_iters)
        den, vh = _cluster_power(Op, vh, pi_iters)
        conv = num <= s2 * den
    return conv, vd, vh


def _emulate_earlystop_lanes(A, B, H0, alpha, stop, sub_iter=10,
                             pi_iters=12, S=1, with_sweeps=False):
    """coder_es_lanes_kernel: per tile of TN columns, lanes of rows hold
    the residual g = A h - b, formed once per tile up to r = 32 and anew
    every sweep past it; at coordinate k the owner's delta updates every
    lane's rows (each row's multiply-add is the same whichever lane holds
    it, so all rows at once here); then the stop decision on the Grams of
    the delta and the old iterate: with S = 1 one CTA's (certified bounds,
    warm power steps only in the band), else a cluster's of S CTAs
    (:func:`_cluster_decision`). ``with_sweeps`` also returns each tile's
    sweeps."""
    r, n = B.shape
    v0 = 0.5 + ((np.arange(r) * 40503) % 65536) / 65536.0
    out = H0.copy()
    sweeps = []
    for t0 in range(0, n, ck.TN):
        cols = slice(t0, min(n, t0 + ck.TN))
        h, b = H0[:, cols].copy(), B[:, cols]
        vd, vh = v0.copy(), v0.copy()
        g = None
        swept = sub_iter
        for i in range(sub_iter):
            if r > 32 or i == 0:
                g = A @ h - b
            o = h.copy()
            step = 1.0 / np.sqrt(i + 10.0) / (np.diag(A) + 1.0)
            for k in range(r):
                hn = np.maximum(h[k] - step[k] * (g[k] + alpha), 0.0)
                delta = hn - h[k]
                h[k] = hn
                g += np.outer(A[:, k], delta)
            D = h - o
            if S > 1:
                conv, vd, vh = _cluster_decision(D, o, vd, vh, v0, stop,
                                                 pi_iters, S)
            else:
                Gd, Gh = D @ D.T, o @ o.T
                vd, vh = vd + 0.05 * v0, vh + 0.05 * v0
                lb_d, vd = _power(Gd, vd, 1)
                lb_h, vh = _power(Gh, vh, 1)
                ub_d = min(np.trace(Gd), np.abs(Gd).sum(1).max())
                ub_h = min(np.trace(Gh), np.abs(Gh).sum(1).max())
                conv = ub_d <= stop * stop * lb_h
                if not conv and not lb_d > stop * stop * ub_h:
                    num, vd = _power(Gd, vd, pi_iters)
                    den, vh = _power(Gh, vh, pi_iters)
                    conv = num <= stop * stop * den
            if conv:
                swept = i + 1
                break
        out[:, cols] = h
        sweeps.append(swept)
    return (out, sweeps) if with_sweeps else out


@pytest.mark.parametrize("r,stop", [(7, 0.01), (25, 0.01), (25, 0.05),
                                    (40, 0.01)])
def test_lane_earlystop_emulation_matches_jax_code_impl(r, stop):
    # each tile against the JAX coder on the tile's columns alone (its
    # whole-batch rule with exact spectral norms): the same sweeps per tile
    A, B, H0, _, _ = make(d=300, r=r, n=2 * ck.TN + 37, seed=r)
    A, B, H0 = (x.astype(np.float64) for x in (A, B, H0))
    got = _emulate_earlystop_lanes(A, B, H0, 0.1, stop)
    for t0 in range(0, B.shape[1], ck.TN):
        cols = slice(t0, t0 + ck.TN)
        want = np.asarray(jax_code_impl(
            jnp.asarray(A), jnp.asarray(B[:, cols]), jnp.asarray(H0[:, cols]),
            jnp.float64(0.1), jnp.float64(stop), jnp.float64(0.0), 10, True,
            False))
        np.testing.assert_allclose(got[:, cols], want, rtol=1e-12,
                                   atol=1e-12)
    plain = ck.coder_sweeps_earlystop_plain(_t(A), _t(B), _t(H0), 0.1,
                                            stop).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("stop,sub_iter", [(0.01, 10), (0.05, 50)])
@pytest.mark.parametrize("r,n,S", [(7, 300, 4), (25, 504, 8),
                                   (40, 2 * ck.TN + 37, 8), (100, 1000, 16)])
def test_cluster_earlystop_emulation_matches_one_cta(r, n, S, stop,
                                                     sub_iter):
    # the cluster form's decision (products from the CTAs' columns, the
    # diagonals' bounds first, the Grams summed in rank order) stops each
    # tile at the one-CTA kernel's sweep, and its columns' arithmetic is
    # the same, so the code is equal; and both are the plain version's.
    # This holds for any split of a tile's columns, so the cases also split
    # where the kernel keeps one CTA (r <= 32) and finer than its 8 CTAs
    A, B, H0, _, _ = make(d=300, r=r, n=n, seed=r + n)
    A, B, H0 = (x.astype(np.float64) for x in (A, B, H0))
    one, one_sweeps = _emulate_earlystop_lanes(A, B, H0, 0.1, stop,
                                               sub_iter=sub_iter,
                                               with_sweeps=True)
    got, sweeps = _emulate_earlystop_lanes(A, B, H0, 0.1, stop,
                                           sub_iter=sub_iter, S=S,
                                           with_sweeps=True)
    assert sweeps == one_sweeps
    assert np.array_equal(got, one)
    plain, plain_sweeps = ck.coder_sweeps_earlystop_plain(
        _t(A), _t(B), _t(H0), 0.1, stop, sub_iter=sub_iter,
        with_sweeps=True)
    assert sweeps == plain_sweeps.tolist()
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-12, atol=1e-12)
    if (r, stop) == (40, 0.05):   # tiles that stop at different sweeps
        assert sweeps == [10, 11, 12]


def test_dict_route_by_shape_alone():
    # the routes measured fastest on the H100: one CTA up to 256 rows, a
    # cluster of 4 at r = 25 past them (the cells' (300, 25), (441, 25)), of
    # 8 at r = 100 ((400, 100), (1200, 100)) and past 512 rows; past the
    # cluster's shared memory the single-block kernel
    assert ck.dict_route(75, 9) == ("shared", 1)
    assert ck.dict_route(200, 25) == ("shared", 1)
    assert ck.dict_route(256, 64) == ("shared", 1)
    assert ck.dict_route(300, 25) == ("cluster", 4)
    assert ck.dict_route(441, 25) == ("cluster", 4)
    assert ck.dict_route(1000, 9) == ("cluster", 8)
    assert ck.dict_route(300, 64) == ("cluster", 8)
    assert ck.dict_route(400, 100) == ("cluster", 8)
    assert ck.dict_route(1200, 100) == ("cluster", 8)
    assert ck.dict_route(300, 300) == ("single", 0)
    assert ck.dict_route(8000, 100) == ("single", 0)
    for d in (1, 7, 33, 300, 441, 1000, 2000, 5000):
        for r in (1, 9, 25, 64, 100, 128, 300):
            route, ctas = ck.dict_route(d, r)
            if route == "single":
                assert ctas == 0
                continue
            rows = -(-d // ctas)
            assert (route == "shared") == (ctas == 1)
            assert ctas in (1, 4, 8)
            assert ck._dict_threads(rows, r) <= 448
            assert 4 * ck._dict_smem_floats(rows, r) <= 232448
            # a column's partial sums, a warp's each, fit their buffer
            assert ctas * -(-rows // 32) <= ck._DICT_MAX_PARTS


# float32 PyTorch emulation of the fixed-sweep lanes kernel's order of
# operations, against the JAX coder in float32 at the kernels' tolerance.
def _emulate_coder_lanes(A, B, H0, alpha, sub_iter, reform=None):
    """coder_lanes_kernel: L lanes of Q rows per column hold h and the
    residual g = A h - b in registers; g is formed row by row from h every
    ``reform`` sweeps (the kernel's own period by default) and carried in
    between: at coordinate k the owner's candidate and delta, then
    g += A[:, k] delta on every lane's rows."""
    r = B.shape[0]
    L, Q, period = ck.coder_lanes_config(r)
    period = reform or period
    h, g = H0.clone(), None
    diag1 = torch.diagonal(A) + 1.0
    for i in range(sub_iter):
        if i % period == 0:
            g = -B.clone()
            for m in range(r):
                g += A[:, m, None] * h[m]
        st = (1.0 / torch.sqrt(torch.tensor(i + 10.0))) / diag1
        for k in range(r):
            hn = torch.clamp_min(h[k] - st[k] * (g[k] + alpha), 0.0)
            delta = hn - h[k]
            h[k] = hn
            for lane in range(L):
                rows = slice(lane * Q, min(r, (lane + 1) * Q))
                g[rows] += A[rows, k, None] * delta
    return h


_LANES_N = 129


def _lanes_problem(r, sub_iter, cache={}):
    """Inputs at n = 129 and the JAX coder's float32 result on them."""
    if (r, sub_iter) not in cache:
        A, B, H0, _, _ = make(d=300, r=r, n=_LANES_N, seed=1000 + r)
        want = np.asarray(jax_code_impl(
            jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0),
            jnp.float32(0.1), jnp.float32(0.0), jnp.float32(0.0), sub_iter,
            False, False))
        assert want.dtype == np.float32
        cache[r, sub_iter] = (A, B, H0, want)
    return cache[r, sub_iter]


@pytest.mark.parametrize("n", [1, 100, 129])
@pytest.mark.parametrize("sub_iter", [10, 50])
@pytest.mark.parametrize("r", [8, 25, 32, 33, 100, 128])
def test_lane_coder_emulation_matches_jax_code_impl(r, sub_iter, n):
    # columns are independent: the first n columns of the problem
    A, B, H0, want = _lanes_problem(r, sub_iter)
    got = _emulate_coder_lanes(_t(A), _t(B[:, :n].copy()),
                               _t(H0[:, :n].copy()), 0.1, sub_iter)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[:, :n], **TOL)
    plain = ck.coder_sweeps_plain(_t(A), _t(B[:, :n].copy()),
                                  _t(H0[:, :n].copy()), 0.1,
                                  sub_iter=sub_iter)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("sub_iter", [10, 50])
@pytest.mark.parametrize("r", [8, 25, 32])
def test_lane_coder_carried_residual_holds_up_to_rank_32(r, sub_iter):
    # g carried through every sweep (never formed anew) stays within the
    # tolerance up to r = 32, where the kernel carries it for 16 sweeps
    A, B, H0, want = _lanes_problem(r, sub_iter)
    got = _emulate_coder_lanes(_t(A), _t(B), _t(H0), 0.1, sub_iter,
                               reform=10 ** 6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_coder_lanes_config_by_rank_alone():
    # the instantiations the C entry point dispatches on: <L, Q> with
    # L Q >= r, g formed anew every sweep once L Q > 32
    want = {1: (2, 8, 16), 16: (2, 8, 16), 17: (2, 16, 16), 25: (2, 16, 16),
            32: (2, 16, 16), 33: (4, 16, 1), 64: (4, 16, 1), 65: (4, 25, 1),
            100: (4, 25, 1), 101: (4, 32, 1), 128: (4, 32, 1)}
    for r, config in want.items():
        assert ck.coder_lanes_config(r) == config
        assert ck.kernel_route("coder_sweeps", r) == "shared"
    for r in range(1, 129):
        L, Q, _ = ck.coder_lanes_config(r)
        assert L * Q >= r and (Q % 4 == 0 or Q == 25)
    for r in (0, 129):
        with pytest.raises(ValueError):
            ck.coder_lanes_config(r)

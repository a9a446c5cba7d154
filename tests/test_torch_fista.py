"""The port's FISTA coder (ops/coder.py::_fista_impl, the FISTA branches of
nonneg_code_gram and of the ONMF step) and the plain version of its kernel
(ops/kernels/coder_kernel.py::fista_sweeps_plain) against the JAX package.

- ``_fista_impl`` and the training path: float64 on the CPU against the
  JAX functions. The step ``1 / L`` comes from 16 power steps in float32 on
  both sides, as the JAX helper computes it; the two frameworks sum in
  another order, so the step can differ by one float32 ulp (6e-8
  relative). That moves the float64 iterates by up to ~3e-8 after 30
  iterations: rtol 1e-6 / atol 1e-7. In bf16 mode any such difference can
  carry an iterate across a bf16 rounding boundary, after which the paths
  part at bf16 precision, so bf16 is held at the tolerance
  tests/test_fista.py holds the Pallas kernel to (rtol 0.05 / atol 0.02,
  and the objective within 0.5%).
- ``fista_sweeps_plain``: float32 against the Pallas ``fista_sweeps`` in
  interpret mode, at the Pallas tests' own tolerances (tests/test_fista.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from onmf_ontf_ndl_tpu.models import onmf as jonmf
from onmf_ontf_ndl_tpu.models.state import init_state as jinit_state
from onmf_ontf_ndl_tpu.ops import coder as jcoder
from onmf_ontf_ndl_tpu.ops.pallas.coder_kernel import (
    _lambda_max as jax_lambda_max, fista_sweeps as jax_fista_sweeps)
from onmf_ontf_ndl_tpu_torch.models import onmf as tonmf
from onmf_ontf_ndl_tpu_torch.models.state import init_state
from onmf_ontf_ndl_tpu_torch.ops import coder as tcoder
from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck
from test_torch_onmf import assert_state_close, replay_draws

torch.set_num_threads(1)

RNG = np.random.default_rng(34)
F64 = torch.float64
TOL = dict(rtol=2e-4, atol=2e-5)
F64_TOL = dict(rtol=1e-6, atol=1e-7)


def _t(a):
    return torch.from_numpy(np.array(a))


def problem(d=80, r=20, n=300, seed=0, dtype=np.float64):
    """The Gram-form problem of tests/test_fista.py, with its objective and
    the quadratic part that the single-tile stop test compares."""
    rng = np.random.default_rng(seed)
    W = rng.random((d, r)).astype(dtype)
    X = rng.random((d, n)).astype(dtype)
    H0 = rng.random((r, n)).astype(dtype)
    A, B = W.T @ W, W.T @ X

    def obj(H, alpha=0.0):
        H = np.asarray(H, np.float64)
        return (0.5 * np.linalg.norm(X - W @ H) ** 2
                + alpha * np.abs(H).sum())

    def qobj(H):
        H = np.asarray(H, np.float64)
        return 0.5 * np.sum(H * (A @ H)) - np.sum(B * H)

    return A, B, H0, obj, qobj


def test_lambda_max_matches_jax():
    A, _, _, _, _ = problem(r=12)
    for iters in (1, 16):
        got = float(ck._lambda_max(_t(A), iters))
        want = float(jax_lambda_max(jnp.asarray(A), iters))
        assert got == pytest.approx(want, rel=1e-6)
    assert ck._inv_lipschitz(_t(A)).dtype == torch.float32


BF16_TOL = dict(rtol=0.05, atol=0.02)


def tol(bf16):
    return BF16_TOL if bf16 else F64_TOL


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("stop", [None, 0.01])
def test_fista_impl_matches_jax(stop, alpha, bf16):
    A, B, H0, obj, _ = problem(n=60)
    use_stop = stop is not None
    got = tcoder._fista_impl(_t(A), _t(B), _t(H0), alpha, stop, 30,
                             use_stop, bf16_matmul=bf16).numpy()
    want = np.asarray(jcoder._fista_impl(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), jnp.float64(alpha),
        jnp.float64(stop or 0.0), 30, use_stop, bf16_matmul=bf16))
    np.testing.assert_allclose(got, want, **tol(bf16))
    assert obj(got, alpha) == pytest.approx(obj(want, alpha), rel=5e-3)


@pytest.mark.parametrize("method", ["fista", "fista_bf16"])
@pytest.mark.parametrize("stop", [None, 0.05])
def test_nonneg_code_gram_fista_matches_jax(method, stop):
    A, B, H0, _, _ = problem(d=30, r=9, n=40, seed=1)
    kw = dict(alpha=0.2, sub_iter=20, stopping_diff=stop, method=method)
    got = tcoder.nonneg_code_gram(_t(A), _t(B), _t(H0), **kw).numpy()
    want = np.asarray(jcoder.nonneg_code_gram(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), **kw))
    np.testing.assert_allclose(got, want, **tol(method == "fista_bf16"))


@pytest.mark.parametrize("n", [64, 200, 513])
def test_fista_sweeps_plain_fixed_matches_pallas(n):
    A, B, H0, _, _ = problem(n=n, seed=n, dtype=np.float32)
    got = ck.fista_sweeps(_t(A), _t(B), _t(H0), 0.5, 0.0, sub_iter=10,
                          use_stopping=False).numpy()
    want = np.asarray(jax_fista_sweeps(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), 0.5, 0.0,
        sub_iter=10, use_stopping=False, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stop", [0.01, 0.05])
def test_fista_sweeps_plain_single_tile_stop_matches_pallas(stop):
    # n <= TN and <= the Pallas tile: one tile on both sides. The power
    # statistic can stop one iteration apart at the boundary, so compare
    # by the quadratic objective, as tests/test_fista.py does
    A, B, H0, _, qobj = problem(n=ck.TN, seed=3, dtype=np.float32)
    got = ck.fista_sweeps(_t(A), _t(B), _t(H0), 0.0, stop,
                          sub_iter=20).numpy()
    want = np.asarray(jax_fista_sweeps(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), 0.0, stop,
        sub_iter=20, use_stopping=True, interpret=True))
    assert abs(qobj(got) - qobj(want)) <= 0.02 * abs(qobj(want))
    assert (got >= 0).all()


def test_fista_sweeps_plain_bf16_matches_pallas():
    A, B, H0, obj, _ = problem(n=200, seed=5, dtype=np.float32)
    got = ck.fista_sweeps(_t(A), _t(B), _t(H0), 0.5, 0.0, sub_iter=10,
                          use_stopping=False, bf16_matmul=True).numpy()
    want = np.asarray(jax_fista_sweeps(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), 0.5, 0.0,
        sub_iter=10, use_stopping=False, interpret=True, bf16_matmul=True))
    # bf16 rounding points differ between the two: loose elementwise plus
    # the objective within 0.5%, as tests/test_fista.py holds the Pallas
    # kernel to the XLA path
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)
    assert abs(obj(got, 0.5) - obj(want, 0.5)) \
        <= 0.005 * abs(obj(want, 0.5)) + 1e-6


def test_fista_sweeps_plain_multi_tile_stop_converges():
    # four TN-column tiles, each stopping on its own test with its own
    # momentum: the result must be as good a solution as the global rule
    # gives (within 10% of 200 fixed iterations' objective, the bound of
    # tests/test_fista.py::test_fista_early_stop_converges)
    A, B, H0, obj, _ = problem(n=4 * ck.TN, seed=7, dtype=np.float32)
    got = ck.fista_sweeps(_t(A), _t(B), _t(H0), 0.0, 0.01,
                          sub_iter=200).numpy()
    full = ck.fista_sweeps(_t(A), _t(B), _t(H0), 0.0, 0.0, sub_iter=200,
                           use_stopping=False).numpy()
    assert (got >= 0).all()
    assert obj(got) <= obj(full) * 1.10
    # stopping is per tile: a tile stops no later than a run capped at the
    # global stopping point would, so the objective is above the full run
    assert obj(got) >= obj(full) * (1 - 1e-6)


def test_fista_sweeps_plain_fixed_equals_fista_impl():
    # the fixed mode is _fista_impl's loop, whatever the tiling
    A, B, H0, _, _ = problem(n=300, seed=2)
    got = ck.fista_sweeps_plain(_t(A), _t(B), _t(H0), 0.3, 0.0,
                                sub_iter=15, use_stopping=False)
    want = tcoder._fista_impl(_t(A), _t(B), _t(H0), 0.3, None, 15, False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def make_states(d=36, r=8, seed=0):
    W = RNG.random((d, r))
    js = jinit_state(jax.random.key(seed), d, r, dtype=jnp.float64, W=W)
    ts = init_state(seed, d, r, dtype=F64, W=W, device="cpu")
    return js, ts


@pytest.mark.parametrize("coder", ["fista", "fista_bf16"])
@pytest.mark.parametrize("stop", [None, 0.01])
def test_onmf_step_fista_matches_jax(coder, stop):
    js, ts = make_states()
    X, H0 = RNG.random((36, 20)), RNG.random((8, 20))
    kw = dict(t=3.0, alpha=0.5, beta=0.7, stopping_diff=stop, coder=coder)
    js1, jH = jonmf.onmf_step(js, jnp.asarray(X), H0=jnp.asarray(H0), **kw)
    ts1, tH = tonmf.onmf_step(ts, _t(X), H0=_t(H0), **kw)
    bf16 = coder == "fista_bf16"
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), **tol(bf16))
    assert_state_close(ts1, js1, **tol(bf16))


@pytest.mark.parametrize("stop", [None, 0.01])
def test_train_dict_fista_matches_jax(stop):
    d, r, n, iterations, batch = 36, 8, 50, 6, 12
    js, ts = make_states(d=d, r=r, seed=7)
    X = RNG.random((d, n))
    draws = replay_draws(js.key, n, r, iterations, batch, True)
    kw = dict(iterations=iterations, batch_size=batch, alpha=0.3, beta=0.9,
              sub_iter=20, stopping_diff=stop, coder="fista",
              return_metrics=True)
    js1, jcode, jmet = jonmf.train_dict(js, jnp.asarray(X), **kw)
    ts1, tcode, tmet = tonmf.train_dict(ts, _t(X), draws=draws, **kw)
    assert_state_close(ts1, js1, **F64_TOL)
    np.testing.assert_allclose(tcode.numpy(), np.asarray(jcode), **F64_TOL)
    np.testing.assert_allclose(tmet.numpy(), np.asarray(jmet), rtol=1e-6)


def test_online_nmf_fista_learns():
    # the JAX shell test (tests/test_fista.py::test_onlinenmf_shell_fista)
    # on the port
    X = np.random.default_rng(9).random((40, 200))
    nmf = tonmf.OnlineNMF(X, n_components=8, iterations=20, batch_size=50,
                          coder="fista", stopping_diff=None, dtype=F64,
                          device="cpu")
    W, _, _, _, _ = nmf.train_dict()
    assert (W >= 0).all()
    H = nmf.sparse_code(nmf.X, W)
    err = torch.linalg.norm(nmf.X - W @ H) / torch.linalg.norm(nmf.X)
    assert float(err) < 0.5


# float32 PyTorch emulation of the tiled FISTA kernel's order of
# operations, against the Pallas kernel in interpret mode with its tile set
# to the port's TN.
def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _power32(G, v, iters):
    """One Gram's warm power steps, then the Rayleigh quotient."""
    for _ in range(iters):
        w = G @ v
        v = w / torch.clamp_min(torch.sqrt(torch.sum(w * w)), 1e-30)
    return (torch.sum(v * (G @ v))
            / torch.clamp_min(torch.sum(v * v), 1e-30)), v


def _lane_gram(M, lanes):
    """M M^T over the tile's columns as the kernel sums it: each of
    ``lanes`` lanes over columns s, s + lanes, ... in order, then the
    lanes' sums by a butterfly."""
    parts = []
    for s in range(lanes):
        g = torch.zeros((M.shape[0], M.shape[0]), dtype=M.dtype)
        for c in range(s, M.shape[1], lanes):
            g += M[:, c, None] * M[None, :, c]
        parts.append(g)
    m = lanes // 2
    while m:
        parts = [parts[s] + parts[s ^ m] for s in range(lanes)]
        m //= 2
    return parts[0]


def _emulate_fista_tiled(A, B, H0, alpha, stop, sub_iter, use_stopping,
                         bf16=False, pi_iters=12):
    """fista_tiled_kernel: per tile of TN columns (zero beyond the batch),
    the product A Y summed over j in order into one accumulator per output
    (A and Y rounded to bf16 first in bf16 mode), the projected step, and
    with the stop the Grams of the step delta and of the old iterate summed
    in lane order, the decision (certified bounds, warm power steps in the
    band), the step applied in the converging iteration too, and the
    tile's own momentum."""
    r, n = B.shape
    lanes = ck.fista_tile_config(r, use_stopping)[2]
    inv_L = ck._inv_lipschitz(A, max(16, pi_iters))
    v0 = ck._fixed_start(r, torch.float32, "cpu")
    Ar = _bf16(A) if bf16 else A
    out = torch.empty_like(B)
    for t0 in range(0, n, ck.TN):
        w = min(ck.TN, n - t0)
        H = torch.zeros((r, ck.TN))
        b = torch.zeros((r, ck.TN))
        H[:, :w], b[:, :w] = H0[:, t0:t0 + w], B[:, t0:t0 + w]
        Y, tm = H.clone(), torch.tensor(1.0)
        vd, vh = v0.clone(), v0.clone()
        for _ in range(sub_iter):
            tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tm * tm))
            mom, tm = (tm - 1.0) / tn, tn
            Yr = _bf16(Y) if bf16 else Y
            acc = torch.zeros_like(Y)
            for j in range(r):
                acc += Ar[:, j, None] * Yr[j]
            Hn = torch.clamp_min(Y - inv_L * (acc - b + alpha), 0.0)
            Hn[:, w:] = 0.0
            D = Hn - H
            conv = False
            if use_stopping:
                Gd, Gh = _lane_gram(D, lanes), _lane_gram(H, lanes)
                lb_d, vd = _power32(Gd, vd + 0.05 * v0, 1)
                lb_h, vh = _power32(Gh, vh + 0.05 * v0, 1)
                ub_d = min(torch.trace(Gd), Gd.abs().sum(1).max())
                ub_h = min(torch.trace(Gh), Gh.abs().sum(1).max())
                conv = bool(ub_d <= stop * stop * lb_h)
                if not conv and not bool(lb_d > stop * stop * ub_h):
                    num, vd = _power32(Gd, vd, pi_iters)
                    den, vh = _power32(Gh, vh, pi_iters)
                    conv = bool(num <= stop * stop * den)
            H, Y = Hn, Hn + mom * D
            if conv:
                break
        out[:, t0:t0 + w] = H[:, :w]
    return out


def _pallas_fista(A, B, H0, alpha, stop, **kw):
    return np.asarray(jax_fista_sweeps(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), alpha, stop,
        block_n=ck.TN, interpret=True, **kw))


@pytest.mark.parametrize("r,n", [(8, 1), (25, 100), (25, 2 * ck.TN + 37),
                                 (33, 129), (100, 100), (128, 64)])
def test_tiled_fista_emulation_fixed_matches_pallas(r, n):
    A, B, H0, _, _ = problem(d=300, r=r, n=n, seed=r + n, dtype=np.float32)
    got = _emulate_fista_tiled(_t(A), _t(B), _t(H0), 0.1, 0.0, 10, False)
    assert got.dtype == torch.float32
    want = _pallas_fista(A, B, H0, 0.1, 0.0, sub_iter=10,
                         use_stopping=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = ck.fista_sweeps_plain(_t(A), _t(B), _t(H0), 0.1, 0.0,
                                  sub_iter=10, use_stopping=False)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("r,n,stop", [(8, 100, 0.01), (25, 100, 0.01),
                                      (25, 2 * ck.TN + 37, 0.05),
                                      (40, 129, 0.01), (100, 100, 0.01)])
def test_tiled_fista_emulation_stop_matches_pallas(r, n, stop):
    # the same tiles, the same rule and each tile's own momentum on all
    # three sides: the same iterations per tile, so the iterates agree at
    # the float32 tolerance
    A, B, H0, _, _ = problem(d=300, r=r, n=n, seed=3 * r + n,
                             dtype=np.float32)
    got = _emulate_fista_tiled(_t(A), _t(B), _t(H0), 0.1, stop, 40, True)
    want = _pallas_fista(A, B, H0, 0.1, stop, sub_iter=40,
                         use_stopping=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain, sweeps = ck.fista_sweeps_plain(_t(A), _t(B), _t(H0), 0.1, stop,
                                          sub_iter=40, with_sweeps=True)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    assert sweeps.shape == (-(-n // ck.TN),)
    assert 1 <= int(sweeps.min()) and int(sweeps.max()) <= 40


@pytest.mark.parametrize("r,n", [(25, 100), (100, 100)])
def test_tiled_fista_emulation_bf16_matches_pallas(r, n):
    A, B, H0, obj, _ = problem(d=300, r=r, n=n, seed=r, dtype=np.float32)
    got = _emulate_fista_tiled(_t(A), _t(B), _t(H0), 0.5, 0.0, 10, False,
                               bf16=True).numpy()
    want = _pallas_fista(A, B, H0, 0.5, 0.0, sub_iter=10,
                         use_stopping=False, bf16_matmul=True)
    # bf16 rounding points differ between the two: loose elementwise plus
    # the objective within 0.5%, as the plain version is held above
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)
    assert abs(obj(got, 0.5) - obj(want, 0.5)) \
        <= 0.005 * abs(obj(want, 0.5)) + 1e-6
    # one iteration: both round the same inputs and the products are exact
    # in float32, so the plain version agrees at the float32 tolerance
    one = _emulate_fista_tiled(_t(A), _t(B), _t(H0), 0.5, 0.0, 1, False,
                               bf16=True)
    plain = ck.fista_sweeps_plain(_t(A), _t(B), _t(H0), 0.5, 0.0,
                                  sub_iter=1, use_stopping=False,
                                  bf16_matmul=True)
    np.testing.assert_allclose(one.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("r,n", [(1, 500), (4, 4133), (8, 500), (8, 4133),
                                 (33, 500), (128, 500)])
def test_bf16_fista_in_another_sum_order_parts_only_at_a_rounding(r, n):
    # the card tests' bf16 check, here on the plain version against itself
    # with the rank's rows permuted (the same function, its float32 sums in
    # another order): one iteration agrees at the float32 tolerance; after
    # ten a column agrees at atol 1.5e-3 or left at one bf16 rounding of Y
    # (one column does at (8, 4133), two at (4, 4133))
    from test_torch_cuda import BF16_TEN_TOL, assert_bf16_close

    rng = np.random.default_rng(7 * r + n)
    W = rng.random((300, r)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0)
    A, B = _t(W.T @ W), _t(W.T @ rng.random((300, n)).astype(np.float32))
    H0 = _t(rng.random((r, n)).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(r))
    back = torch.argsort(perm)
    kw = dict(use_stopping=False, bf16_matmul=True)

    def plain(k):
        return ck.fista_sweeps_plain(A, B, H0, 0.1, 0.01, sub_iter=k, **kw)

    def permuted(k):
        return ck.fista_sweeps_plain(
            A[perm][:, perm].contiguous(), B[perm].contiguous(),
            H0[perm].contiguous(), 0.1, 0.01, sub_iter=k, **kw)[back]

    np.testing.assert_allclose(permuted(1).numpy(), plain(1).numpy(), **TOL)
    parted = assert_bf16_close(permuted, plain, A, 10, BF16_TEN_TOL)
    assert 0 <= parted <= max(1, n // 500)


# float32 PyTorch emulation of the wide FISTA kernel's order of operations
# (fista_wide_kernel, past the shared ranks), against the Pallas kernel in
# interpret mode with its tile set to the port's TN and against the plain
# version. fmaf is a float32 multiply-add rounded once.
def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _warp_sum(lanes):
    """warp_sum's butterfly over 32 lanes' partial sums."""
    idx = torch.arange(32)
    m = 16
    while m:
        lanes = lanes + lanes[idx ^ m]
        m //= 2
    return lanes[0]


def _lane_dot(x, y):
    """sum of fmaf(x[k], y[k]) with lane k % 32 summing its k in order, then
    warp_sum (ft_normalise, ft_rayleigh)."""
    m = -(-x.shape[0] // 32)
    xp, yp = torch.zeros(32 * m), torch.zeros(32 * m)
    xp[:x.shape[0]], yp[:y.shape[0]] = x, y
    acc = torch.zeros(32)
    for i in range(m):
        acc = _fma(xp[32 * i:32 * i + 32], yp[32 * i:32 * i + 32], acc)
    return _warp_sum(acc)


def _row_matvec(G, v):
    """ft_matvec: one thread per row k of w = G v, four partial sums over
    l = q (mod 4) in order (the tail into the first), then (a0 + a1) +
    (a2 + a3); the absolute row sums alike."""
    r = G.shape[0]
    a = [torch.zeros(r) for _ in range(4)]
    s = [torch.zeros(r) for _ in range(4)]
    for l in range(r):
        q = l % 4 if l < r - r % 4 else 0
        a[q] = _fma(G[l], v[l], a[q])
        s[q] = s[q] + G[l].abs()
    return (a[0] + a[1]) + (a[2] + a[3]), (s[0] + s[1]) + (s[2] + s[3])


def _normalise(w):
    return w / torch.clamp_min(torch.sqrt(_lane_dot(w, w)), 1e-30)


def _rayleigh(v, w):
    return _lane_dot(v, w) / torch.clamp_min(_lane_dot(v, v), 1e-30)


def _wide_decision(Gd, Gh, vs, stop2, pi_iters):
    """ft_stop_decision on both Grams; updates the vectors ``vs`` [vd, vh]
    in place and returns True when the tile converged."""
    r = Gd.shape[0]
    v0 = ck._fixed_start(r, torch.float32, "cpu")
    ws, lb, ub = [], [], []
    for i, G in enumerate((Gd, Gh)):
        v = _fma(torch.full((r,), 0.05), v0, vs[i])
        w, ab = _row_matvec(G, v)
        trace = _warp_sum(torch.zeros(32).index_add_(
            0, torch.arange(r) % 32, torch.diagonal(G)))
        ub.append(torch.minimum(trace, ab.max()))
        v = _normalise(w)
        w, _ = _row_matvec(G, v)
        lb.append(_rayleigh(v, w))
        vs[i], ws = v, ws + [w]
    if bool(ub[0] <= stop2 * lb[1]) or bool(lb[0] > stop2 * ub[1]):
        return bool(ub[0] <= stop2 * lb[1])
    lam = []
    for i, G in enumerate((Gd, Gh)):
        v, w = vs[i], ws[i]
        for _ in range(pi_iters):
            v = _normalise(w)
            w, _ = _row_matvec(G, v)
        vs[i] = v
        lam.append(_rayleigh(v, w))
    return bool(lam[0] <= stop2 * lam[1])


def _emulate_fista_wide(A, B, H0, alpha, stop, sub_iter, use_stopping,
                        bf16=False, pi_iters=12):
    """fista_wide_kernel: per tile of TN columns, the rows in passes of
    ``rows``, each pass's sum over j in staged chunks of ``chunk`` rows,
    one fmaf accumulator per output carried across the chunks (A and Y
    rounded to bf16 first in bf16 mode); the new columns of every pass
    before H and Y are updated; with the stop, each Gram's upper blocks
    (4 x 4 or 8 x 8: the same sums) summed over column chunks of
    ``gram_cols`` in order (carried from chunk to chunk), mirrored, then
    ft_stop_decision's per-row power steps; the step applied in the
    converging iteration too, and the tile's own momentum."""
    r, n = B.shape
    _, _, passes, rows, chunk, _, gram_cols, _, _ = ck.fista_wide_config(
        r, use_stopping)
    inv_L = ck._inv_lipschitz(A, max(16, pi_iters))
    Ar = _bf16(A) if bf16 else A
    stop2 = torch.tensor(stop, dtype=torch.float32) ** 2
    out = torch.empty_like(B)
    for t0 in range(0, n, ck.TN):
        w = min(ck.TN, n - t0)
        H, b = torch.zeros((r, ck.TN)), torch.zeros((r, ck.TN))
        H[:, :w], b[:, :w] = H0[:, t0:t0 + w], B[:, t0:t0 + w]
        Y, tm = H.clone(), torch.tensor(1.0)
        vs = [ck._fixed_start(r, torch.float32, "cpu")] * 2
        for _ in range(sub_iter):
            tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tm * tm))
            mom, tm = (tm - 1.0) / tn, tn
            Yr = _bf16(Y) if bf16 else Y
            Hn = torch.zeros_like(Y)
            for p in range(passes):
                k = slice(p * rows, min(r, (p + 1) * rows))
                acc = torch.zeros((k.stop - k.start, ck.TN))
                for j0 in range(0, r, chunk):
                    for j in range(j0, min(r, j0 + chunk)):
                        acc = _fma(Ar[k, j, None], Yr[j], acc)
                Hn[k] = torch.clamp_min(
                    Y[k] - inv_L * (acc - b[k] + alpha), 0.0)
            Hn[:, w:] = 0.0
            conv = False
            if use_stopping:
                grams = []
                for M in (Hn - H, H):
                    G = torch.zeros((r, r))
                    for c0 in range(0, ck.TN, gram_cols):
                        for c in range(c0, c0 + gram_cols):
                            G = _fma(M[:, c, None], M[None, :, c], G)
                    grams.append(G)
                conv = _wide_decision(*grams, vs, stop2, pi_iters)
            H, Y = Hn, Hn + mom * (Hn - H)
            if conv:
                break
        out[:, t0:t0 + w] = H[:, :w]
    return out


@pytest.mark.parametrize("mode,r", [("fixed", 129), ("fixed", 256),
                                    ("stop", 101), ("stop", 129),
                                    ("stop", 256), ("bf16", 129),
                                    ("bf16", 256)])
def test_wide_fista_emulation_matches_pallas(mode, r):
    # two whole tiles and a ragged one; the same tiles, rule and momentum
    # as the Pallas kernel at block_n = TN and the plain version, so the
    # same iterations per tile and the iterates at the float32 tolerance
    # (bf16: ten iterations at the Pallas bf16 tolerances, one at float32)
    n = 2 * ck.TN + 37
    A, B, H0, obj, _ = problem(d=300, r=r, n=n, seed=r + len(mode),
                               dtype=np.float32)
    stop = 0.01 if mode == "stop" else 0.0
    kw = dict(sub_iter=20 if mode == "stop" else 10,
              use_stopping=mode == "stop")
    bf16 = mode == "bf16"
    got = _emulate_fista_wide(_t(A), _t(B), _t(H0), 0.1, stop, bf16=bf16,
                              **kw)
    assert got.dtype == torch.float32
    want = _pallas_fista(A, B, H0, 0.1, stop, bf16_matmul=bf16, **kw)
    if bf16:
        np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)
        assert abs(obj(got.numpy(), 0.1) - obj(want, 0.1)) \
            <= 0.005 * abs(obj(want, 0.1)) + 1e-6
        kw["sub_iter"] = 1
        got = _emulate_fista_wide(_t(A), _t(B), _t(H0), 0.1, stop,
                                  bf16=True, **kw)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = ck.fista_sweeps_plain(_t(A), _t(B), _t(H0), 0.1, stop,
                                  bf16_matmul=bf16, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("use_stopping", [False, True])
def test_wide_fista_emulation_streamed_matches_plain(use_stopping):
    # the streamed regime (Y in the workspace, four passes of 100 rows)
    # past FW_RESIDENT_MAX_RANK, a ragged second tile
    r, n = ck.FW_RESIDENT_MAX_RANK + 1, ck.TN + 21
    assert ck.fista_wide_config(r, use_stopping)[:4] == (
        "streamed", 416, 4, 100)
    A, B, H0, _, _ = problem(d=500, r=r, n=n, seed=5, dtype=np.float32)
    kw = dict(sub_iter=4, use_stopping=use_stopping)
    got = _emulate_fista_wide(_t(A), _t(B), _t(H0), 0.1, 0.01, **kw)
    plain = ck.fista_sweeps_plain(_t(A), _t(B), _t(H0), 0.1, 0.01, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_fista_wide_config_by_rank_alone():
    # the regimes and the shapes at the boundaries, and every wide rank
    # fits a block of at most 512 threads and an SM's shared memory. With
    # the stop: 4 x 4 Gram blocks while those take the threads at most two
    # rounds, 8 x 8 past it; the Grams (rows to a multiple of the block),
    # the six power vectors and the staged tile in shared memory up to
    # r = 136, in the workspace past it
    assert ck.fista_wide_config(101, True) == (
        "resident", 416, 1, 104, 32, 4, 128, True,
        4 * (608 + 2 * 104 * 104 + 128 * 108))
    assert ck.fista_wide_config(129) == (
        "resident", 288, 2, 68, 32, 4, 128, False,
        4 * (129 * 128 + 2 * 32 * 68))
    assert ck.fista_wide_config(132, True)[5:8] == (4, 128, True)
    assert ck.fista_wide_config(133, True)[5:8] == (8, 128, True)
    assert ck.fista_wide_config(136, True)[7] is True
    assert ck.fista_wide_config(137, True)[7:] == (
        False, 4 * (137 * 128 + 2 * 32 * 72))
    assert ck.fista_wide_config(256)[:4] == ("resident", 512, 2, 128)
    assert ck.fista_wide_config(384)[8] == 229376
    assert ck.fista_wide_config(385)[:4] == ("streamed", 416, 4, 100)
    assert ck.fista_wide_config(512, True)[5:] == (8, 64, False,
                                                   4 * 64 * 516)
    assert ck.fista_wide_config(1248, True)[1:7] == (512, 10, 128, 32, 8, 32)
    for use_stopping, first in ((False, 129), (True, 101)):
        for r in range(first, ck.MAX_RANK + 1):
            regime, threads, passes, rows, chunk, side, cols, shared, \
                smem = ck.fista_wide_config(r, use_stopping)
            assert (regime == "resident") == (r <= ck.FW_RESIDENT_MAX_RANK)
            assert threads % 32 == 0 and 64 <= threads <= 512
            assert threads >= 4 * rows and rows % 4 == 0
            assert passes * rows >= r > (passes - 1) * rows
            assert chunk == 32 and cols & (cols - 1) == 0 and cols <= ck.TN
            nb = -(-r // 4)
            assert side == (8 if nb * (nb + 1) // 2 > 2 * threads else 4)
            grams = -(-r // side) * side
            stride = grams if (grams // 4) % 2 else grams + 4
            assert smem <= 229376 and (
                not use_stopping or 4 * cols * stride <= smem)
            assert shared == (use_stopping and r <= 136)


def test_fista_tile_config_by_rank_alone():
    # threads, row stride, Gram lanes and shared memory at the paths'
    # ranks; every rank of the shared routes fits a block and an SM
    assert ck.fista_tile_config(25) == (128, 28, 4,
                                        4 * (25 * 28 + 2 * 128 * 28))
    assert ck.fista_tile_config(25, True)[:3] == (128, 28, 4)
    assert ck.fista_tile_config(100, True)[:3] == (416, 100, 1)
    assert ck.fista_tile_config(100, True)[3] == 4 * (
        100 * 100 + 2 * 128 * 100 + 2 * 100 * 100 + 600)
    assert ck.fista_tile_config(128)[:3] == (512, 132, 1)
    assert ck.fista_tile_config(1)[:3] == (64, 4, 4)
    for use_stopping, limit in ((False, 128), (True, 100)):
        for r in range(1, limit + 1):
            threads, stride, lanes, smem = ck.fista_tile_config(
                r, use_stopping)
            assert 64 <= threads <= 512 and threads % 32 == 0
            assert threads >= -(-r // 4) * 16
            assert stride >= r and stride % 4 == 0 and (stride // 4) % 2
            assert lanes in (1, 2, 4) and smem <= 232448
        with pytest.raises(ValueError):
            ck.fista_tile_config(limit + 1, use_stopping)
    route = "fista_sweeps_stop"
    assert ck.kernel_route(route, 100) == "shared"
    assert ck.kernel_route(route, 101) == "workspace"

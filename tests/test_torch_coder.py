"""The PyTorch coder (onmf_ontf_ndl_tpu_torch.ops.coder) against the JAX
coder and the NumPy oracle, in float64 on the CPU."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from onmf_ontf_ndl_tpu.ops import coder as jcoder
from onmf_ontf_ndl_tpu_torch.ops import coder as tcoder
from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend
from oracle_np import code_oracle

torch.set_num_threads(1)

RNG = np.random.default_rng(30)


def make_problem(d=40, r=12, n=17):
    return RNG.random((d, r)), RNG.random((d, n)), RNG.random((r, n))


def _t(a):
    return torch.from_numpy(np.array(a))


# the (stopping, radius) paths of _code_impl
PATHS = [(None, None), (0.01, None), (0.1, None), (None, 0.3), (0.05, 0.3)]


@pytest.mark.parametrize("stop,radius", PATHS)
@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_code_impl_matches_jax_and_oracle(stop, radius, alpha):
    W, X, H0 = make_problem()
    A, B = W.T @ W, W.T @ X
    sub_iter = 5 if radius is not None else 10
    use_stop, use_rad = stop is not None, radius is not None
    got = tcoder._code_impl(_t(A), _t(B), _t(H0), alpha, stop, radius,
                            sub_iter, use_stop, use_rad).numpy()
    want = np.asarray(jcoder._code_impl(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), jnp.float64(alpha),
        jnp.float64(stop or 0.0), jnp.float64(radius or 0.0), sub_iter,
        use_stop, use_rad))
    oracle = code_oracle(X, W, H0.copy(), alpha=alpha, sub_iter=sub_iter,
                         stopping_diff=stop, radius=radius)
    # float64, same operation order up to BLAS summation: rtol 1e-9
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, oracle, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("stop", [None, 0.01])
def test_nonneg_code_gram_matches_jax(stop):
    W, X, H0 = make_problem(d=30, r=9, n=40)
    A, B = W.T @ W, W.T @ X
    got = tcoder.nonneg_code_gram(_t(A), _t(B), _t(H0), alpha=0.5,
                                  sub_iter=10, stopping_diff=stop).numpy()
    want = np.asarray(jcoder.nonneg_code_gram(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), alpha=0.5,
        sub_iter=10, stopping_diff=stop))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_nonneg_code_data_form_matches_oracle():
    W, X, H0 = make_problem()
    got = tcoder.nonneg_code(_t(X), _t(W), _t(H0), alpha=1.0,
                             stopping_diff=0.01).numpy()
    want = code_oracle(X, W, H0.copy(), alpha=1.0, sub_iter=10,
                       stopping_diff=0.01)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_spectral_norm_matches_numpy():
    for shape in ((5, 9), (9, 5)):
        M = RNG.standard_normal(shape)
        got = float(tcoder._spectral_norm(_t(M)))
        assert math.isclose(got, np.linalg.norm(M, 2), rel_tol=1e-12)


def test_zero_start_stops_on_nan():
    # the early-stop rule has no 1e-30 guard: an all-zero iterate gives
    # 0/0 = NaN and the loop stops after one sweep, as in the JAX loop
    W, X, _ = make_problem(r=6)
    A, B = W.T @ W, W.T @ X
    H0 = np.zeros((6, X.shape[1]))
    got = tcoder._code_impl(_t(A), _t(B), _t(H0), 1e6, 0.01, None, 10,
                            True, False).numpy()
    want = np.asarray(jcoder._code_impl(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(H0), jnp.float64(1e6),
        jnp.float64(0.01), jnp.float64(0.0), 10, True, False))
    np.testing.assert_array_equal(got, want)


def test_fista_not_ported_and_radius_rejects_cuda():
    # FISTA now dispatches (to _fista_impl for a CPU tensor) and rejects a
    # radius; the radius coder has no kernel, so backend="cuda" raises
    W, X, H0 = make_problem(r=4)
    A, B = _t(W.T @ W), _t(W.T @ X)
    got = tcoder.nonneg_code_gram(A, B, _t(H0), method="fista",
                                  stopping_diff=None)
    want = tcoder._fista_impl(A, B, _t(H0), 0.0, None, 10, False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="radius"):
        tcoder.nonneg_code_gram(A, B, _t(H0), method="fista", radius=0.1)
    with pytest.raises(ValueError, match="method"):
        tcoder.nonneg_code_gram(A, B, _t(H0), method="jacobi")
    with pytest.raises(ValueError):
        tcoder.nonneg_code_gram(A, B, _t(H0), radius=0.1, backend="cuda")
    assert resolve_backend("auto", A) == "torch"


@pytest.mark.parametrize("method", ["fista", "fista_bf16"])
def test_fista_dispatch_matches_jax_objective(method):
    # the data-form coder on FISTA reaches the JAX coder's objective (the
    # two H0 draws differ, so compare solutions, not iterates)
    W, X, _ = make_problem(d=30, r=6, n=25)
    got = tcoder.nonneg_code(_t(X), _t(W), generator=torch.Generator()
                             .manual_seed(0), alpha=0.5, sub_iter=200,
                             stopping_diff=None, method=method).numpy()
    want = np.asarray(jcoder.nonneg_code(
        jnp.asarray(X), jnp.asarray(W), key=jax.random.key(0), alpha=0.5,
        sub_iter=200, stopping_diff=None, method=method))

    def obj(H):
        return 0.5 * np.linalg.norm(X - W @ H) ** 2 + 0.5 * H.sum()

    assert obj(got) == pytest.approx(obj(want), rel=5e-3)
    assert (got >= 0).all()

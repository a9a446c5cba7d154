"""The PyTorch ONMF step, training loop and OnlineNMF against the JAX
package, in float64 on the CPU. Torch cannot reproduce JAX's threefry
draws, so the JAX draws are replayed into the port through ``draws=``.
Tolerance: rtol 1e-8 (float64, same operation order up to BLAS sums)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from onmf_ontf_ndl_tpu.models import onmf as jonmf
from onmf_ontf_ndl_tpu.models.state import init_state as jinit_state
from onmf_ontf_ndl_tpu_torch.models import onmf as tonmf
from onmf_ontf_ndl_tpu_torch.models.state import (init_state, state_from_numpy,
                                                  state_to_numpy)

torch.set_num_threads(1)

RNG = np.random.default_rng(32)
F64 = torch.float64


def _t(a):
    return torch.from_numpy(np.array(a))


def make_states(d=36, r=8, track_xxt=False, seed=0, **warm):
    W = RNG.random((d, r))
    js = jinit_state(jax.random.key(seed), d, r, track_xxt=track_xxt,
                     dtype=jnp.float64, W=W, **warm)
    ts = init_state(seed, d, r, track_xxt=track_xxt, dtype=F64, W=W,
                    device="cpu", **warm)
    return js, ts


def replay_draws(key, n, r, iterations, batch_size, subsample):
    """The training scan's draws, replayed on the host (the pattern of
    tests/test_onmf.py::_replay_rng) as the port's per-step (idx, H0)."""
    draws = []
    for _ in range(1, iterations):
        key, skey, hkey = jax.random.split(key, 3)
        if subsample:
            idx = np.asarray(jax.random.randint(skey, (batch_size,), 0, n))
        else:
            idx = np.arange(n)
        H0 = np.asarray(jax.random.uniform(hkey, (r, len(idx)),
                                           dtype=jnp.float64))
        draws.append((_t(idx), _t(H0)))
    return draws


def assert_state_close(ts, js, rtol=1e-8, atol=1e-12):
    for name in ("W", "A", "B", "C"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=rtol,
                                   atol=atol, err_msg=name)
    assert ts.t == float(js.t)


@pytest.mark.parametrize("dict_from", ["stale", "fresh"])
@pytest.mark.parametrize("track_xxt", [False, True])
@pytest.mark.parametrize("stop", [None, 0.01])
def test_onmf_step_matches_jax(dict_from, track_xxt, stop):
    warm = dict(A=RNG.random((8, 8)), B=RNG.random((8, 36)))
    if track_xxt:
        warm["C"] = RNG.random((36, 36))
    js, ts = make_states(track_xxt=track_xxt, **warm)
    X, H0 = RNG.random((36, 20)), RNG.random((8, 20))
    js1, jH = jonmf.onmf_step(js, jnp.asarray(X), t=3.0, H0=jnp.asarray(H0),
                              alpha=0.5, beta=0.7, stopping_diff=stop,
                              dict_from=dict_from)
    ts1, tH = tonmf.onmf_step(ts, _t(X), t=3.0, H0=_t(H0), alpha=0.5,
                              beta=0.7, stopping_diff=stop,
                              dict_from=dict_from)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-8,
                               atol=1e-12)
    assert_state_close(ts1, js1)


@pytest.mark.parametrize("subsample,stop,n,batch", [
    (True, 0.01, 50, 12),    # iid minibatches, early stop
    (False, None, 30, 0),    # full batch, fixed sweeps
    (True, None, 10, 25),    # batch > n: duplicate indices in track_code
])
def test_train_dict_matches_jax(subsample, stop, n, batch):
    d, r, iterations = 36, 8, 6
    js, ts = make_states(d=d, r=r, seed=7)
    X = RNG.random((d, n))
    draws = replay_draws(js.key, n, r, iterations, batch, subsample)
    kw = dict(iterations=iterations, batch_size=batch, subsample=subsample,
              alpha=0.3, beta=0.9, stopping_diff=stop, return_metrics=True)
    js1, jcode, jmet = jonmf.train_dict(js, jnp.asarray(X), **kw)
    ts1, tcode, tmet = tonmf.train_dict(ts, _t(X), draws=draws, **kw)
    assert_state_close(ts1, js1)
    np.testing.assert_allclose(tcode.numpy(), np.asarray(jcode), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(tmet.numpy(), np.asarray(jmet), rtol=1e-8)
    assert ts1.t == iterations


def test_train_dict_warm_start_continues_schedule():
    d, r, n = 24, 6, 40
    js, ts = make_states(d=d, r=r, seed=3)
    X = RNG.random((d, n))
    for _ in range(2):
        draws = replay_draws(js.key, n, r, 5, 8, True)
        js, _ = jonmf.train_dict(js, jnp.asarray(X), iterations=5,
                                 batch_size=8)
        ts, _ = tonmf.train_dict(ts, _t(X), iterations=5, batch_size=8,
                                 draws=draws)
    assert ts.t == 10.0
    assert_state_close(ts, js)


def test_train_dict_zero_steps_returns_inputs():
    _, ts = make_states()
    X = _t(RNG.random((36, 10)))
    for it in (0, 1):
        ts1, code = tonmf.train_dict(ts, X, iterations=it, batch_size=4)
        assert ts1 is ts and ts1.t == 0.0
        assert (code == 0).all() and code.shape == (8, 10)


def test_block_sampling_runs_and_advances_history():
    _, ts = make_states(d=20, r=5)
    X = _t(RNG.random((20, 30)))
    ts1, code = tonmf.train_dict(ts, X, iterations=4, batch_size=12,
                                 sampling="block", stopping_diff=None)
    assert ts1.t == 4.0 and (ts1.W >= 0).all()
    # 3 steps x 12 columns of codes landed in the accumulator
    assert int((code.sum(0) > 0).sum()) <= 30
    with pytest.raises(ValueError, match="sampling"):
        tonmf.train_dict(ts, X, iterations=3, batch_size=4, sampling="x")


def test_online_nmf_five_tuple_matches_jax():
    X = RNG.random((30, 60))
    W0 = RNG.random((30, 5))
    C0 = RNG.random((30, 30))
    jn = jonmf.OnlineNMF(X, n_components=5, iterations=4, batch_size=10,
                         ini_dict=W0, ini_C=C0, dtype=jnp.float64)
    draws = replay_draws(jn.state.key, 60, 5, 4, 10, False)
    tn = tonmf.OnlineNMF(X, n_components=5, iterations=4, batch_size=10,
                         ini_dict=W0, ini_C=C0, dtype=F64, device="cpu")
    jout = jn.train_dict()
    tout = tn.train_dict(draws=draws)
    assert len(tout) == 5
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                                   atol=1e-12)
    assert tn.history == jn.history == 4.0
    assert tuple(tn.components_.shape) == (5, 30)


def test_online_nmf_shims_and_fit_restart():
    X = RNG.random((20, 40))
    nmf = tonmf.OnlineNMF(X, n_components=4, iterations=3, dtype=F64,
                          device="cpu")
    W, A, B, C, H = nmf.train_dict()
    assert C is None and tuple(H.shape) == (4, 40)
    first = nmf.fit().state.W.clone()
    again = nmf.fit().state.W
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    codes = nmf.transform(X.T)
    assert tuple(codes.shape) == (40, 4) and (codes >= 0).all()
    assert tuple(nmf.inverse_transform(codes).shape) == (40, 20)
    nmf.partial_fit(X[:, :7])
    assert nmf.history == 4.0
    fista = tonmf.OnlineNMF(X, n_components=4, iterations=3, coder="fista",
                            dtype=F64, device="cpu")
    assert (fista.train_dict()[0] >= 0).all()
    with pytest.raises(ValueError, match="coder"):
        tonmf.OnlineNMF(X, coder="fsita", device="cpu")


def test_state_from_numpy_round_trip_gives_same_step():
    js, _ = make_states(d=24, r=6, track_xxt=True, C=RNG.random((24, 24)))
    js, _ = jonmf.train_dict(js, jnp.asarray(RNG.random((24, 30))),
                             iterations=3, batch_size=8)
    arrays = {k: np.asarray(getattr(js, k)) for k in ("W", "A", "B", "C")}
    ts = state_from_numpy(**arrays, t=float(js.t), dtype=F64, device="cpu")
    back = state_to_numpy(ts)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    X, H0 = RNG.random((24, 11)), RNG.random((6, 11))
    js1, jH = jonmf.onmf_step(js, jnp.asarray(X), H0=jnp.asarray(H0))
    ts1, tH = tonmf.onmf_step(ts, _t(X), H0=_t(H0))
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-8,
                               atol=1e-12)
    assert_state_close(ts1, js1)
    assert dataclasses.replace(ts1).tracks_xxt


def test_warm_start_shape_check():
    with pytest.raises(ValueError, match="expected"):
        init_state(0, 10, 4, W=np.zeros((10, 3)), device="cpu")

"""The port's tensor path (ops/unfold.py, models/ontf.py,
apps/image_tensor.py) against the JAX package, in float64 on the CPU.

Training takes the JAX draws, replayed through ``draws=``; the coder is
the tensor surface's default, FISTA run towards convergence, whose step
``1 / L`` can differ by one float32 ulp between the frameworks
(tests/test_torch_fista.py): rtol 1e-6 / atol 1e-7. Reconstruction draws
its H0 from another generator than JAX's, so the two agree only as far as
100 FISTA iterations converge to the unique solution. With a sparse
dictionary (condition number ~2, as a learned one is) they agree to 6e-10
at these sizes (a dense uniform one, condition ~5, only to 6e-4); held at
rtol 1e-6 / atol 1e-7.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from onmf_ontf_ndl_tpu.apps import image_tensor as japp
from onmf_ontf_ndl_tpu.models import ontf as jontf
from onmf_ontf_ndl_tpu.models.state import init_state as jinit_state
from onmf_ontf_ndl_tpu.ops import patches as jpatches
from onmf_ontf_ndl_tpu.ops import unfold as junfold
from onmf_ontf_ndl_tpu_torch.apps import image_tensor as tapp
from onmf_ontf_ndl_tpu_torch.models import ontf as tontf
from onmf_ontf_ndl_tpu_torch.models.state import init_state
from onmf_ontf_ndl_tpu_torch.ops import unfold as tunfold
from test_torch_image_app import make_image
from test_torch_onmf import replay_draws

torch.set_num_threads(1)

RNG = np.random.default_rng(35)
F64 = torch.float64
TOL = dict(rtol=1e-6, atol=1e-7)
RECON_TOL = dict(rtol=1e-6, atol=1e-7)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(3, 4, 5), (2, 3, 4, 5)])
@pytest.mark.parametrize("mode", [0, 1, 2, -1])
def test_unfold_and_fold_equal_jax(shape, mode):
    X = RNG.random(shape)
    got = tunfold.unfold(_t(X), mode)
    want = np.asarray(junfold.unfold(jnp.asarray(X), mode))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tunfold.fold(got, mode, shape)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(junfold.fold(jnp.asarray(want), mode,
                                              shape)))
    np.testing.assert_array_equal(back.numpy(), X)


def test_unfolded_dim_and_coder_policy_match_jax():
    for k, n, mode, joint, ch in [(4, 10, m, j, c) for m in (0, 1, 2)
                                  for j in (False, True) for c in (1, 3)]:
        assert tapp.unfolded_dim(k, n, mode, joint, ch) \
            == japp.unfolded_dim(k, n, mode, joint, ch)
    for args in [("exact", 4, None), ("exact", 150, None), ("bcd", 4, None),
                 ("fista", 40, None), ("exact", 4, 7), ("fista_bf16", 2, 3)]:
        assert tontf.resolve_tensor_coder(*args) \
            == jontf.resolve_tensor_coder(*args)


def test_online_ntf_train_dict_single_matches_jax():
    X = RNG.random((6, 10, 3))
    W0 = RNG.random((6, 5))
    kw = dict(n_components=5, iterations=5, batch_size=8, ini_dict=W0,
              mode=0, sub_iterations=4)
    jn = jontf.OnlineNTF(X, dtype=jnp.float64, **kw)
    tn = tontf.OnlineNTF(X, dtype=F64, device="cpu", **kw)
    assert tuple(tn.X_unfold.shape) == tuple(jn.X_unfold.shape) == (6, 30)
    draws = replay_draws(jn.state.key, 30, 5, 5, 8, True)
    jout = jn.train_dict_single()
    tout = tn.train_dict_single(draws=draws)
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tn.history == jn.history == 5.0
    # joint dictionary over the other modes, and the coder's H^T
    jn = jontf.OnlineNTF(X, n_components=4, learn_joint_dict=True, mode=2,
                         dtype=jnp.float64)
    tn = tontf.OnlineNTF(X, n_components=4, learn_joint_dict=True, mode=2,
                         dtype=F64, device="cpu")
    assert tuple(tn.X_unfold.shape) == (60, 3)
    H = tn.joint_sparse_code_tensor(tn.X_unfold, _t(RNG.random((60, 4))))
    assert tuple(H.shape) == (3, 4) and (H >= 0).all()


def replay_tensor_draws(key, img_shape, k, r, outer, num_patches, inner,
                        n_cols, batch):
    """The JAX tensor trainer's corner and (idx, H0) draws: per outer a
    split for the corners, then the inner scan's three-way splits."""
    draws = []
    for _ in range(outer):
        key, pkey = jax.random.split(key)
        a, b = jpatches.random_patch_corners(pkey, img_shape, k, num_patches)
        steps = []
        for _ in range(1, inner):
            key, skey, hkey = jax.random.split(key, 3)
            idx = jax.random.randint(skey, (batch,), 0, n_cols)
            H0 = jax.random.uniform(hkey, (r, batch), dtype=jnp.float64)
            steps.append((_t(idx), _t(H0)))
        draws.append(((_t(a), _t(b)), steps))
    return draws


@pytest.mark.parametrize("color,mode,joint", [
    (True, 0, False),    # marginal spatial dictionary, d = k^2
    (True, 1, False),    # channel dictionary, d = 3
    (True, 2, True),     # joint colour dictionary, d = 3 k^2
    (False, 0, False),   # grey (k^2, n, 1)
])
def test_train_tensor_matches_jax(color, mode, joint):
    img = make_image(20, 22, color=color, seed=6)
    k, r, num, outer, inner, batch = 4, 3, 12, 3, 3, 6
    ch = 3 if color else 1
    d = japp.unfolded_dim(k, num, mode, joint, ch)
    n_cols = k * k * ch * num // d
    W = RNG.random((d, r))
    js = jinit_state(jax.random.key(2), d, r, dtype=jnp.float64, W=W)
    ts = init_state(2, d, r, dtype=F64, W=W, device="cpu")
    kw = dict(outer_iterations=outer, num_patches=num,
              inner_iterations=inner, batch_size=batch, patch_size=k,
              mode=mode, joint=joint, alpha=2.0, beta=1.0, sub_iter=100,
              coder="fista")
    draws = replay_tensor_draws(js.key, img.shape[:2], k, r, outer, num,
                                inner, n_cols, batch)
    js1 = japp._train_tensor(js, jnp.asarray(img), **kw)
    ts1 = tapp._train_tensor(ts, _t(img), draws=draws, **kw)
    for name in ("W", "A", "B"):
        np.testing.assert_allclose(getattr(ts1, name).numpy(),
                                   np.asarray(getattr(js1, name)),
                                   err_msg=name, **TOL)
    assert ts1.t == float(js1.t) == outer * inner


def sparse_dictionary(d, r):
    return RNG.random((d, r)) * (RNG.random((d, r)) < 0.3)


def _pair(**kw):
    return (japp.ImageReconstructorTensor(dtype=jnp.float64, **kw),
            tapp.ImageReconstructorTensor(dtype=F64, device="cpu", **kw))


def test_reconstruct_image_color_matches_jax():
    img = make_image(24, 26, color=True, seed=8)
    jrec, trec = _pair(data=img, patch_size=5, n_components=6)
    W = sparse_dictionary(75, 6)
    jrec.W, trec.W = jnp.asarray(W), _t(W)
    want = np.asarray(jrec.reconstruct_image_color(data=img,
                                                   recons_resolution=2))
    got = trec.reconstruct_image_color(data=img, recons_resolution=2)
    assert tuple(got.shape) == img.shape
    np.testing.assert_allclose(got.numpy(), want, **RECON_TOL)


def test_reconstruct_image_matches_jax():
    img = make_image(21, 24, color=False, seed=9)
    jrec, trec = _pair(data=img, patch_size=4, n_components=5,
                       downscale_factor=1)
    W = sparse_dictionary(16, 5)
    jrec.W, trec.W = jnp.asarray(W), _t(W)
    want = np.asarray(jrec.reconstruct_image(data=img))
    got = trec.reconstruct_image(data=img)
    np.testing.assert_allclose(got.numpy(), want, **RECON_TOL)
    with pytest.raises(ValueError, match="spatial"):
        trec.reconstruct_image(data=img, patch_size=3)


def test_tensor_app_learns_joint_dictionary():
    img = make_image(32, 32, color=True)
    rec = tapp.ImageReconstructorTensor(
        data=img, n_components=8, iterations=6, sub_iterations=3,
        batch_size=20, block_iterations=4, num_patches=40, patch_size=4,
        learn_joint_dict=True, dtype=F64, seed=1, device="cpu")
    with pytest.raises(ValueError, match="joint"):
        rec.reconstruct_image_color(data=img)
    W0 = init_state(1, 48, 8, dtype=F64, device="cpu").W
    W = rec.train_dict(mode=2)
    assert tuple(W.shape) == (48, 8) and (W >= 0).all()
    assert rec.coder_sub_iter == 100 and rec.state.t == 6 * 3
    out = rec.reconstruct_image_color(data=img, recons_resolution=2)
    rec.W = W0 / W0.norm(dim=0).clamp_min(1.0)
    out0 = rec.reconstruct_image_color(data=img, recons_resolution=2)

    def err(o):
        mask = o.sum(-1) > 0
        return float(torch.linalg.norm((o - _t(img))[mask])
                     / torch.linalg.norm(_t(img)[mask]))

    assert torch.isfinite(out).all() and err(out) < err(out0)

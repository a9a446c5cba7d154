"""The PyTorch image pipeline (patches, images, apps/image.py, checkpoint)
against the JAX package on the CPU, in float64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from onmf_ontf_ndl_tpu.apps import image as japp
from onmf_ontf_ndl_tpu.data import images as jimages
from onmf_ontf_ndl_tpu.models.state import init_state as jinit_state
from onmf_ontf_ndl_tpu.ops import patches as jpatches
from onmf_ontf_ndl_tpu.utils import checkpoint as jckpt
from onmf_ontf_ndl_tpu_torch.apps import image as tapp
from onmf_ontf_ndl_tpu_torch.data import images as timages
from onmf_ontf_ndl_tpu_torch.models.state import init_state, make_generator
from onmf_ontf_ndl_tpu_torch.ops import patches as tpatches
from onmf_ontf_ndl_tpu_torch.utils import checkpoint as tckpt
from onmf_ontf_ndl_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

RNG = np.random.default_rng(33)
F64 = torch.float64


def _t(a):
    return torch.from_numpy(np.array(a))


def make_image(h=48, w=48, color=True, seed=4):
    """The synthetic image of tests/test_image_app.py."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.4 * np.sin(xx / 3.0) * np.cos(yy / 4.0)
    img = np.stack([base, base**2, 1 - base], axis=-1) if color else base
    img = img + 0.02 * rng.random(img.shape)
    return np.clip(img, 0, 1)


@pytest.mark.parametrize("color", [False, True])
def test_extract_and_overlap_average_match_jax_exactly(color):
    img = RNG.random((19, 23, 3) if color else (19, 23))
    a, b = RNG.integers(0, 14, 30), RNG.integers(0, 18, 30)
    k = 5
    got = tpatches.extract_patches(_t(img), (_t(a), _t(b)), k)
    want = jpatches.extract_patches(jnp.asarray(img),
                                    (jnp.asarray(a), jnp.asarray(b)), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = RNG.random(got.shape)
    got = tpatches.overlap_average(_t(vals), (_t(a), _t(b)), k, img.shape)
    want = jpatches.overlap_average(jnp.asarray(vals),
                                    (jnp.asarray(a), jnp.asarray(b)), k,
                                    img.shape)
    # scatter-add order may differ: float64 rounding only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("inclusive", [False, True])
def test_grid_patches_match_jax_exactly(color, stride, inclusive):
    img = RNG.random((17, 22, 3) if color else (17, 22))
    k = 4
    got = tpatches.extract_patches_grid(_t(img), k, stride,
                                        inclusive=inclusive)
    want = jpatches.extract_patches_grid(jnp.asarray(img), k, stride,
                                         inclusive=inclusive)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = RNG.random(got.shape)
    got = tpatches.overlap_average_grid(_t(vals), k, stride, img.shape,
                                        inclusive=inclusive)
    want = jpatches.overlap_average_grid(jnp.asarray(vals), k, stride,
                                         img.shape, inclusive=inclusive)
    # fold adds each pixel's patches in the same (kh, kw) order as the
    # JAX pad-and-add loop: equal, not merely close
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_downscale_and_load_match_jax(tmp_path):
    from PIL import Image

    img = RNG.random((13, 10, 3))
    for f in (1, 2, 3):
        np.testing.assert_allclose(
            timages.downscale_local_mean(_t(img), f).numpy(),
            np.asarray(jimages.downscale_local_mean(jnp.asarray(img), f)),
            rtol=1e-14)
    path = str(tmp_path / "img.png")
    Image.fromarray((img * 255).astype(np.uint8)).save(path)
    for color in (True, False):
        np.testing.assert_allclose(
            timages.load_image(path, is_color=color, dtype=F64,
                               device="cpu").numpy(),
            np.asarray(jimages.load_image(path, is_color=color,
                                          dtype=jnp.float64)), rtol=1e-15)


def replay_image_draws(key, img_shape, k, r, outer, num_patches, inner):
    """The JAX trainer's corner and H0 draws (outer split, then the inner
    scan's three-way splits), as the port's ``draws``."""
    draws = []
    for _ in range(outer):
        key, pkey = jax.random.split(key)
        a, b = jpatches.random_patch_corners(pkey, img_shape, k, num_patches)
        steps = []
        for _ in range(1, inner):
            key, _, hkey = jax.random.split(key, 3)
            H0 = jax.random.uniform(hkey, (r, num_patches),
                                    dtype=jnp.float64)
            steps.append((None, _t(H0)))
        draws.append(((_t(a), _t(b)), steps))
    return draws


@pytest.mark.parametrize("use_stopping", [True, False])
def test_train_image_dict_matches_jax(use_stopping):
    img = make_image(32, 36, color=True)
    k, r, d = 5, 6, 75
    W = RNG.random((d, r))
    js = jinit_state(jax.random.key(5), d, r, dtype=jnp.float64, W=W)
    ts = init_state(5, d, r, dtype=F64, W=W, device="cpu")
    kw = dict(outer_iterations=3, num_patches=20, inner_iterations=4,
              batch_size=8, patch_size=k, alpha=0.2,
              use_stopping=use_stopping)
    draws = replay_image_draws(js.key, img.shape[:2], k, r, 3, 20, 4)
    js1 = japp.train_image_dict(js, jnp.asarray(img), **kw)
    ts1 = tapp.train_image_dict(ts, _t(img), draws=draws, **kw)
    for name in ("W", "A", "B"):
        np.testing.assert_allclose(getattr(ts1, name).numpy(),
                                   np.asarray(getattr(js1, name)),
                                   rtol=1e-8, atol=1e-12, err_msg=name)
    assert ts1.t == float(js1.t) == 3 * 4


def _masked_err(o, img):
    mask = o.sum(axis=-1) > 0
    return np.linalg.norm((o - img)[mask]) / np.linalg.norm(img[mask])


def test_color_pipeline_learns_and_reconstructs():
    img = make_image(color=True)
    rec = tapp.ImageReconstructor(
        data=img, n_components=16, iterations=20, sub_iterations=5,
        num_patches=50, batch_size=16, patch_size=6, is_color=True,
        dtype=F64, device="cpu")
    W0 = rec.state.W.numpy().copy()
    rec.train_dict()
    W = rec.state.W.numpy()
    assert (W >= 0).all()
    assert rec.state.t == 20 * 5
    W0n = W0 / np.maximum(1, np.linalg.norm(W0, axis=0))
    out0 = tapp.reconstruct(_t(img), _t(W0n), make_generator(1, "cpu"),
                            patch_size=6, stride=2).numpy()
    out = rec.reconstruct_image_color(data=img, recons_resolution=2).numpy()
    assert out.shape == img.shape
    assert _masked_err(out, img) < _masked_err(out0, img)
    assert _masked_err(out, img) < 0.3


def test_gray_pipeline_full_grid():
    img = make_image(color=False)
    rec = tapp.ImageReconstructor(
        data=img, n_components=9, iterations=10, sub_iterations=5,
        num_patches=40, batch_size=10, patch_size=5, is_color=False,
        downscale_factor=1, dtype=F64, device="cpu")
    rec.train_dict()
    out = rec.reconstruct_image(data=img).numpy()
    assert out.shape == img.shape
    assert (out > 0).all()   # the full grid paints every pixel
    assert np.linalg.norm(out - img) / np.linalg.norm(img) < 0.25
    # a stack of one matrix trains like the image: grey, d = k^2
    stack = tapp.ImageReconstructor(
        data=img[None], is_stack=True, n_components=9, iterations=2,
        sub_iterations=5, num_patches=40, patch_size=5, dtype=F64,
        device="cpu")
    assert stack.is_stack and not stack.is_color
    assert stack.train_dict().shape == (25, 9) and stack.state.t == 2 * 5
    with pytest.raises(ValueError, match="is_stack expects"):
        tapp.ImageReconstructor(data=img, is_stack=True, device="cpu")


def test_checkpoint_interop_both_ways(tmp_path):
    d, r = 12, 4
    js = jinit_state(jax.random.key(9), d, r, dtype=jnp.float64,
                     track_xxt=True, A=RNG.random((r, r)),
                     B=RNG.random((r, d)), C=RNG.random((d, d)), t=7.0)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_state(jpath, js)
    ts = tckpt.load_state(jpath, device="cpu")
    for name in ("W", "A", "B", "C"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    assert ts.t == 7.0
    # the JAX key data seeds the port's generator (the stream is not
    # carried across frameworks)
    hi, lo = (int(v) for v in np.asarray(jax.random.key_data(js.key)))
    assert ts.gen.initial_seed() == (hi << 32) | lo

    ts = init_state(11, d, r, dtype=F64, track_xxt=True,
                    A=RNG.random((r, r)), B=RNG.random((r, d)),
                    C=RNG.random((d, d)), t=3.0, device="cpu")
    tpath = str(tmp_path / "torch")
    tckpt.save_state(tpath, ts, extra={"code": np.arange(5)})
    assert tckpt.checkpoint_exists(tpath)
    js = jckpt.load_state(tpath + ".npz")
    for name in ("W", "A", "B", "C"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy())
    assert float(js.t) == 3.0
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(js.key)),
                                  np.asarray(jax.random.key_data(
                                      jax.random.key(11))))
    # the port restores its own stream exactly, and the extras
    back, extra = tckpt.load_state(tpath, with_extra=True, device="cpu")
    assert torch.equal(torch.rand(4, generator=back.gen),
                       torch.rand(4, generator=ts.gen))
    np.testing.assert_array_equal(extra["code"].numpy(), np.arange(5))


def test_checkpoint_chunking_and_resume_exact(tmp_path):
    y, x = np.mgrid[0:32, 0:40]
    img = 0.5 + 0.3 * np.sin(x / 5.0) * np.cos(y / 4.0)
    kw = dict(data=img, n_components=4, iterations=6, sub_iterations=3,
              num_patches=12, batch_size=6, patch_size=4, is_color=False,
              dtype=F64, seed=3, device="cpu")
    Wa = tapp.ImageReconstructor(**kw).train_dict()
    ckpt = str(tmp_path / "img.npz")
    Wb = tapp.ImageReconstructor(**kw).train_dict(checkpoint_path=ckpt,
                                                  checkpoint_every=2)
    torch.testing.assert_close(Wa, Wb, rtol=0, atol=0)
    part = tapp.ImageReconstructor(**kw)
    part.iterations = 4
    part.train_dict(checkpoint_path=str(tmp_path / "c.npz"),
                    checkpoint_every=2)
    c = tapp.ImageReconstructor(**kw)
    Wc = c.train_dict(checkpoint_path=str(tmp_path / "c.npz"),
                      checkpoint_every=2, resume=True)
    torch.testing.assert_close(Wa, Wc, rtol=0, atol=0)
    assert c.state.t == 18.0
    with pytest.raises(ValueError, match="checkpoint_every"):
        c.train_dict(checkpoint_path=ckpt)


def test_metrics_match_jax():
    from onmf_ontf_ndl_tpu.utils import metrics as jmetrics

    W, A, B, C = (RNG.random(s) for s in ((9, 4), (4, 4), (4, 9), (9, 9)))
    X, H = RNG.random((9, 7)), RNG.random((4, 7))
    for got, want in (
            (tmetrics.surrogate_error(_t(W), _t(A), _t(B), _t(C)),
             jmetrics.surrogate_error(W, A, B, C)),
            (tmetrics.relative_recon_error(_t(X), _t(W), _t(H)),
             jmetrics.relative_recon_error(X, W, H)),
            (tmetrics.code_covariance(_t(H)), jmetrics.code_covariance(H)),
            (tmetrics.code_covariance(_t(np.zeros((3, 5)))),
             jmetrics.code_covariance(np.zeros((3, 5))))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-15)

"""The port's video path (data/video.py, apps/video.py), the image app's
stacked path and the two grid-corner functions of ops/patches.py against
the JAX package, on the CPU.

Training replays JAX's draws (corners per frame, then the inner scan's
batch indices and H0) through the port's ``draws=`` hook: float64 against
JAX x64 at rtol 1e-8 / atol 1e-12, the golden tolerance of
tests/test_torch_onmf.py; float32 against the float64 run at 1e-4
relative. The loader reads a GIF that the test writes itself.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from onmf_ontf_ndl_tpu.apps import image as jimage
from onmf_ontf_ndl_tpu.apps import video as jvideo
from onmf_ontf_ndl_tpu.data import video as jdata
from onmf_ontf_ndl_tpu.models.state import init_state as jinit_state
from onmf_ontf_ndl_tpu.ops import patches as jpatches
from onmf_ontf_ndl_tpu_torch.apps import image as timage
from onmf_ontf_ndl_tpu_torch.apps import video as tvideo
from onmf_ontf_ndl_tpu_torch.data import video as tdata
from onmf_ontf_ndl_tpu_torch.models.state import init_state
from onmf_ontf_ndl_tpu_torch.ops import patches as tpatches

torch.set_num_threads(1)

RNG = np.random.default_rng(41)
F64 = torch.float64


def _t(a):
    return torch.from_numpy(np.array(a))


def make_frames(f=5, h=20, w=24, color=True, seed=2):
    """A drifting pattern with a little noise, in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(f):
        base = 0.5 + 0.4 * np.sin((xx + 2 * t) / 3.0) * np.cos(yy / 4.0)
        img = np.stack([base, base**2, 1 - base], -1) if color else base
        frames.append(np.clip(img + 0.02 * rng.random(img.shape), 0, 1))
    return np.stack(frames)


def replay_video_draws(key, frame_shape, k, r, visits, num_patches, inner,
                       batch_size=None):
    """The JAX video trainer's draws per visited frame: the corners (a
    split of the state's key), then the inner scan's three-way splits
    (batch indices with ``batch_size``, H0)."""
    draws = []
    for _ in range(visits):
        key, pkey = jax.random.split(key)
        a, b = jpatches.random_patch_corners(pkey, frame_shape, k,
                                             num_patches)
        steps = []
        for _ in range(1, inner):
            key, skey, hkey = jax.random.split(key, 3)
            idx, cols = None, num_patches
            if batch_size is not None:
                idx = _t(jax.random.randint(skey, (batch_size,), 0,
                                            num_patches))
                cols = batch_size
            steps.append((idx, _t(jax.random.uniform(
                hkey, (r, cols), dtype=jnp.float64))))
        draws.append(((_t(a), _t(b)), steps))
    return draws


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("color", [False, True])
def test_grid_corners_equal_jax_and_the_grid_extraction(color, stride):
    img = RNG.random((17, 22, 3) if color else (17, 22))
    k = 4
    got = tpatches.grid_patch_corners(img.shape[:2], k, stride, device="cpu")
    want = jpatches.grid_patch_corners(img.shape[:2], k, stride)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tpatches.extract_patches(_t(img), got, k).numpy(),
        tpatches.extract_patches_grid(_t(img), k, stride).numpy())
    # the same values paint the same canvas through both forms
    vals = _t(RNG.random((k * k * (3 if color else 1), got[0].shape[0])))
    np.testing.assert_allclose(
        tpatches.overlap_average(vals, got, k, img.shape).numpy(),
        tpatches.overlap_average_grid(vals, k, stride, img.shape).numpy(),
        rtol=1e-13)


@pytest.mark.parametrize("color", [False, True])
def test_all_corners_equal_jax_and_the_full_grid(color):
    img = RNG.random((9, 13, 3) if color else (9, 13))
    k = 5
    got = tpatches.all_patch_corners(img.shape[:2], k, device="cpu")
    want = jpatches.all_patch_corners(img.shape[:2], k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (5 * 9,) and int(got[0].max()) == 4
    np.testing.assert_array_equal(
        tpatches.extract_patches(_t(img), got, k).numpy(),
        tpatches.extract_patches_grid(_t(img), k, inclusive=True).numpy())


@pytest.mark.parametrize("color", [True, False])
def test_load_video_frames_equals_jax(tmp_path, color):
    from PIL import Image

    frames = (make_frames(4, 12, 10) * 255).astype(np.uint8)
    path = str(tmp_path / "clip.gif")
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=40,
                 loop=0)
    want = np.asarray(jdata.load_video_frames(path, is_color=color))
    got = tdata.load_video_frames(path, is_color=color, device="cpu")
    assert got.dtype == torch.float32
    assert got.shape == ((4, 12, 10, 3) if color else (4, 12, 10))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    two = tdata.load_video_frames(path, max_frames=2, is_color=color,
                                  dtype=F64, device="cpu")
    np.testing.assert_array_equal(two.numpy(), np.asarray(
        jdata.load_video_frames(path, max_frames=2, is_color=color,
                                dtype=jnp.float64)))
    assert two.shape[0] == 2 and two.dtype == F64
    with pytest.raises(ValueError, match="max_frames"):
        tdata.load_video_frames(path, max_frames=0, device="cpu")
    # the learner reads the file through the same loader
    rec = tvideo.VideoDictionaryLearner(path=path, n_components=3,
                                        patch_size=3, is_color=color,
                                        max_frames=3, device="cpu")
    assert torch.equal(rec.frames, got[:3])
    assert rec.is_color == color and rec.W.shape == (27 if color else 9, 3)


@pytest.mark.parametrize("subsample", [False, True])
@pytest.mark.parametrize("use_stopping", [True, False])
def test_train_video_dict_matches_jax(use_stopping, subsample):
    frames = make_frames(4, 20, 24)
    k, r, d, num, inner, epochs = 4, 5, 48, 18, 4, 2
    W = RNG.random((d, r))
    js = jinit_state(jax.random.key(7), d, r, dtype=jnp.float64, W=W)
    ts = init_state(7, d, r, dtype=F64, W=W, device="cpu")
    kw = dict(num_patches=num, inner_iterations=inner, batch_size=6,
              patch_size=k, epochs=epochs, alpha=0.2, beta=0.9,
              use_stopping=use_stopping, subsample=subsample)
    draws = replay_video_draws(js.key, frames.shape[1:3], k, r, 4 * epochs,
                               num, inner, 6 if subsample else None)
    js1 = jvideo.train_video_dict(js, jnp.asarray(frames), **kw)
    ts1 = tvideo.train_video_dict(ts, _t(frames), draws=draws, **kw)
    for name in ("W", "A", "B"):
        np.testing.assert_allclose(getattr(ts1, name).numpy(),
                                   np.asarray(getattr(js1, name)),
                                   rtol=1e-8, atol=1e-12, err_msg=name)
    assert ts1.t == float(js1.t) == 4 * epochs * inner
    # float32 on the same draws: 1e-4 relative to the float64 run (fixed
    # sweeps: the stop may end a float32 tile one sweep apart)
    if not use_stopping:
        f32 = [(c, [(i, h.float()) for i, h in steps]) for c, steps in draws]
        ts32 = tvideo.train_video_dict(
            init_state(7, d, r, dtype=torch.float32, W=W, device="cpu"),
            _t(frames).float(), draws=f32, **kw)
        rel = float((ts32.W.double() - ts1.W).norm() / ts1.W.norm())
        assert rel < 1e-4, rel


def _masked_err(o, img):
    mask = o.sum(axis=-1) > 0 if o.ndim == 3 else o > 0
    return np.linalg.norm((o - img)[mask]) / np.linalg.norm(img[mask])


@pytest.mark.parametrize("color", [True, False])
def test_video_learner_trains_from_its_generator_and_reconstructs(color):
    frames = make_frames(6, 24, 24, color=color)
    rec = tvideo.VideoDictionaryLearner(
        frames=frames, n_components=12, sub_iterations=5, num_patches=60,
        patch_size=5, dtype=F64, seed=1, device="cpu")
    assert rec.is_color == color
    W0 = rec.W.clone()
    out0 = rec.reconstruct_frame(2, stride=2, alpha=0.05).numpy()
    W = rec.train_dict(epochs=3)
    assert W.shape == ((75 if color else 25), 12) and (W >= 0).all()
    assert rec.state.t == 6 * 3 * 5 and not torch.equal(W, W0)
    out = rec.reconstruct_frame(2, stride=2, alpha=0.05).numpy()
    assert out.shape == frames[2].shape and np.isfinite(out).all()
    assert _masked_err(out, frames[2]) < _masked_err(out0, frames[2])
    # a second learner from the same seed draws the same patches
    again = tvideo.VideoDictionaryLearner(
        frames=frames, n_components=12, sub_iterations=5, num_patches=60,
        patch_size=5, dtype=F64, seed=1, device="cpu")
    assert torch.equal(again.train_dict(epochs=3), W)
    with pytest.raises(ValueError, match="path or frames"):
        tvideo.VideoDictionaryLearner(device="cpu")
    with pytest.raises(ValueError, match="coder"):
        tvideo.VideoDictionaryLearner(frames=frames, coder="lasso",
                                      device="cpu")


def spin_stack(m=3, n=18, seed=5):
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([1.0, -1.0]), (m, n, n))


@pytest.mark.parametrize("fast", [False, True])
def test_stacked_image_path_matches_jax(fast):
    stack = (spin_stack() + 1.0) / 2.0
    m, k, r, num, inner = 3, 4, 5, 15, 3
    kw = dict(data=stack, is_stack=True, n_components=r, iterations=2 * m + 1,
              sub_iterations=inner, num_patches=num, patch_size=k,
              alpha=0.1, fast=fast, seed=6)
    jrec = jimage.ImageReconstructor(dtype=jnp.float64, **kw)
    trec = timage.ImageReconstructor(dtype=F64, device="cpu", **kw)
    # grey by construction, whatever is_color says
    assert trec.is_stack and not trec.is_color
    assert trec.W.shape == jrec.W.shape == (k * k, r)
    W0 = RNG.random((k * k, r))
    jrec.W, trec.W = W0, W0
    # iterations // m = 2 passes over the stack
    draws = replay_video_draws(jrec.state.key, stack.shape[1:], k, r, 2 * m,
                               num, inner)
    Wj = jrec.train_dict()
    Wt = trec.train_dict(draws=draws)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=1e-8,
                               atol=1e-12)
    assert trec.state.t == float(jrec.state.t) == 2 * m * inner
    with pytest.raises(ValueError, match="draws"):
        trec.train_dict(draws=draws, checkpoint_path="x", checkpoint_every=1)


def test_stacked_image_path_loads_checks_and_resumes(tmp_path):
    spins = spin_stack(m=4, n=16)
    path = str(tmp_path / "trajectory.npy")
    np.save(path, spins)
    kw = dict(path=path, is_stack=True, n_components=4, iterations=13,
              sub_iterations=3, num_patches=10, patch_size=4, dtype=F64,
              seed=2, device="cpu")
    rec = timage.ImageReconstructor(**kw)
    # the +-1 -> [0, 1] mapping of load_image's is_matrix transform
    np.testing.assert_array_equal(rec.data.numpy(), (spins + 1.0) / 2.0)
    np.testing.assert_array_equal(
        rec.data.numpy(),
        np.asarray(jimage.ImageReconstructor(
            path=path, is_stack=True, n_components=4, patch_size=4,
            dtype=jnp.float64).data))
    Wa = rec.train_dict()
    assert rec.state.t == 3 * 4 * 3      # 13 // 4 = 3 passes of 4 matrices
    # a checkpoint unit is one pass: t advances by sub_iterations * m
    ckpt = str(tmp_path / "stack.npz")
    part = timage.ImageReconstructor(**kw)
    part.iterations = 8                  # two passes, then interrupted
    part.train_dict(checkpoint_path=ckpt, checkpoint_every=1)
    assert part.state.t == 2 * 4 * 3
    resumed = timage.ImageReconstructor(**kw)
    Wc = resumed.train_dict(checkpoint_path=ckpt, checkpoint_every=2,
                            resume=True)
    torch.testing.assert_close(Wa, Wc, rtol=0, atol=0)
    assert resumed.state.t == 36.0
    for bad in (spins[0], spins[None]):
        with pytest.raises(ValueError, match=r"\(m, H, W\)"):
            timage.ImageReconstructor(data=bad, is_stack=True, device="cpu")
    # fewer iterations than matrices still make one pass
    one = timage.ImageReconstructor(**dict(kw, iterations=1))
    one.train_dict()
    assert one.state.t == 4 * 3

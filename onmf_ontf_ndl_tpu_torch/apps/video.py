"""Streaming video dictionary learning, in PyTorch.

Counterpart of ``onmf_ontf_ndl_tpu/apps/video.py``. Frames arrive as a
stream; each frame gives ``num_patches`` random patches and one
warm-started round of the online-NMF loop (the Markovian-data setting),
the state threading from frame to frame. The JAX package's ``lax.scan``
over frames becomes one round function (the visited frame, its corners,
its patches, the inner steps), captured once as a CUDA graph on the card
and replayed a frame at a time (``models/onmf.py::_run_rounds``); every
step runs the coder kernel (the early stop, or fixed sweeps with
``use_stopping=False``) and the dictionary kernel.
``ImageReconstructor(is_stack=True)`` trains through
:func:`train_video_dict` too.
"""

from __future__ import annotations

import torch

from onmf_ontf_ndl_tpu_torch.data.video import load_video_frames
from onmf_ontf_ndl_tpu_torch.models.onmf import (_check_modes, _round_spec,
                                                 _run_rounds)
from onmf_ontf_ndl_tpu_torch.models.state import (
    OnmfState, entry_device, init_state, make_generator)
from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend
from onmf_ontf_ndl_tpu_torch.ops.patches import (extract_patches,
                                                 random_patch_corners)
from onmf_ontf_ndl_tpu_torch.utils.profiling import spanned

__all__ = ["VideoDictionaryLearner", "train_video_dict"]


def train_video_dict(
    state: OnmfState,
    frames: torch.Tensor,
    *,
    num_patches: int,
    inner_iterations: int,
    batch_size: int,
    patch_size: int,
    epochs: int = 1,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float = 0.01,
    use_stopping: bool = True,
    backend: str = "auto",
    subsample: bool = False,
    coder: str = "bcd",
    draws=None,
    capture: bool = True,
) -> OnmfState:
    """Stream over the frames (F, H, W[, C]) in order, ``epochs`` passes,
    one warm-started online-NMF round per frame: ``num_patches`` corners
    from the state's generator, then ``inner_iterations`` steps of the
    shared loop with ``dict_from="stale"`` and no code tracking. Visit v
    takes frame ``v % F``, picked on the device by the round counter.

    ``draws`` (tests): per visited frame, in the order of the visits, a
    pair ``(corners, inner)`` as in ``apps.image.train_image_dict``:
    ``corners = (a, b)`` and ``inner`` the inner loop's ``(idx, H0)``
    draws (``idx`` the batch indices with ``subsample``, else None).
    ``capture=False``: the rounds in a Python loop, as on the CPU.
    """
    _check_modes("stale", coder)
    backend = resolve_backend(backend, frames)
    k = patch_size
    F = frames.shape[0]

    def round_fn(rb, gen, ctx):
        frame = frames.index_select(0, rb.rnd % F)[0]
        if ctx.draw is not None:
            corners = tuple(torch.as_tensor(c, device=frames.device)
                            for c in ctx.draw[0])
        else:
            corners = random_patch_corners(gen, frames.shape[1:3], k,
                                           num_patches, device=frames.device)
        ctx.steps(extract_patches(frame, corners, k))

    spec = _round_spec(num_patches, inner_iterations, batch_size, subsample,
                       alpha, sub_iter, stopping_diff if use_stopping
                       else None, False, "stale", backend, coder)
    state, _, _, _ = _run_rounds(
        state, None, spec, rounds=epochs * F, iterations=inner_iterations,
        beta=beta, round_fn=round_fn, gen=state.gen,
        app=("video", k, num_patches), reads=(frames,),
        host_read=draws is not None, draws=draws, capture=capture)
    return state


class VideoDictionaryLearner:
    """Streaming learner over a GIF or video; reconstructs single frames
    through the image path's ``reconstruct``. ``device`` places the frames
    and the state."""

    def __init__(
        self,
        path: str | None = None,
        frames=None,
        n_components: int = 100,
        sub_iterations: int = 10,
        num_patches: int = 200,
        batch_size: int = 20,
        patch_size: int = 7,
        is_color: bool = True,
        alpha: float | None = None,
        beta: float | None = None,
        max_frames: int | None = None,
        fast: bool = False,
        coder: str = "bcd",
        subsample: bool = False,
        seed: int = 0,
        device="cuda",
        dtype=torch.float32,
    ):
        _check_modes("stale", coder)
        self.device = entry_device(device)
        if frames is None:
            if path is None:
                raise ValueError("provide path or frames")
            frames = load_video_frames(path, max_frames=max_frames,
                                       is_color=is_color, dtype=dtype,
                                       device=self.device)
        self.frames = torch.as_tensor(frames, dtype=dtype, device=self.device)
        self.is_color = self.frames.dim() == 4
        self.n_components = n_components
        self.sub_iterations = sub_iterations
        self.num_patches = num_patches
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.alpha = 0.0 if alpha is None else float(alpha)
        self.beta = 1.0 if beta is None else float(beta)
        self.fast = fast
        self.coder = coder
        # batch_size only takes effect with subsample=True (otherwise
        # every inner step trains on all num_patches columns)
        self.subsample = subsample
        self.dtype = dtype
        d = (3 if self.is_color else 1) * patch_size**2
        self.state = init_state(seed, d, n_components, device=self.device,
                                dtype=dtype)

    @property
    def W(self):
        return self.state.W

    @spanned("train.call")
    def train_dict(self, epochs: int = 1):
        self.state = train_video_dict(
            self.state, self.frames,
            num_patches=self.num_patches,
            inner_iterations=self.sub_iterations,
            batch_size=self.batch_size,
            patch_size=self.patch_size,
            epochs=epochs, alpha=self.alpha, beta=self.beta,
            use_stopping=not self.fast,
            coder=self.coder, subsample=self.subsample,
        )
        return self.state.W

    def reconstruct_frame(self, index: int, stride: int = 1,
                          alpha: float = 1.0):
        from onmf_ontf_ndl_tpu_torch.apps.image import reconstruct

        return reconstruct(
            self.frames[index], self.state.W, make_generator(31, self.device),
            patch_size=self.patch_size, stride=stride, alpha=alpha,
            method=self.coder,
        )

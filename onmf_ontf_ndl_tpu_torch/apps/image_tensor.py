"""Colour-image dictionary learning on (k^2, 3, n) patch tensors via ONTF,
in PyTorch.

Counterpart of ``onmf_ontf_ndl_tpu/apps/image_tensor.py``: per outer
iteration, random patches are gathered into a (k^2, 3, n) tensor (or
(k^2, n, 1) for a grey image), mode-unfolded and fed through the online
training loop. Modes:

- ``mode=0, joint=False``: marginal spatial dictionary, d = k^2;
- ``mode=1, joint=False``: channel dictionary, d = 3;
- ``mode=2, joint=True``: joint colour dictionary, d = 3 k^2 (the
  reference driver's configuration).

The coder defaults to ``alpha=2`` and ``coder="exact"`` (FISTA with at
least 100 iterations, :func:`~onmf_ontf_ndl_tpu_torch.models.ontf.resolve_tensor_coder`),
in training and in reconstruction; on a CUDA image it runs the FISTA
kernel.
"""

from __future__ import annotations

import torch

from onmf_ontf_ndl_tpu_torch.data.images import (downscale_local_mean,
                                                 load_image)
from onmf_ontf_ndl_tpu_torch.models.onmf import (_check_modes, _round_spec,
                                                 _run_rounds)
from onmf_ontf_ndl_tpu_torch.models.ontf import resolve_tensor_coder
from onmf_ontf_ndl_tpu_torch.models.state import (
    OnmfState, entry_device, init_state, make_generator)
from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend
from onmf_ontf_ndl_tpu_torch.ops.patches import (extract_patches,
                                                 random_patch_corners)
from onmf_ontf_ndl_tpu_torch.ops.unfold import unfold
from onmf_ontf_ndl_tpu_torch.utils.profiling import spanned

__all__ = ["ImageReconstructorTensor", "unfolded_dim"]


def unfolded_dim(k: int, num_patches: int, mode: int, joint: bool,
                 channels: int = 3) -> int:
    """Feature dimension of the mode-unfolded patch tensor: (k^2, 3, n) for
    colour, (k^2, n, 1) for grey (the reference's layouts)."""
    shape = ((k * k, channels, num_patches) if channels == 3
             else (k * k, num_patches, 1))
    if joint:
        rest = 1
        for i, s in enumerate(shape):
            if i != mode:
                rest *= s
        return rest
    return shape[mode]


def _train_tensor(
    state: OnmfState,
    img: torch.Tensor,
    *,
    outer_iterations: int,
    num_patches: int,
    inner_iterations: int,
    batch_size: int,
    patch_size: int,
    mode: int,
    joint: bool,
    alpha: float,
    beta: float,
    sub_iter: int,
    stopping_diff: float = 0.01,
    use_stopping: bool = True,
    backend: str = "auto",
    subsample: bool = True,
    coder: str = "bcd",
    draws=None,
    capture: bool = True,
) -> OnmfState:
    """Streaming tensor trainer: each outer iteration samples
    ``num_patches`` random patches, unfolds their tensor along ``mode``
    (transposed when ``joint``) and runs ``inner_iterations`` online steps;
    one outer iteration is a round of ``models/onmf.py::_run_rounds``,
    captured once as a CUDA graph on the card and replayed.

    ``draws`` (tests): per outer iteration a pair ``(corners, inner)``,
    ``corners = (a, b)`` and ``inner`` the inner loop's ``(idx, H0)``
    draws, replacing the generator. ``capture=False``: the rounds in a
    Python loop, as on the CPU.
    """
    _check_modes("stale", coder)
    backend = resolve_backend(backend, img)
    k = patch_size

    def round_fn(rb, gen, ctx):
        if ctx.draw is not None:
            corners = tuple(torch.as_tensor(c, device=img.device)
                            for c in ctx.draw[0])
        else:
            corners = random_patch_corners(gen, img.shape[:2], k,
                                           num_patches, device=img.device)
        X = extract_patches(img, corners, k)
        if img.dim() == 3:                                  # (k^2, 3, n)
            T = torch.movedim(X.T.reshape(num_patches, k * k, 3), 0, 2)
        else:                                               # (k^2, n, 1)
            T = X[:, :, None]
        Xu = unfold(T, mode)
        ctx.steps(Xu.T if joint else Xu)

    channels = 3 if img.dim() == 3 else 1
    width = k * k * channels * num_patches // unfolded_dim(
        k, num_patches, mode, joint, channels)     # the columns of ctx.steps
    spec = _round_spec(width, inner_iterations, batch_size, subsample,
                       alpha, sub_iter, stopping_diff if use_stopping
                       else None, False, "stale", backend, coder)
    state, _, _, _ = _run_rounds(
        state, None, spec, rounds=outer_iterations,
        iterations=inner_iterations, beta=beta, round_fn=round_fn,
        gen=state.gen, app=("tensor", k, num_patches, mode, joint),
        reads=(img,), host_read=draws is not None, draws=draws,
        capture=capture)
    return state


class ImageReconstructorTensor:
    """Driver shell mirroring the reference's ``Image_Reconstructor_tensor``.
    ``device`` places the image and the state."""

    def __init__(
        self,
        path: str | None = None,
        data=None,
        n_components: int = 100,
        iterations: int = 50,
        sub_iterations: int = 20,
        batch_size: int = 20,
        block_iterations: int = 20,
        num_patches: int = 1000,
        sub_num_patches: int = 10000,
        downscale_factor: int = 2,
        patch_size: int = 7,
        learn_joint_dict: bool = False,
        is_matrix: bool = False,
        is_color: bool = True,
        alpha: float | None = None,
        beta: float | None = None,
        fast: bool = False,
        coder: str = "exact",
        coder_sub_iter: int | None = None,
        seed: int = 0,
        device="cuda",
        dtype=torch.float32,
    ):
        self.device = entry_device(device)
        if data is None:
            if path is None:
                raise ValueError("provide path or data")
            data = load_image(path, is_matrix=is_matrix, is_color=is_color,
                              dtype=dtype, device=self.device)
        self.data = torch.as_tensor(data, dtype=dtype, device=self.device)
        self.path = path
        self.n_components = n_components
        self.iterations = iterations
        self.sub_iterations = sub_iterations
        self.block_iterations = block_iterations
        self.num_patches = num_patches
        # the reference's knob of its unused second-factor path
        self.sub_num_patches = sub_num_patches
        self.downscale_factor = downscale_factor
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.learn_joint_dict = learn_joint_dict
        self.alpha = 2.0 if alpha is None else float(alpha)
        self.beta = 1.0 if beta is None else float(beta)
        self.fast = fast
        self.coder = coder
        self._coder_method, self.coder_sub_iter = resolve_tensor_coder(
            coder, block_iterations, coder_sub_iter)
        self.seed = seed
        self.dtype = dtype
        self.state = None
        self.W = None

    @spanned("train.call")
    def train_dict(self, mode: int, learn_joint_dict: bool | None = None,
                   draws=None):
        """Learn the mode-``mode`` dictionary from a fresh state seeded with
        ``seed``; returns W. ``draws`` as in :func:`_train_tensor`."""
        joint = (self.learn_joint_dict if learn_joint_dict is None
                 else learn_joint_dict)
        channels = 3 if self.data.dim() == 3 else 1
        d = unfolded_dim(self.patch_size, self.num_patches, mode, joint,
                         channels)
        self.state = init_state(self.seed, d, self.n_components,
                                device=self.device, dtype=self.dtype)
        self.state = _train_tensor(
            self.state, self.data,
            outer_iterations=self.iterations,
            num_patches=self.num_patches,
            inner_iterations=self.sub_iterations,
            batch_size=self.batch_size,
            patch_size=self.patch_size,
            mode=mode, joint=joint,
            alpha=self.alpha, beta=self.beta,
            sub_iter=self.coder_sub_iter,
            use_stopping=not self.fast,
            coder=self._coder_method,
            draws=draws,
        )
        self.W = self.state.W
        return self.W

    def _image(self, path, data, is_color: bool) -> torch.Tensor:
        if data is None:
            data = load_image(path or self.path, is_color=is_color,
                              dtype=self.dtype, device=self.device)
        return torch.as_tensor(data, dtype=self.dtype, device=self.device)

    @spanned("recon.job")
    def reconstruct_image_color(self, path: str | None = None, data=None,
                                recons_resolution: int = 1,
                                alpha: float = 1.0):
        """Colour reconstruction on a strided grid from the joint (3k^2, r)
        dictionary, coder alpha 1."""
        from onmf_ontf_ndl_tpu_torch.apps.image import reconstruct

        k = self.patch_size
        if self.W is None or self.W.shape[0] != 3 * k * k:
            raise ValueError(
                "color reconstruction needs a trained joint (3k^2, r) "
                "dictionary (train with mode=2, learn_joint_dict=True)")
        return reconstruct(
            self._image(path, data, True), self.W,
            make_generator(29, self.device), patch_size=k,
            stride=recons_resolution, alpha=alpha,
            sub_iter=self.coder_sub_iter, method=self._coder_method)

    def reconstruct_image(self, path: str | None = None, data=None,
                          downscale_factor: int | None = None,
                          patch_size: int | None = None):
        """Grey full-grid reconstruction from a spatial (k^2, r) dictionary
        (mode 0, not joint), with the instance's coder alpha."""
        from onmf_ontf_ndl_tpu_torch.apps.image import reconstruct

        if downscale_factor is None:
            downscale_factor = self.downscale_factor
        k = patch_size or self.patch_size
        if self.W is None or self.W.shape[0] != k * k:
            raise ValueError(
                "grayscale reconstruction needs a (k^2, r) spatial "
                "dictionary (train with mode=0, learn_joint_dict=False)")
        data = downscale_local_mean(self._image(path, data, False),
                                    downscale_factor)
        return reconstruct(
            data, self.W, make_generator(29, self.device), patch_size=k,
            alpha=self.alpha, full_grid=True, sub_iter=self.coder_sub_iter,
            method=self._coder_method)

    def display_second_dictionary(self, H, save_path: str | None = None,
                                  show: bool = False):
        """Heatmap of the second (channel) factor (``utils/viz.py``)."""
        from onmf_ontf_ndl_tpu_torch.utils.viz import display_second_dictionary

        return display_second_dictionary(
            H, patch_size=self.patch_size, save_path=save_path, show=show)

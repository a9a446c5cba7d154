"""Image dictionary learning and reconstruction (the canonical ONMF
pipeline), in PyTorch.

Counterpart of ``onmf_ontf_ndl_tpu/apps/image.py``. Training is a loop of
rounds, each random-patch draws and the inner online-NMF steps (the JAX
package's outer ``lax.scan``; on the card one round is captured as a CUDA
graph and replayed, ``models/onmf.py::_run_rounds``); reconstruction codes
every grid patch in one batched coder call and paints with an overlap
average.

Parity notes (as in the JAX module): training patches come from the
full-resolution image; colour reconstruction codes with ``alpha=1`` and
``sub_iter=10``; reconstruction runs fixed sweeps by default.
"""

from __future__ import annotations

import dataclasses

import torch

from onmf_ontf_ndl_tpu_torch.data.images import (downscale_local_mean,
                                                 load_image)
from onmf_ontf_ndl_tpu_torch.models.onmf import (_check_modes, _round_spec,
                                                 _run_rounds, rank_generator)
from onmf_ontf_ndl_tpu_torch.models.state import (
    OnmfState, entry_device, init_state, make_generator)
from onmf_ontf_ndl_tpu_torch.ops.coder import nonneg_code
from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend
from onmf_ontf_ndl_tpu_torch.ops.patches import (
    extract_patches,
    extract_patches_grid,
    overlap_average_grid,
    random_patch_corners,
)
from onmf_ontf_ndl_tpu_torch.utils.profiling import span, spanned

__all__ = ["ImageReconstructor", "train_image_dict", "reconstruct"]

def train_image_dict(
    state: OnmfState,
    img: torch.Tensor,
    *,
    outer_iterations: int,
    num_patches: int,
    inner_iterations: int,
    batch_size: int,
    patch_size: int,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    use_stopping: bool = True,
    stopping_diff: float = 0.01,
    dict_from: str = "stale",
    backend: str = "auto",
    subsample: bool = False,
    coder: str = "bcd",
    draws=None,
    group=None,
    capture: bool = True,
) -> OnmfState:
    """Streaming trainer: each outer iteration samples ``num_patches``
    random patches and runs ``inner_iterations`` online-NMF steps on them
    (the reference's two-level loop).

    One outer iteration is a round of ``models/onmf.py::_run_rounds``: on
    the card it is captured once as a CUDA graph and replayed a round at a
    time. ``draws`` (tests): per outer iteration a pair ``(corners,
    inner)``, ``corners = (a, b)`` and ``inner`` the inner loop's ``(idx,
    H0)`` draws, replacing the generator. ``group``: a process group; each
    rank draws its own patches (from its rank generator) and the inner
    steps sum their statistics over the group. ``capture=False`` (tests and
    the card's comparisons) runs the rounds in a Python loop.
    """
    _check_modes(dict_from, coder)
    backend = resolve_backend(backend, img)
    k = patch_size
    gen = rank_generator(state.gen, group) if draws is None else state.gen

    def round_fn(rb, gen, ctx):
        if ctx.draw is not None:
            corners = tuple(torch.as_tensor(c, device=img.device)
                            for c in ctx.draw[0])
        else:
            corners = random_patch_corners(gen, img.shape[:2], k,
                                           num_patches, device=img.device)
        ctx.steps(extract_patches(img, corners, k))

    spec = _round_spec(num_patches, inner_iterations, batch_size, subsample,
                       alpha, sub_iter, stopping_diff if use_stopping
                       else None, False, dict_from, backend, coder, group)
    state, _, _, _ = _run_rounds(
        state, None, spec, rounds=outer_iterations,
        iterations=inner_iterations, beta=beta, round_fn=round_fn, gen=gen,
        app=("image", k, num_patches), reads=(img,),
        host_read=draws is not None, draws=draws, capture=capture)
    return state


def reconstruct(
    img: torch.Tensor,
    W: torch.Tensor,
    generator: torch.Generator,
    *,
    patch_size: int,
    stride: int = 1,
    alpha: float = 1.0,
    sub_iter: int = 10,
    use_stopping: bool = False,
    stopping_diff: float = 0.01,
    full_grid: bool = False,
    method: str = "bcd",
    backend: str = "auto",
) -> torch.Tensor:
    """Reconstruct an image from its dictionary: code every grid patch at
    once (H0 drawn from ``generator``) and overlap-average.

    ``full_grid=True`` uses every patch position (the grey path);
    otherwise a strided grid exclusive of the last start. Fixed sweeps by
    default: the batched early stop over the whole patch matrix only ever
    runs fewer sweeps. Spans: ``recon.extract``, ``recon.code`` and
    ``recon.paint`` (W H and the overlap average).
    """
    k = patch_size
    with span("recon.extract", on=img):
        X = extract_patches_grid(img, k, stride, inclusive=full_grid)
    with span("recon.code", on=img):
        H = nonneg_code(
            X, W, generator=generator, alpha=alpha, sub_iter=sub_iter,
            stopping_diff=(stopping_diff if use_stopping else None),
            method=method, backend=backend,
        )
    with span("recon.paint", on=img):
        return overlap_average_grid(W @ H, k, stride, tuple(img.shape),
                                    inclusive=full_grid)


class ImageReconstructor:
    """Convenience shell over the pipeline; constructor knobs mirror the
    reference's ``Image_Reconstructor``. ``device`` places the image and
    the state."""

    def __init__(
        self,
        path: str | None = None,
        data=None,
        n_components: int = 100,
        iterations: int = 200,
        sub_iterations: int = 20,
        num_patches: int = 1000,
        batch_size: int = 20,
        downscale_factor: int = 2,
        patch_size: int = 7,
        is_matrix: bool = False,
        is_stack: bool = False,
        is_color: bool = True,
        alpha: float | None = None,
        beta: float | None = None,
        fast: bool = False,
        subsample: bool = False,
        coder: str = "bcd",
        seed: int = 0,
        device="cuda",
        dtype=torch.float32,
    ):
        _check_modes("stale", coder)
        self.device = entry_device(device)
        if data is None:
            if path is None:
                raise ValueError("ImageReconstructor: provide path or data")
            if is_stack:
                # a stack of matrices, e.g. a saved Ising trajectory: the
                # +-1 -> [0, 1] mapping is load_image's is_matrix transform
                data = load_image(path, is_matrix=True, is_color=False,
                                  dtype=dtype, device=self.device)
            else:
                data = load_image(path, is_matrix=is_matrix,
                                  is_color=is_color, dtype=dtype,
                                  device=self.device)
        self.data = torch.as_tensor(data, dtype=dtype, device=self.device)
        self.is_stack = is_stack
        if is_stack:
            if self.data.dim() != 3:
                raise ValueError("is_stack expects a (m, H, W) array")
            # matrix stacks are grey by construction: d = k^2
            is_color = False
        self.path = path
        self.n_components = n_components
        self.iterations = iterations
        self.sub_iterations = sub_iterations
        self.num_patches = num_patches
        self.batch_size = batch_size
        self.downscale_factor = downscale_factor
        self.patch_size = patch_size
        self.is_matrix = is_matrix
        self.is_color = is_color
        self.alpha = 0.0 if alpha is None else float(alpha)
        self.beta = 1.0 if beta is None else float(beta)
        self.fast = fast
        self.subsample = subsample
        self.coder = coder
        self.dtype = dtype
        d = (3 if is_color else 1) * patch_size**2
        self.state = init_state(seed, d, n_components, device=self.device,
                                dtype=dtype)
        self.A_recons = None

    @property
    def W(self):
        return self.state.W

    @W.setter
    def W(self, value):
        self.state = dataclasses.replace(
            self.state,
            W=torch.as_tensor(value, dtype=self.dtype, device=self.device))

    @spanned("train.call")
    def train_dict(self, checkpoint_path: str | None = None,
                   checkpoint_every: int = 0, resume: bool = False,
                   draws=None):
        """Run the full streaming training; returns the dictionary (d, r).

        ``checkpoint_path`` + ``checkpoint_every=N`` write a full-state
        checkpoint after every N outer iterations; chunked training equals
        the uninterrupted run (the checkpoint carries the generator state
        and the schedule counter). ``resume=True`` restarts from the
        checkpoint and runs only the remaining outer iterations (each
        advances ``state.t`` by ``sub_iterations``).

        With ``is_stack=True`` the outer loop streams over the stacked
        matrices, one warm-started round per matrix, in
        ``max(1, iterations // m)`` passes (``iterations`` approximates the
        total number of rounds); a checkpoint unit is one pass, which
        advances ``state.t`` by ``sub_iterations * m``.

        ``draws`` (tests): the draws of the whole run, as
        ``train_image_dict`` or ``train_video_dict`` take them; not with a
        checkpoint.
        """
        if (checkpoint_path or resume) and checkpoint_every <= 0:
            raise ValueError(
                "checkpoint_path/resume require checkpoint_every > 0 "
                "(otherwise the request would be silently ignored and "
                "training restarted from scratch)")
        if draws is not None and checkpoint_path:
            raise ValueError("draws cover one uninterrupted run: no "
                             "checkpoint_path with them")

        if self.is_stack:
            from onmf_ontf_ndl_tpu_torch.apps.video import train_video_dict

            m = self.data.shape[0]
            total = max(1, self.iterations // m)
            t_per_unit = self.sub_iterations * m

            def run(st, units):
                return train_video_dict(
                    st, self.data,
                    num_patches=self.num_patches,
                    inner_iterations=self.sub_iterations,
                    batch_size=self.batch_size,
                    patch_size=self.patch_size,
                    epochs=units,
                    alpha=self.alpha, beta=self.beta,
                    use_stopping=not self.fast,
                    coder=self.coder, draws=draws,
                )
        else:
            total = self.iterations
            t_per_unit = self.sub_iterations

            def run(st, units):
                return train_image_dict(
                    st, self.data,
                    outer_iterations=units,
                    num_patches=self.num_patches,
                    inner_iterations=self.sub_iterations,
                    batch_size=self.batch_size,
                    patch_size=self.patch_size,
                    alpha=self.alpha, beta=self.beta,
                    use_stopping=not self.fast,
                    subsample=self.subsample,
                    coder=self.coder, draws=draws,
                )

        if checkpoint_path and checkpoint_every > 0:
            from onmf_ontf_ndl_tpu_torch.utils.checkpoint import (
                checkpoint_exists, load_state, save_state)

            done = 0
            if resume and checkpoint_exists(checkpoint_path):
                self.state = load_state(checkpoint_path, device=self.device,
                                        dtype=self.dtype)
                done = int(round(float(self.state.t))) // t_per_unit
            while done < total:
                chunk = min(checkpoint_every, total - done)
                self.state = run(self.state, chunk)
                done += chunk
                save_state(checkpoint_path, self.state)
        else:
            self.state = run(self.state, total)
        return self.state.W

    def extract_patches(self, num_patches: int | None = None, seed: int = 23):
        """Sample a (d, n) random-patch matrix from the training image."""
        n = num_patches or self.num_patches
        corners = random_patch_corners(
            make_generator(seed, self.device), self.data.shape[:2],
            self.patch_size, n, device=self.device)
        return extract_patches(self.data, corners, self.patch_size)

    def save_patches(self, filename: str, num_patches: int | None = None):
        """Sample and save a patch matrix to ``filename`` (.npy)."""
        import numpy as np

        np.save(filename, self.extract_patches(num_patches).cpu().numpy())
        return filename

    def display_dictionary(self, W=None, save_path: str | None = None,
                           show: bool = False):
        """Dictionary patch grid (``utils/viz.py``)."""
        from onmf_ontf_ndl_tpu_torch.utils.viz import display_dictionary

        return display_dictionary(
            W if W is not None else self.W, self.patch_size,
            is_color=self.is_color, save_path=save_path, show=show)

    @spanned("recon.job")
    def reconstruct_image_color(self, path: str | None = None, data=None,
                                recons_resolution: int = 1,
                                alpha: float = 1.0):
        """Colour reconstruction on a strided grid."""
        if data is None:
            data = load_image(path or self.path, is_matrix=self.is_matrix,
                              is_color=True, dtype=self.dtype,
                              device=self.device)
        self.A_recons = reconstruct(
            torch.as_tensor(data, dtype=self.dtype, device=self.device),
            self.state.W, make_generator(17, self.device),
            patch_size=self.patch_size, stride=recons_resolution,
            alpha=alpha, method=self.coder,
        )
        return self.A_recons

    def reconstruct_image(self, path: str | None = None, data=None,
                          downscale_factor: int | None = None,
                          patch_size: int | None = None,
                          alpha: float = 0.0):
        """Grey full-grid reconstruction. The coder runs with ``alpha=0``
        whatever the training alpha, as the reference's grey path does."""
        if downscale_factor is None:
            downscale_factor = self.downscale_factor
        k = patch_size or self.patch_size
        if data is None:
            data = load_image(path or self.path, is_matrix=self.is_matrix,
                              is_color=False, dtype=self.dtype,
                              device=self.device)
        data = downscale_local_mean(
            torch.as_tensor(data, dtype=self.dtype, device=self.device),
            downscale_factor)
        self.A_recons = reconstruct(
            data, self.state.W, make_generator(17, self.device),
            patch_size=k, alpha=alpha, full_grid=True, method=self.coder,
        )
        return self.A_recons

"""Faults of the colour tensor app's cells."""

from __future__ import annotations

from .step import half_batch, unchanged_state


def one_iteration_fewer(monkeypatch):
    """FISTA one iteration short of its fixed count: the kernels' wrapper
    (the card) and the plain coder (the CPU), where the training step and
    the reconstruction reach them."""
    from onmf_ontf_ndl_tpu_torch.models import onmf
    from onmf_ontf_ndl_tpu_torch.ops import coder
    from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel

    kernel, plain = coder_kernel.fista_sweeps, coder._fista_impl

    def sweeps(*a, sub_iter=10, **k):
        return kernel(*a, sub_iter=sub_iter - 1, **k)

    def impl(A, B, H0, alpha, stopping_diff, sub_iter, *a, **k):
        return plain(A, B, H0, alpha, stopping_diff, sub_iter - 1, *a, **k)

    monkeypatch.setattr(coder_kernel, "fista_sweeps", sweeps)
    monkeypatch.setattr(coder, "_fista_impl", impl)
    monkeypatch.setattr(onmf, "_fista_impl", impl)


def wrong_alpha(monkeypatch):
    """The coders' alphas swapped: training codes at the reconstruction's
    alpha 1, the reconstruction at the training's 2."""
    from onmf_ontf_ndl_tpu_torch.apps import image, image_tensor

    train, recon = image_tensor._train_tensor, image.reconstruct
    monkeypatch.setattr(image_tensor, "_train_tensor",
                        lambda *a, **k: train(*a, **{**k, "alpha": 1.0}))
    monkeypatch.setattr(image, "reconstruct",
                        lambda *a, **k: recon(*a, **{**k, "alpha": 2.0}))


def stop_loosened(monkeypatch):
    """FISTA's stop at ten times the configuration's change (0.1 for
    0.01): the tiles of the set-up's training stop early. The kernels'
    wrapper (the card) and the plain coder (the CPU)."""
    from onmf_ontf_ndl_tpu_torch.models import onmf
    from onmf_ontf_ndl_tpu_torch.ops import coder
    from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel

    kernel, plain = coder_kernel.fista_sweeps, coder._fista_impl

    def sweeps(A, B, H0, alpha=0.0, stopping_diff=0.01, **k):
        return kernel(A, B, H0, alpha, 10 * stopping_diff, **k)

    def impl(A, B, H0, alpha, stopping_diff, *a, **k):
        if stopping_diff is not None:
            stopping_diff = 10 * stopping_diff
        return plain(A, B, H0, alpha, stopping_diff, *a, **k)

    monkeypatch.setattr(coder_kernel, "fista_sweeps", sweeps)
    monkeypatch.setattr(coder, "_fista_impl", impl)
    monkeypatch.setattr(onmf, "_fista_impl", impl)


# The cell compares the set-up's one training call and the window's jobs,
# so the shared ``stale_weights`` (a fault of a training window's later
# calls) has nothing to show here.
CPU = {"recon": [one_iteration_fewer, stop_loosened, wrong_alpha,
                 unchanged_state, half_batch]}
CARD = {}

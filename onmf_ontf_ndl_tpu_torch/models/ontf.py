"""Online nonnegative tensor factorization (ONTF) by matricization.

Counterpart of ``onmf_ontf_ndl_tpu/models/ontf.py``: online NMF on a
mode-``m`` unfolding of the input tensor (transposed for a "joint"
dictionary over the complementary modes), through the same training loop
as :mod:`onmf_ontf_ndl_tpu_torch.models.onmf`. The coder solves the
reference's objective ``0.5|x - W h|^2 + alpha |h|_1`` (alpha 2, sklearn's
``transform_alpha`` default) with the policy of :func:`resolve_tensor_coder`.
"""

from __future__ import annotations

import torch

from onmf_ontf_ndl_tpu_torch.models.onmf import train_dict as _train_dict
from onmf_ontf_ndl_tpu_torch.models.state import (entry_device, init_state,
                                                  make_generator)
from onmf_ontf_ndl_tpu_torch.ops.unfold import unfold

__all__ = ["OnlineNTF", "resolve_tensor_coder"]


def resolve_tensor_coder(coder: str, knob: int,
                         coder_sub_iter: int | None) -> tuple[str, int]:
    """The tensor surface's coder policy (PARITY.md deviation #11), shared
    by :class:`OnlineNTF` and ``ImageReconstructorTensor``.

    ``coder="exact"`` (the default) is FISTA run towards convergence, with
    a floor of 100 iterations, in place of the reference's exact LARS
    solve; ``"bcd"`` / ``"fista"`` take a floor of 30. ``knob`` is the
    driver's sweep knob (``block_iterations`` / ``sub_iterations``),
    ``coder_sub_iter`` overrides the count. Returns ``(method, sub_iter)``
    with ``method`` the coder that runs (``"exact"`` maps to ``"fista"``).
    """
    method = "fista" if coder == "exact" else coder
    floor = 100 if coder == "exact" else 30
    sub_iter = (int(coder_sub_iter) if coder_sub_iter is not None
                else max(int(knob), floor))
    return method, sub_iter


class OnlineNTF:
    """Online NTF via mode unfolding; ``OnlineNTF(X, ...).train_dict_single()``
    returns ``(W, At, Bt, code)`` as the reference driver consumes it.
    ``device`` places the tensor and the state (the card by default; a CPU
    run passes ``device="cpu"``); ``seed`` or ``generator`` (on that
    device) seeds the random draws."""

    def __init__(
        self,
        X,
        n_components: int = 100,
        iterations: int = 500,
        sub_iterations: int = 10,
        batch_size: int = 20,
        ini_dict=None,
        ini_A=None,
        ini_B=None,
        history: float = 0.0,
        mode: int = 0,
        learn_joint_dict: bool = False,
        alpha: float | None = None,
        beta: float | None = None,
        subsample: bool = True,
        coder: str = "exact",
        coder_sub_iter: int | None = None,
        generator: torch.Generator | None = None,
        seed: int = 0,
        device="cuda",
        dtype=torch.float32,
    ):
        self.device = entry_device(device)
        self.X = torch.as_tensor(X, dtype=dtype, device=self.device)
        self.n_components = n_components
        self.iterations = iterations
        # coder iterations per step (the tensor driver's block_iterations)
        self.sub_iterations = sub_iterations
        self.batch_size = batch_size
        self.mode = mode
        self.learn_joint_dict = learn_joint_dict
        self.alpha = 2.0 if alpha is None else float(alpha)
        self.beta = 1.0 if beta is None else float(beta)
        self.subsample = subsample
        self.coder = coder
        self._coder_method, self.coder_sub_iter = resolve_tensor_coder(
            coder, sub_iterations, coder_sub_iter)
        self.dtype = dtype
        X_unfold = unfold(self.X, mode)
        self.X_unfold = X_unfold.T if learn_joint_dict else X_unfold
        if generator is None:
            generator = make_generator(seed, self.device)
        self.state = init_state(
            generator, self.X_unfold.shape[0], n_components,
            device=self.device, dtype=dtype, W=ini_dict, A=ini_A, B=ini_B,
            t=float(history))
        # passed through for the reference's contract; never accumulated
        self.code = torch.zeros((self.X.shape[1], n_components), dtype=dtype,
                                device=self.device)

    @property
    def history(self) -> float:
        return float(self.state.t)

    def joint_sparse_code_tensor(self, X, W):
        """Code unfolded data against W; returns H as samples x topics (the
        reference's transposed convention). H0 comes from a generator seeded
        by the batch width, so the result is deterministic."""
        from onmf_ontf_ndl_tpu_torch.ops.coder import nonneg_code

        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        W = torch.as_tensor(W, dtype=self.dtype, device=self.device)
        gen = make_generator(202 * 2**32 + X.shape[1], self.device)
        return nonneg_code(X, W, generator=gen, alpha=self.alpha,
                           sub_iter=self.coder_sub_iter, stopping_diff=0.01,
                           method=self._coder_method).T

    def train_dict_single(self, draws=None):
        """Learn the mode dictionary; returns ``(W, At, Bt, code)``.
        ``draws`` as in :func:`~onmf_ontf_ndl_tpu_torch.models.onmf.train_dict`."""
        self.state, _ = _train_dict(
            self.state, self.X_unfold,
            iterations=self.iterations, batch_size=self.batch_size,
            subsample=self.subsample, alpha=self.alpha, beta=self.beta,
            sub_iter=self.coder_sub_iter, stopping_diff=0.01,
            track_code=False, coder=self._coder_method, draws=draws,
        )
        st = self.state
        return st.W, st.A, st.B, self.code

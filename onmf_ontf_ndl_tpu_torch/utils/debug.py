"""Numerical-health checks.

Counterpart of ``onmf_ontf_ndl_tpu/utils/debug.py``:

- :func:`check_state`: the optimizer state's invariants, with the same
  ``FloatingPointError`` text as the JAX function, checked on the tensors
  where they lie, with one sync;
- :func:`debug_nans`: the counterpart of JAX's ``jax_debug_nans`` (there is
  no autograd here, so ``torch.autograd.set_detect_anomaly`` does not
  apply): while it is on, every training step checks its new state and its
  code and raises ``FloatingPointError`` naming the first step and fields
  that are not finite. That costs a sync a step inside the context only.
"""

from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["check_state", "debug_nans"]


def _close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float):
    """``np.isclose`` on tensors: infinities close only to themselves,
    NaN to nothing."""
    finite = torch.isfinite(a) & torch.isfinite(b)
    return (a == b) | (finite & ((a - b).abs() <= atol + rtol * b.abs()))


def check_state(state, *, name: str = "state") -> None:
    """Validate the optimizer-state invariants; raises
    ``FloatingPointError`` naming every violation.

    Invariants: all fields finite; W >= 0; dictionary columns within the
    unit ball; A symmetric with a non-negative diagonal.
    """
    W, A = state.W, state.A
    norms = torch.linalg.vector_norm(W, dim=0)
    max_norm = norms.max() if norms.numel() else norms.new_zeros(())
    # an empty field is finite and an empty A symmetric, as in numpy
    flags = torch.stack(
        [torch.isfinite(getattr(state, f)).all() for f in ("W", "A", "B", "C")]
        + [(W < 0).any(), (norms > 1 + 1e-4).any(),
           (torch.diagonal(A) < -1e-6).any(),
           ~_close(A, A.T, 1e-5, 1e-6).all()])
    *flags, max_norm = torch.cat([flags.to(max_norm.dtype),
                                  max_norm[None]]).tolist()   # the one sync
    finite, (neg_w, big_norm, neg_diag, asym) = flags[:4], flags[4:]
    problems = [f"{f} contains non-finite values"
                for f, ok in zip(("W", "A", "B", "C"), finite) if not ok]
    if not math.isfinite(float(state.t)):
        problems.append("t contains non-finite values")
    if neg_w:
        problems.append("W has negative entries")
    if big_norm:
        problems.append(f"W column norm exceeds 1 (max {max_norm:.6f})")
    if neg_diag:
        problems.append("A has negative diagonal entries")
    if asym:
        problems.append("A is not symmetric")
    if problems:
        raise FloatingPointError(f"{name}: " + "; ".join(problems))


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Check every training step's new state and code for non-finite
    values in the enclosed block; the step raises ``FloatingPointError``
    naming its step counter ``t`` and the fields at fault. Training runs
    its eager route inside (``models/onmf.py::_train_route``), so entering
    drops the captured steps and their memory."""
    from onmf_ontf_ndl_tpu_torch.models import onmf

    if enable:
        onmf._clear_graphs()
    prev = onmf._DEBUG_NANS
    onmf._DEBUG_NANS = bool(enable)
    try:
        yield
    finally:
        onmf._DEBUG_NANS = prev

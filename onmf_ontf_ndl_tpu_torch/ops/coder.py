"""Nonnegative sparse coding via row-wise projected gradient descent.

PyTorch counterpart of ``onmf_ontf_ndl_tpu/ops/coder.py``. For a fixed
dictionary ``W`` (d, r) and data ``X`` (d, n) it solves

    H* = argmin_{H >= 0}  0.5 * |X - W H|_F^2 + alpha * |H|_1

by Gauss-Seidel sweeps over the r rows of ``H`` with the step
``1 / (sqrt(i + 10) * (A_kk + 1))`` (``A = W^T W``), optionally inside a
spectral trust region of ``radius`` around ``H0``.

Execution modes, as in the JAX module:

- ``stopping_diff=None``: exactly ``sub_iter`` sweeps;
- ``stopping_diff=float``: sweeps until the relative spectral-norm change
  of the whole batch drops to ``stopping_diff`` (the reference rule).

``method="fista"`` (or ``"fista_bf16"``, the product from bf16-rounded
inputs) solves the same objective by accelerated projected gradient
(:func:`_fista_impl`), with no radius.

A batch split by columns over a process group (``parallel/auto.py``) keeps
the whole batch's stop in the plain maths: ``group=`` sums the two r x r
Grams behind the norms over the group every sweep (:func:`_norm_ratio`).

On a CUDA tensor without a radius, every mode runs the hand-written kernels
of ``ops/kernels/coder_kernel.py``; the early-stop and FISTA-stop kernels
apply the rule per column tile (see that module). Everything else is plain
PyTorch.
"""

from __future__ import annotations

import math

import torch

__all__ = ["nonneg_code", "nonneg_code_gram"]


def _fista_grad(A, Y, B, alpha, bf16_matmul: bool):
    """``A Y - B + alpha``; with ``bf16_matmul`` the product takes
    bf16-rounded A and Y and sums in the working type (float32 on the card,
    as the kernel does)."""
    if bf16_matmul:
        A, Y = A.bfloat16().to(A.dtype), Y.bfloat16().to(Y.dtype)
    return A @ Y - B + alpha


def _fista_step(H, Y, tt: float, A, B, alpha, inv_L, bf16_matmul: bool):
    """One FISTA iteration: the projected gradient step from Y, then the
    Nesterov extrapolation with momentum ``(tt - 1) / tt'``."""
    Hn = torch.clamp_min(Y - inv_L * _fista_grad(A, Y, B, alpha, bf16_matmul),
                         0.0)
    tn = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * tt * tt))
    return Hn, Hn + ((tt - 1.0) / tn) * (Hn - H), tn


def _fista_fixed(A, B, H0, alpha, inv_L, sub_iter: int, bf16_matmul: bool):
    """Exactly ``sub_iter`` FISTA iterations from H0 with step ``inv_L``."""
    H, Y, tt = H0, H0, 1.0
    for _ in range(sub_iter):
        H, Y, tt = _fista_step(H, Y, tt, A, B, alpha, inv_L, bf16_matmul)
    return H


def _fista_impl(A, B, H0, alpha, stopping_diff, sub_iter: int,
                use_stopping: bool, bf16_matmul: bool = False, group=None):
    """Accelerated projected-gradient (FISTA) nonnegative LASSO coder.

    Step ``1 / L`` with ``L = 1.02 lambda_max(A) + 1e-12`` from 16 power
    steps, Nesterov momentum in the standard t-sequence. With
    ``use_stopping``, iterates until the relative spectral change of the
    whole batch is at most ``stopping_diff`` (the denominator guarded at
    1e-30, unlike the sweep loop) or ``sub_iter`` iterations pass; the
    batch is split over ``group`` where one is given (:func:`_norm_ratio`).
    """
    from onmf_ontf_ndl_tpu_torch.ops.kernels.coder_kernel import (
        _inv_lipschitz)

    inv_L = _inv_lipschitz(A, 16)
    if not use_stopping:
        return _fista_fixed(A, B, H0, alpha, inv_L, sub_iter, bf16_matmul)
    H, Y, tt = H0, H0, 1.0
    i, dist = 0, math.inf
    while i < sub_iter and dist > stopping_diff:
        Hn, Y, tt = _fista_step(H, Y, tt, A, B, alpha, inv_L, bf16_matmul)
        dist = _norm_ratio(Hn - H, H, group, guard=1e-30)
        H = Hn
        i += 1
    return H


def _spectral_norm(M: torch.Tensor) -> torch.Tensor:
    """2-norm (largest singular value) of a matrix, as
    ``sqrt(lambda_max)`` of the smaller Gram matrix."""
    r, n = M.shape
    G = M @ M.T if r <= n else M.T @ M
    lam = torch.linalg.eigvalsh(G)[-1]
    return torch.sqrt(torch.clamp_min(lam, 0.0))


def _norm_ratio(D, H, group, guard=None) -> float:
    """``|D|_2 / |H|_2`` of the whole batch, the denominator clamped to
    ``guard`` where given. Without a group, from each matrix's own Gram
    (:func:`_spectral_norm`); with one, D and H are this rank's columns of
    the batch, and the ranks sum their r x r Grams (one all-reduce) before
    each takes the same ``lambda_max``."""
    if group is None:
        den = _spectral_norm(H)
        if guard is not None:
            den = torch.clamp_min(den, guard)
        return float(_spectral_norm(D) / den)
    import torch.distributed as dist

    grams = torch.stack([D @ D.T, H @ H.T])
    dist.all_reduce(grams, op=dist.ReduceOp.SUM, group=group)
    num, den = torch.sqrt(torch.clamp_min(
        torch.linalg.eigvalsh(grams)[:, -1], 0.0))
    if guard is not None:
        den = torch.clamp_min(den, guard)
    return float(num / den)


def _sweep(H, A, B, alpha, rsqrt_i):
    """One Gauss-Seidel sweep over all r rows of H, in place.

    rsqrt_i = 1/sqrt(i + 10) where i is the outer-iteration index.
    """
    steps = rsqrt_i / (torch.diagonal(A) + 1.0)
    for k in range(A.shape[0]):
        grad = A[k, :] @ H - B[k, :] + alpha
        H[k, :] = torch.clamp_min(H[k, :] - steps[k] * grad, 0.0)
    return H


def _sweep_radius(H, H_anchor, A, B, alpha, rsqrt_i, radius):
    """Sweep with a spectral trust region of ``radius`` re-anchored after
    every row by value (PARITY.md deviation #7: the reference's aliasing
    re-anchor would disable the projection after the first row)."""
    steps = rsqrt_i / (torch.diagonal(A) + 1.0)
    for k in range(A.shape[0]):
        grad = A[k, :] @ H - B[k, :] + alpha
        H = H.clone()
        H[k, :] = torch.clamp_min(H[k, :] - steps[k] * grad, 0.0)
        d = _spectral_norm(H - H_anchor)
        scale = radius / torch.clamp_min(d, radius)
        H = H_anchor + scale * (H - H_anchor)
        H_anchor = H
    return H, H_anchor


def _code_impl(A, B, H0, alpha, stopping_diff, radius, sub_iter: int,
               use_stopping: bool, use_radius: bool,
               group=None) -> torch.Tensor:
    """The plain coder: fixed, early-stop and radius paths; with the stop,
    the batch split by columns over ``group`` where one is given
    (:func:`_norm_ratio`)."""
    H, anchor = H0.clone(), H0

    def one_iter(i, H, anchor):
        rsqrt_i = 1.0 / math.sqrt(i + 10.0)
        if use_radius:
            return _sweep_radius(H, anchor, A, B, alpha, rsqrt_i, radius)
        return _sweep(H, A, B, alpha, rsqrt_i), anchor

    if not use_stopping:
        for i in range(sub_iter):
            H, anchor = one_iter(i, H, anchor)
        return H
    i, dist = 0, math.inf
    # no 1e-30 guard, as in the JAX loop: a zero H_old gives NaN, and
    # NaN > stopping_diff is False, so the loop stops
    while i < sub_iter and dist > stopping_diff:
        H_old = H.clone()
        H, anchor = one_iter(i, H, anchor)
        dist = _norm_ratio(H - H_old, H_old, group)
        i += 1
    return H


def nonneg_code_gram(
    A: torch.Tensor,
    B: torch.Tensor,
    H0: torch.Tensor,
    *,
    alpha: float = 0.0,
    sub_iter: int = 10,
    stopping_diff: float | None = 0.01,
    radius: float | None = None,
    backend: str = "auto",
    method: str = "bcd",
) -> torch.Tensor:
    """Nonnegative LASSO code update from precomputed Gram matrices.

    Args:
      A: (r, r) Gram matrix ``W^T W``.
      B: (r, n) projection ``W^T X``.
      H0: (r, n) initial code iterate.
      alpha: L1 penalty.
      sub_iter: max number of full row sweeps.
      stopping_diff: relative spectral-change early stop; ``None`` runs
        exactly ``sub_iter`` sweeps.
      radius: optional spectral trust-region radius around ``H0``.
      backend: "auto" | "torch" | "cuda" (see ``ops.kernels``).
      method: "bcd" (Gauss-Seidel sweeps), "fista" or "fista_bf16"
        (accelerated projected gradient; no radius).

    Returns:
      (r, n) nonnegative code matrix.
    """
    from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend

    use_stopping = stopping_diff is not None
    use_radius = radius is not None
    resolved = resolve_backend(backend, B)
    if method in ("fista", "fista_bf16"):
        if use_radius:
            raise ValueError(f"method={method!r} does not support radius")
        bf16 = method == "fista_bf16"
        if resolved == "cuda":
            from onmf_ontf_ndl_tpu_torch.ops.kernels.coder_kernel import (
                fista_sweeps)

            return fista_sweeps(
                A, B, H0, alpha, stopping_diff if use_stopping else 0.0,
                sub_iter=int(sub_iter), use_stopping=use_stopping,
                bf16_matmul=bf16)
        return _fista_impl(A, B, H0, alpha, stopping_diff, int(sub_iter),
                           use_stopping, bf16_matmul=bf16)
    if method != "bcd":
        raise ValueError(
            f"method must be 'bcd', 'fista' or 'fista_bf16', got {method!r}")
    if use_radius and backend == "cuda":
        raise ValueError(
            "the trust-region (radius) coder has no kernel; use "
            "backend='torch' or 'auto'")
    if not use_radius and resolved == "cuda":
        from onmf_ontf_ndl_tpu_torch.ops.kernels.coder_kernel import (
            coder_sweeps, coder_sweeps_earlystop)

        if use_stopping:
            return coder_sweeps_earlystop(A, B, H0, alpha, stopping_diff,
                                          sub_iter=int(sub_iter))
        return coder_sweeps(A, B, H0, alpha, sub_iter=int(sub_iter))
    return _code_impl(A, B, H0, alpha, stopping_diff, radius,
                      int(sub_iter), use_stopping, use_radius)


def nonneg_code(
    X: torch.Tensor,
    W: torch.Tensor,
    H0: torch.Tensor | None = None,
    *,
    generator: torch.Generator | None = None,
    alpha: float = 0.0,
    sub_iter: int = 10,
    stopping_diff: float | None = 0.01,
    radius: float | None = None,
    backend: str = "auto",
    method: str = "bcd",
) -> torch.Tensor:
    """Sparse-code a data batch ``X`` (d, n) against dictionary ``W`` (d, r).

    ``H0=None`` draws the initial iterate uniformly from [0, 1) with
    ``generator`` (the reference's ``np.random.rand`` initialization).
    """
    A = W.T @ W
    B = W.T @ X
    if H0 is None:
        if generator is None:
            raise ValueError("nonneg_code: provide H0 or generator")
        H0 = torch.rand((W.shape[1], X.shape[1]), generator=generator,
                        dtype=W.dtype, device=W.device)
    return nonneg_code_gram(
        A, B, H0, alpha=alpha, sub_iter=sub_iter,
        stopping_diff=stopping_diff, radius=radius, backend=backend,
        method=method,
    )

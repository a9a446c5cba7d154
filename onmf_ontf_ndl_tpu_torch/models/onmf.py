"""Online nonnegative matrix factorization (ONMF) in PyTorch.

Counterpart of ``onmf_ontf_ndl_tpu/models/onmf.py``: the same step, the
same training schedule, the same 5-tuple contract. The JAX ``lax.scan``
becomes a Python loop; on a CUDA tensor each step runs the hand-written
kernels of ``ops/kernels`` for the coder and the dictionary update, and
``torch.matmul`` for the dense products ``W^T W``, ``W^T X``, ``H H^T`` and
``H X^T`` (the JAX package leaves those to XLA).

Semantics kept from the JAX module:

- per step: sparse-code the batch, update the aggregates with weight
  ``t^-beta``, one column-BCD pass on W from the pre-step aggregates
  (``dict_from="stale"``) or the fresh ones (``"fresh"``);
- history: a run of ``iterations`` leaves the counter at
  ``t0 + iterations``; ``iterations <= 1`` returns the inputs unchanged;
- code accumulation at duplicate subsample indices adds every
  contribution (``index_add_``; PARITY.md #5). On a CUDA tensor
  ``index_add_`` adds in a nondeterministic order, so the accumulated code
  agrees between runs only to float32 rounding (~1e-6 relative).

Randomness comes from ``state.gen``. ``draws=`` replaces the sampler with
per-step ``(idx, H0)`` pairs given from outside (tests use it to replay the
JAX draws, whose threefry stream torch cannot reproduce).

Data parallelism (``parallel/dp.py``): with a ``torch.distributed`` process
group, each rank codes its own columns and the step ``all_reduce``s (SUM)
the statistics ``H Hᵀ``, ``H Xᵀ`` and ``X Xᵀ`` before it forms the
aggregates, where the JAX step ``psum``s them over its mesh axis; every
rank then runs the same dictionary update, so the replicas stay equal. The
ranks draw their batches and ``H0`` from a rank generator
(:func:`rank_generator`).
"""

from __future__ import annotations

import dataclasses

import torch

from onmf_ontf_ndl_tpu_torch.models.state import (
    OnmfState, entry_device, init_state, make_generator)
from onmf_ontf_ndl_tpu_torch.ops.coder import _code_impl, _fista_impl
from onmf_ontf_ndl_tpu_torch.ops.dict_update import dict_update_bcd
from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend

__all__ = ["OnlineNMF", "onmf_step", "train_dict", "rank_generator"]

# Set by ``utils/debug.py::debug_nans``: check each step's new state and
# code, at the cost of a sync a step. Off, the step reads this flag only.
_DEBUG_NANS = False

_GOLDEN = 0x9E3779B97F4A7C15   # odd: rank r's seed offset is r times it


def rank_generator(gen: torch.Generator, group) -> torch.Generator:
    """The generator of this rank's draws in a data-parallel run.

    Every rank draws one seed from ``gen`` alike (the replicas' generators
    stay equal) and seeds a generator on ``gen``'s device with it, offset
    by the rank, so the ranks' draws differ. Without a group, or with one
    rank, it is ``gen`` itself: a one-rank run equals the run without a
    group draw for draw."""
    if group is None:
        return gen
    import torch.distributed as dist

    if dist.get_world_size(group) == 1:
        return gen
    seed = int(torch.randint(0, 2**62, (1,), generator=gen,
                             device=gen.device))
    rank = dist.get_rank(group)
    return make_generator((seed + rank * _GOLDEN) % 2**63, gen.device)


def _all_reduce(tensors, group) -> list:
    """The sums over ``group`` of ``tensors``, in one collective: flat in
    one buffer, one call a step where separate calls would make two or
    three."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _check_finite(st, H, t: float) -> None:
    """``debug_nans``: raise naming the step and the fields that are not
    finite (one sync)."""
    fields = {"code": H, "W": st.W, "A": st.A, "B": st.B, "C": st.C}
    ok = torch.stack([torch.isfinite(v).all() for v in fields.values()])
    bad = [name for name, good in zip(fields, ok.tolist()) if not good]
    if bad:
        raise FloatingPointError(
            f"step t={t:g}: non-finite {', '.join(bad)}")


def _check_modes(dict_from: str, coder: str) -> None:
    if dict_from not in ("stale", "fresh"):
        raise ValueError(
            f"dict_from must be 'stale' or 'fresh', got {dict_from!r}")
    if coder not in ("bcd", "fista", "fista_bf16"):
        raise ValueError(
            f"coder must be 'bcd', 'fista' or 'fista_bf16', got {coder!r}")


def onmf_step(
    state: OnmfState,
    X: torch.Tensor,
    t: float | None = None,
    *,
    H0: torch.Tensor | None = None,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float | None = 0.01,
    dict_from: str = "stale",
    backend: str = "auto",
    coder: str = "bcd",
    draws: tuple | None = None,
) -> tuple[OnmfState, torch.Tensor]:
    """One online-NMF step on a data batch ``X`` (d, n).

    Args:
      state: current optimizer state.
      t: step index driving the ``t^-beta`` weight; defaults to
        ``state.t + 1``.
      H0: optional (r, n) initial code; drawn uniform [0, 1) from
        ``state.gen`` when omitted.
      dict_from: "stale" (reference) or "fresh" aggregates for the W update.
      backend: "auto" | "torch" | "cuda".
      coder: "bcd" (Gauss-Seidel sweeps), "fista" (accelerated projected
        gradient, same objective) or "fista_bf16" (its product from
        bf16-rounded inputs, f32 accumulation).
      draws: optional ``(idx, H0)``: code columns ``idx`` of X (all when
        None) from this ``H0``.

    Returns:
      (new_state, H) where H is the (r, n) nonnegative code of the batch.
    """
    _check_modes(dict_from, coder)
    if draws is not None:
        idx, H0 = draws
        if idx is not None:
            X = X[:, idx]
    if t is None:
        t = state.t + 1.0
    if H0 is None:
        H0 = torch.rand((state.r, X.shape[1]), generator=state.gen,
                        dtype=state.W.dtype, device=state.W.device)
    return _step_inner(state, X, float(t), H0, alpha, beta, sub_iter,
                       stopping_diff, dict_from, resolve_backend(backend, X),
                       coder=coder)


def _step_inner(st, Xb, t: float, H0, alpha, beta, sub_iter: int,
                stopping_diff, dict_from: str, backend: str = "torch",
                coder: str = "bcd", group=None):
    """One step: code, aggregates, dictionary update.

    backend="cuda" runs the coder kernel of ``coder`` (fixed iterations, or
    the per-tile stop when ``stopping_diff`` is set) and the BCD dictionary
    kernel; the result agrees with the torch path to float32 accumulation
    order (the stopping kernels also up to the stopping tolerance on
    batches wider than one tile, PARITY.md #8).

    ``group``: a process group over which ``Xb`` is column-sharded; the
    statistics are summed over it, so the step equals the one-process step
    on the concatenated batch (with the stop, the stop is shard-local).
    """
    W, A, B, C = st.W, st.A, st.B, st.C
    use_stopping = stopping_diff is not None
    use_cuda = backend == "cuda"
    gram = W.T @ W
    proj = W.T @ Xb
    H0 = H0.contiguous()
    fista = coder in ("fista", "fista_bf16")
    if fista and use_cuda:
        from onmf_ontf_ndl_tpu_torch.ops.kernels.coder_kernel import (
            fista_sweeps)

        H = fista_sweeps(gram, proj, H0, alpha,
                         stopping_diff if use_stopping else 0.0,
                         sub_iter=int(sub_iter), use_stopping=use_stopping,
                         bf16_matmul=coder == "fista_bf16")
    elif fista:
        H = _fista_impl(gram, proj, H0, alpha, stopping_diff, int(sub_iter),
                        use_stopping, bf16_matmul=coder == "fista_bf16")
    elif use_cuda:
        from onmf_ontf_ndl_tpu_torch.ops.kernels.coder_kernel import (
            coder_sweeps, coder_sweeps_earlystop)

        if use_stopping:
            H = coder_sweeps_earlystop(gram, proj, H0, alpha, stopping_diff,
                                       sub_iter=int(sub_iter))
        else:
            H = coder_sweeps(gram, proj, H0, alpha, sub_iter=int(sub_iter))
    else:
        H = _code_impl(gram, proj, H0, alpha, stopping_diff, None,
                       int(sub_iter), use_stopping, False)
    w_t = t ** (-float(beta))
    hht = H @ H.T
    hxt = H @ Xb.T
    xxt = Xb @ Xb.T if st.tracks_xxt else None
    if group is not None:
        if xxt is None:
            hht, hxt = _all_reduce([hht, hxt], group)
        else:
            hht, hxt, xxt = _all_reduce([hht, hxt, xxt], group)
    A1 = (1.0 - w_t) * A + w_t * hht
    B1 = (1.0 - w_t) * B + w_t * hxt
    C1 = (1.0 - w_t) * C + w_t * xxt if st.tracks_xxt else C
    A_u, B_u = (A, B) if dict_from == "stale" else (A1, B1)
    if use_cuda:
        from onmf_ontf_ndl_tpu_torch.ops.kernels.coder_kernel import (
            dict_update_sweep)

        W1 = dict_update_sweep(W, A_u.contiguous(), B_u.contiguous())
    else:
        W1 = dict_update_bcd(W, A_u, B_u)
    st = dataclasses.replace(st, W=W1, A=A1, B=B1, C=C1, t=t)
    if _DEBUG_NANS:
        _check_finite(st, H, t)
    return st, H


def _train_loop(
    state: OnmfState,
    X: torch.Tensor,
    code: torch.Tensor,
    alpha: float,
    beta: float,
    stopping_diff: float | None,
    iterations: int,
    batch_size: int,
    subsample: bool,
    sub_iter: int,
    track_code: bool,
    dict_from: str,
    backend: str = "torch",
    track_metrics: bool = False,
    sampling: str = "iid",
    draws=None,
    coder: str = "bcd",
    group=None,
):
    """``iterations - 1`` steps (the JAX ``_train_scan``); every training
    path funnels through here. ``code`` is updated in place. With a
    ``group``, ``X`` is this rank's shard: the pool permutation of block
    sampling is drawn alike on every rank (as the JAX scan draws it from
    the replicated key), the batches and ``H0`` from the rank generator."""
    if sampling not in ("iid", "block"):
        raise ValueError(f"sampling must be 'iid' or 'block', got {sampling!r}")
    n = X.shape[1]
    t0 = state.t
    gen = state.gen
    if subsample and sampling == "block" and draws is None:
        # a contiguous wrap-around block of a once-permuted pool at a random
        # offset per step (PARITY.md #12); on the card a column gather is
        # cheap, so the block is gathered rather than sliced from a tiled copy
        perm = torch.randperm(n, generator=gen, device=X.device)
        offsets = torch.arange(batch_size, device=X.device)
    if draws is None:
        gen = rank_generator(gen, group)
    metrics = []
    st = state
    for step, i in enumerate(range(1, max(iterations, 1))):
        if draws is not None:
            idx, H0 = draws[step]
            Xb = X if idx is None else X[:, idx]
        else:
            if subsample and sampling == "block":
                off = torch.randint(0, n, (1,), generator=gen,
                                    device=X.device)
                idx = perm[(off + offsets) % n]
                Xb = X.index_select(1, idx)
            elif subsample:
                idx = torch.randint(0, n, (batch_size,), generator=gen,
                                    device=X.device)
                Xb = X.index_select(1, idx)
            else:
                idx, Xb = None, X
            H0 = torch.rand((st.r, Xb.shape[1]), generator=gen,
                            dtype=X.dtype, device=X.device)
        st, H = _step_inner(st, Xb, t0 + i, H0, alpha, beta, sub_iter,
                            stopping_diff, dict_from, backend, coder=coder,
                            group=group)
        if track_code:
            if idx is None:
                code += H
            else:
                code.index_add_(1, torch.as_tensor(idx, device=X.device), H)
        if track_metrics:
            # per-step batch objective 0.5|Xb - W H|^2 + alpha|H|_1 with
            # the post-update W
            metrics.append(0.5 * torch.sum((Xb - st.W @ H) ** 2)
                           + alpha * torch.sum(H))
    if iterations > 1:
        st = dataclasses.replace(st, t=t0 + float(iterations))
    metrics = torch.stack(metrics) if metrics \
        else torch.zeros((0,), dtype=X.dtype, device=X.device)
    return st, code, metrics


def train_dict(
    state: OnmfState,
    X: torch.Tensor,
    *,
    iterations: int,
    batch_size: int,
    subsample: bool = True,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float | None = 0.01,
    track_code: bool = True,
    dict_from: str = "stale",
    code0: torch.Tensor | None = None,
    backend: str = "auto",
    return_metrics: bool = False,
    coder: str = "bcd",
    sampling: str = "iid",
    draws=None,
):
    """Run ``iterations - 1`` online steps over minibatches of ``X`` (d, n).

    The loop count and schedule mirror the reference's
    ``for i in np.arange(1, iterations)`` with step weight
    ``(t0 + i)^-beta``. ``sampling`` (with ``subsample=True``): ``"iid"``
    draws batch columns with replacement; ``"block"`` takes a wrap-around
    block of a once-permuted pool. ``draws`` gives each step's
    ``(idx, H0)`` from outside (``idx=None``: the full matrix).

    Returns ``(state, code)``, plus the per-step objectives with
    ``return_metrics=True``.
    """
    _check_modes(dict_from, coder)
    code = torch.zeros((state.r, X.shape[1]), dtype=X.dtype,
                       device=X.device) if code0 is None else code0
    if iterations <= 1:
        if return_metrics:
            return state, code, torch.zeros((0,), dtype=X.dtype,
                                            device=X.device)
        return state, code
    state, code, metrics = _train_loop(
        state, X, code.clone(), alpha, beta, stopping_diff, int(iterations),
        int(batch_size), bool(subsample), int(sub_iter), bool(track_code),
        dict_from, backend=resolve_backend(backend, X),
        track_metrics=bool(return_metrics), sampling=sampling, draws=draws,
        coder=coder,
    )
    if return_metrics:
        return state, code, metrics
    return state, code


class OnlineNMF:
    """Convenience shell matching the reference contract.

    ``OnlineNMF(X, ...).train_dict()`` returns ``(W, At, Bt, Ct, H)`` with
    warm-start kwargs ``ini_dict / ini_A / ini_B / ini_C / history``.
    ``device`` places the data and state (the card by default; a CPU run
    passes ``device="cpu"``); ``seed`` or ``generator`` (on that device)
    seeds the random draws.
    """

    def __init__(
        self,
        X,
        n_components: int = 100,
        iterations: int = 500,
        batch_size: int = 20,
        ini_dict=None,
        ini_A=None,
        ini_B=None,
        ini_C=None,
        history: float = 0.0,
        alpha: float | None = None,
        beta: float | None = None,
        # reference default: inner steps train on the FULL column matrix
        subsample: bool = False,
        track_xxt: bool | None = None,
        sub_iter: int = 10,
        stopping_diff: float | None = 0.01,
        dict_from: str = "stale",
        coder: str = "bcd",
        generator: torch.Generator | None = None,
        seed: int = 0,
        device="cuda",
        dtype=torch.float32,
    ):
        _check_modes(dict_from, coder)
        self.device = entry_device(device)
        self.X = torch.as_tensor(X, dtype=dtype, device=self.device)
        self.n_components = n_components
        self.iterations = iterations
        self.batch_size = batch_size
        self.alpha = 0.0 if alpha is None else float(alpha)
        self.beta = 1.0 if beta is None else float(beta)
        self.subsample = subsample
        self.sub_iter = sub_iter
        self.stopping_diff = stopping_diff
        self.dict_from = dict_from
        self.coder = coder
        self.dtype = dtype
        if track_xxt is None:
            track_xxt = ini_C is not None
        if generator is None:
            generator = make_generator(seed, self.device)
        # generator state at construction, so fit() restarts the stream
        self._init_rng = generator.get_state()
        self.state = init_state(
            generator, self.X.shape[0], n_components, device=self.device,
            track_xxt=track_xxt, dtype=dtype,
            W=ini_dict, A=ini_A, B=ini_B, C=ini_C, t=float(history),
        )
        self.code = torch.zeros((n_components, self.X.shape[1]),
                                dtype=dtype, device=self.device)
        self._init_state = self.state
        self._track_xxt = track_xxt

    @property
    def history(self) -> float:
        return float(self.state.t)

    def sparse_code(self, X, W):
        """Code a batch against W with the instance's alpha (reference
        ``Online_NMF.sparse_code``); H0 comes from a generator seeded by
        the batch width, so the result is deterministic."""
        from onmf_ontf_ndl_tpu_torch.ops.coder import nonneg_code

        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        W = torch.as_tensor(W, dtype=self.dtype, device=self.device)
        gen = make_generator(101 * 2**32 + X.shape[1], self.device)
        return nonneg_code(X, W, generator=gen, alpha=self.alpha,
                           sub_iter=self.sub_iter,
                           stopping_diff=self.stopping_diff,
                           method=self.coder)

    def partial_fit(self, X_batch):
        """One online step on an incoming batch (d, n). Returns self."""
        X_batch = torch.as_tensor(X_batch, dtype=self.dtype,
                                  device=self.device)
        self.state, _ = onmf_step(
            self.state, X_batch, alpha=self.alpha, beta=self.beta,
            sub_iter=self.sub_iter, stopping_diff=self.stopping_diff,
            dict_from=self.dict_from, coder=self.coder,
        )
        return self

    def train_dict(self, draws=None):
        """Learn/refine the dictionary; returns ``(W, At, Bt, Ct, H)``.
        ``draws`` as in :func:`train_dict`."""
        self.state, self.code = train_dict(
            self.state, self.X,
            iterations=self.iterations, batch_size=self.batch_size,
            subsample=self.subsample, alpha=self.alpha, beta=self.beta,
            sub_iter=self.sub_iter, stopping_diff=self.stopping_diff,
            track_code=True, dict_from=self.dict_from, code0=self.code,
            coder=self.coder, draws=draws,
        )
        st = self.state
        Ct = st.C if st.tracks_xxt else None
        return st.W, st.A, st.B, Ct, self.code

    # ------------------------------------------------------ sklearn-style
    # samples are ROWS here, as in sklearn; the native API is
    # columns-as-samples.

    @property
    def components_(self):
        """(r, d) dictionary with atoms as rows (sklearn convention)."""
        return self.state.W.T

    def fit(self, X=None):
        """Fresh fit on ``X`` (samples x features; the instance's matrix
        when omitted), restarting from the configured initial state and
        random stream. Returns self."""
        if X is not None:
            self.X = torch.as_tensor(X, dtype=self.dtype,
                                     device=self.device).T
        gen = torch.Generator(device=self.device)
        gen.set_state(self._init_rng)
        if self._init_state.W.shape[0] == self.X.shape[0]:
            self.state = dataclasses.replace(self._init_state, gen=gen)
        else:
            # feature dimension changed: a fresh state, same init recipe
            self.state = init_state(
                gen, self.X.shape[0], self.n_components, device=self.device,
                track_xxt=self._track_xxt, dtype=self.dtype)
        self.code = torch.zeros((self.n_components, self.X.shape[1]),
                                dtype=self.dtype, device=self.device)
        self.train_dict()
        return self

    def transform(self, X):
        """Nonnegative codes of ``X`` (samples x features); (samples, r)."""
        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        return self.sparse_code(X.T, self.state.W).T

    def fit_transform(self, X):
        return self.fit(X).transform(X)

    def inverse_transform(self, H):
        """(samples, r) codes -> (samples, d) reconstruction."""
        H = torch.as_tensor(H, dtype=self.dtype, device=self.device)
        return (self.state.W @ H.T).T

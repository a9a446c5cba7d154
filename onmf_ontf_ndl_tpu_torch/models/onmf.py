"""Online nonnegative matrix factorization (ONMF) in PyTorch.

Counterpart of ``onmf_ontf_ndl_tpu/models/onmf.py``: the same step, the
same training schedule, the same 5-tuple contract. Each step runs the
hand-written kernels of ``ops/kernels`` on a CUDA tensor for the coder and
the dictionary update, and ``torch.matmul`` for the dense products
``W^T W``, ``W^T X``, ``H H^T`` and ``H X^T`` (the JAX package leaves those
to XLA). The JAX ``jit`` of ``lax.scan`` becomes one step function on
static buffers (``_loop_step``): on a CUDA tensor it is captured once as a
CUDA graph and replayed for every step, its draws from a generator
registered with the graph; on the CPU, and under ``debug_nans``, it runs in
a Python loop (``_train_route``). The JAX apps' outer ``lax.scan`` over
rounds becomes one round function on static buffers (``_run_rounds``:
an app's sampler, its patches and the inner steps), captured once per key
and replayed a round at a time on the card (``_round_route``).

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

Two axes (``parallel/auto.py::auto_train_dict``): every rank draws one
global batch from the replicated generator and codes its whole tiles of it
(:func:`batch_cols`), the statistics summed over ``dp``; with a ``tp``
group W's columns and B's rows are sharded over it, and the step gathers
them (:func:`_step_math`). The run is ``train_dict``'s.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from onmf_ontf_ndl_tpu_torch.models.state import (
    OnmfState, entry_device, init_state, make_generator)
from onmf_ontf_ndl_tpu_torch.ops.coder import _code_impl, _fista_impl
from onmf_ontf_ndl_tpu_torch.ops.dict_update import dict_update_bcd
from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend
from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import TN
from onmf_ontf_ndl_tpu_torch.ops.kernels.coder_kernel import MAX_RANK
from onmf_ontf_ndl_tpu_torch.utils.capture import GraphCache, tensor_at
from onmf_ontf_ndl_tpu_torch.utils.profiling import span

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


def batch_cols(batch: int, world: int) -> list[tuple[int, int]]:
    """Each data-parallel rank's columns ``(start, stop)`` of a global batch
    of ``batch`` columns: whole tiles of the kernels' ``TN`` columns, dealt
    as evenly as they go, the last rank's ending at ``batch``. The coder
    kernels stop per tile (PARITY.md #8), so a rank whose columns start at
    a tile's start codes them as one process codes the whole batch."""
    tiles = -(-batch // TN)
    cuts = [min(batch, (i * tiles // world) * TN) for i in range(world)]
    return list(zip(cuts, cuts[1:] + [batch]))


def _all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` stacked by rows in group order: one collective,
    whose single output a CUDA graph captures."""
    import torch.distributed as dist

    out = torch.empty((dist.get_world_size(group) * t.shape[0],)
                      + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


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


def _code(gram, proj, H0, alpha, sub_iter: int, stopping_diff, backend: str,
          coder: str, stop_group=None):
    """The batch's code from Gram form: the kernel of ``coder`` on
    backend="cuda" (fixed iterations, or the per-tile stop when
    ``stopping_diff`` is set), else the plain maths, whose stop is the
    whole batch's over ``stop_group`` where the batch is split over one."""
    use_stopping = stopping_diff is not None
    fista = coder in ("fista", "fista_bf16")
    if fista and backend == "cuda":
        from onmf_ontf_ndl_tpu_torch.ops.kernels.coder_kernel import (
            fista_sweeps)

        return fista_sweeps(gram, proj, H0, alpha,
                            stopping_diff if use_stopping else 0.0,
                            sub_iter=sub_iter, use_stopping=use_stopping,
                            bf16_matmul=coder == "fista_bf16")
    if fista:
        return _fista_impl(gram, proj, H0, alpha, stopping_diff, sub_iter,
                           use_stopping, bf16_matmul=coder == "fista_bf16",
                           group=stop_group)
    if backend == "cuda":
        from onmf_ontf_ndl_tpu_torch.ops.kernels.coder_kernel import (
            coder_sweeps, coder_sweeps_earlystop)

        if use_stopping:
            return coder_sweeps_earlystop(gram, proj, H0, alpha,
                                          stopping_diff, sub_iter=sub_iter)
        return coder_sweeps(gram, proj, H0, alpha, sub_iter=sub_iter)
    return _code_impl(gram, proj, H0, alpha, stopping_diff, None, sub_iter,
                      use_stopping, False, group=stop_group)


def _step_math(W, A, B, C, Xb, H0, w, omw, alpha, sub_iter: int,
               stopping_diff, dict_from: str, backend: str, coder: str,
               group, tp=None, stop_group=None):
    """One step's maths, on W, A, B and C in place: code ``Xb`` from
    ``H0``, blend the statistics into the aggregates,
    ``M <- omw * M + w * stat``, with the weights ``w`` = t^-beta and
    ``omw`` = 1 - w (Python floats, or (1,) tensors of the state's dtype
    that hold them rounded as such a float is where it multiplies a tensor
    of that dtype), then one BCD pass on W from the pre-step aggregates
    ("stale") or the new ones ("fresh"). Returns the batch's code H and
    the new dictionary (all of it).

    backend="cuda" runs the coder kernel of ``coder`` and the BCD dictionary
    kernel; the result agrees with the torch path to float32 accumulation
    order (the stopping kernels also up to the stopping tolerance on
    batches wider than one tile, PARITY.md #8). ``group``: a process group
    over which ``Xb`` is column-sharded; the statistics are summed over it,
    so the step equals the one-process step on the concatenated batch
    (with the stop, the stop is shard-local unless ``stop_group`` is the
    group: then the plain coder's stop is the whole batch's, and the
    kernels' per-tile stop is the one-process stop where each rank's
    columns are whole tiles, :func:`batch_cols`).

    ``tp``: a process group over which W's columns and B's rows are
    sharded (W, B this rank's (d, r / tp) and (r / tp, d)). The step
    gathers the full W and forms ``Wᵀ W``, forms its rows of ``Wᵀ Xb`` and
    gathers them, codes all r rows (the Gauss-Seidel coder needs every
    row), forms ``H Hᵀ`` and its rows of ``H Xbᵀ``, and runs the column
    BCD (sequential over all r columns) on the full W with B's rows
    gathered; it keeps its own columns. With one rank in ``tp`` and in
    ``group`` it calls the products of the step without them on the same
    shapes.
    """
    if tp is None:
        Wf = W
    else:
        import torch.distributed as dist

        lo, r_l = dist.get_rank(tp) * W.shape[1], W.shape[1]
        Wf = _all_gather_rows(W.T, tp).T.contiguous()
    gram = Wf.T @ Wf
    proj = W.T @ Xb
    if tp is not None:
        proj = _all_gather_rows(proj, tp)
    H = _code(gram, proj, H0.contiguous(), alpha, int(sub_iter),
              stopping_diff, backend, coder, stop_group)
    hht = H @ H.T
    hxt = (H if tp is None else H.narrow(0, lo, r_l)) @ Xb.T
    xxt = Xb @ Xb.T if C.numel() else None
    if group is not None:
        if xxt is None:
            hht, hxt = _all_reduce([hht, hxt], group)
        else:
            hht, hxt, xxt = _all_reduce([hht, hxt, xxt], group)

    def blend(M, stat):
        torch.mul(M, omw, out=M).add_(stat.mul_(w))

    def update(A_u, B_u):
        if tp is not None:
            B_u = _all_gather_rows(B_u, tp)
        if backend == "cuda":
            from onmf_ontf_ndl_tpu_torch.ops.kernels.coder_kernel import (
                dict_update_sweep)

            return dict_update_sweep(Wf, A_u.contiguous(), B_u.contiguous())
        return dict_update_bcd(Wf, A_u, B_u)

    if dict_from == "stale":
        W1 = update(A, B)        # before the aggregates change
    blend(A, hht)
    blend(B, hxt)
    if xxt is not None:
        blend(C, xxt)
    if dict_from == "fresh":
        W1 = update(A, B)
    W.copy_(W1 if tp is None else W1.narrow(1, lo, r_l))
    return H, W1


def _step_inner(st, Xb, t: float, H0, alpha, beta, sub_iter: int,
                stopping_diff, dict_from: str, backend: str = "torch",
                coder: str = "bcd", group=None):
    """One step at counter ``t`` (:func:`_step_math` on copies of the
    state): ``(new_state, H)``."""
    w_t = t ** (-float(beta))
    W, A, B, C = (v.clone() for v in (st.W, st.A, st.B, st.C))
    H, _ = _step_math(W, A, B, C, Xb, H0, w_t, 1.0 - w_t, alpha, sub_iter,
                      stopping_diff, dict_from, backend, coder, group)
    st = dataclasses.replace(st, W=W, A=A, B=B, C=C, t=t)
    if _DEBUG_NANS:
        _check_finite(st, H, t)
    return st, H


# ------------------------------------------------------------ the training
# loop: one step function on static buffers, called in a Python loop
# (eager) or captured once as a CUDA graph and replayed (captured), the
# counterpart of the JAX package's jitted lax.scan.

# Step graphs kept at once (utils/capture.py): an app's outer loop replays
# one graph call after call.
_GRAPHS = GraphCache("step", 4)
# Data of up to this many bytes is copied into the graph's own buffer on
# every call (an app's patches, new at every outer iteration); a larger X
# (the headline pool, 157 MB) is read in place and not held, so that no
# second copy of it is kept and the caller's X is freed when the caller
# drops it: an X at the same address and strides replays the graph,
# another one is captured anew.
_OWN_X_BYTES = 1 << 26


@dataclasses.dataclass(frozen=True)
class _StepSpec:
    """What a training step does, apart from its data: with the data's
    device, dtype and shape and the state's rank (:func:`_graph_key`), all
    that a captured step bakes in. ``draws``: None (drawn from the
    generator), "idx" (given indices and H0) or "full" (given H0, the whole
    X). ``steps``: the rows of the per-step tables. ``beta`` and the counter
    ``t`` are not baked: they enter through the weight table. ``group``:
    the data-parallel group; ``tp``: the group over which the state's W
    and B are sharded; ``cols``: this rank's columns of a global batch
    split over ``group`` (:func:`batch_cols`), None where each rank draws
    its own batch."""

    batch: int
    steps: int
    alpha: float
    sub_iter: int
    stopping_diff: float | None
    dict_from: str
    backend: str
    coder: str
    draws: str | None
    subsample: bool
    sampling: str
    track_code: bool
    track_metrics: bool
    group: object = None
    tp: object = None
    cols: tuple | None = None


def _graph_key(X, state, spec: _StepSpec) -> tuple:
    """The cache key of the graph that runs ``spec`` on data like ``X``
    (its device, dtype, shape and strides, not its values) from a state
    like ``state`` (rank, the columns of W that it holds, dtype, whether
    it tracks X Xᵀ)."""
    return (X.device, X.dtype, tuple(X.shape), X.stride(), state.W.dtype,
            state.A.shape[0], state.r, state.tracks_xxt, spec)


def _train_route(device_type: str, backend: str, group_backend, r: int,
                 debug_nans: bool, capture: bool = True) -> str:
    """How ``_train_loop`` runs its steps: ``"captured"`` (one step
    captured as a CUDA graph, replayed) or ``"eager"`` (the step function
    in a Python loop). Captured takes a CUDA tensor on the kernels'
    backend at a rank the coder kernels take: on the plain maths, which
    the coder wrappers also run past ``MAX_RANK`` (``kernel_route``'s
    "unfused"), the early stop reads its test on the host, which a capture
    cannot. It also takes no group or NCCL ones (``group_backend``: the
    backend of the step's groups, "mixed" where they differ; a gloo
    collective is not captured), and no ``debug_nans`` (its check syncs
    every step).
    ``capture=False`` asks for eager."""
    if (capture and device_type == "cuda" and backend == "cuda"
            and r <= MAX_RANK and group_backend in (None, "nccl")
            and not debug_nans):
        return "captured"
    return "eager"


def _stack_draws(draws, steps: int, X):
    """Given per-step ``(idx, H0)`` draws as tables that the step counter
    indexes: ``(mode, idx (steps, batch) or None, H0 (steps, r, batch))``,
    mode "idx", or "full" where every ``idx`` is None (the whole X)."""
    draws = list(draws)[:steps]
    if len(draws) < steps:
        raise ValueError(f"draws: {len(draws)} given for {steps} steps")
    H0 = torch.stack([torch.as_tensor(h, dtype=X.dtype, device=X.device)
                      for _, h in draws])
    given = [idx is not None for idx, _ in draws]
    if not any(given):
        return "full", None, H0
    if not all(given):
        raise ValueError("draws: give every step's indices or none")
    idx = torch.stack([torch.as_tensor(idx, device=X.device).long()
                       for idx, _ in draws])
    return "idx", idx, H0


@dataclasses.dataclass
class _Loop:
    """The buffers a training step reads and writes in place: the state,
    the code, the data, the tables of every step (the captured route's
    weights, given draws, block sampling's pool permutation) and the step
    counter that indexes them. ``X`` is None once a graph that reads the
    caller's X in place is captured."""

    X: torch.Tensor | None
    W: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    code: torch.Tensor | None
    step: torch.Tensor
    w: torch.Tensor | None
    omw: torch.Tensor | None
    perm: torch.Tensor | None
    offsets: torch.Tensor | None
    idx: torch.Tensor | None
    H0: torch.Tensor | None
    metrics: torch.Tensor | None
    owns_x: bool


_TABLES = ("w", "omw", "perm", "idx", "H0")


def _like(t, device):
    """An empty buffer of ``t``'s shape and dtype on ``device`` (a table
    may come from the host), or None for None."""
    return None if t is None else torch.empty(t.shape, dtype=t.dtype,
                                              device=device)


def _take(captured: bool, t):
    """``t`` handed out of a run: a copy where it is a graph's buffer
    (``captured``), which the next call of its key overwrites."""
    return t.clone() if captured else t


def _new_loop(state, X, code, spec: _StepSpec, tables: dict,
              owns_x: bool = False) -> _Loop:
    """Buffers for a run like this call's, not filled (:func:`_refill`);
    ``X`` itself, or with ``owns_x`` a buffer of its shape and layout (an
    app's patches are a transposed view, and the products must see the
    strides that the eager route sees: cuBLAS rounds another layout
    otherwise). ``tables`` may hold ``perm``, ``idx`` and ``H0``, and on
    the captured route ``w`` and ``omw``."""
    dev = state.W.device
    perm = tables.get("perm")
    return _Loop(
        X=torch.empty_like(X) if owns_x else X, W=_like(state.W, dev),
        A=_like(state.A, dev), B=_like(state.B, dev), C=_like(state.C, dev),
        code=_like(code, dev) if spec.track_code else None,
        step=torch.zeros(1, dtype=torch.long, device=dev),
        **{name: _like(tables.get(name), dev) for name in _TABLES},
        offsets=None if perm is None
        else torch.arange(spec.batch, device=dev),
        metrics=torch.zeros(spec.steps, dtype=X.dtype, device=dev)
        if spec.track_metrics else None,
        owns_x=owns_x)


def _refill(lp: _Loop, state, X, code, tables: dict) -> None:
    """Copy a call's state, code, tables (each into the start of its
    buffer: a round's weight table holds the steps of its capacity) and,
    where the buffers own theirs, data into the buffers, else point them
    at the call's data; set the step counter to 0."""
    pairs = [(lp.W, state.W), (lp.A, state.A), (lp.B, state.B),
             (lp.C, state.C), (lp.code, code)]
    pairs += [(getattr(lp, name)[:len(tables[name])], tables[name])
              for name in _TABLES if tables.get(name) is not None]
    if lp.owns_x:
        pairs.append((lp.X, X))
    else:
        lp.X = X
    for dst, src in pairs:
        if dst is not None:
            dst.copy_(src)
    lp.step.zero_()


def _loop_step(lp: _Loop, spec: _StepSpec, gen, weights=None
               ) -> torch.Tensor:
    """One training step on the buffers ``lp``, its draws from ``gen``
    (or the given tables) at the step counter, which it advances, its
    weights ``(w, 1 - w)`` given as Python floats (the eager route) or,
    when None, from the weight table at the counter (the captured route,
    whose graph cannot take a new float a step). Returns the batch's
    code."""
    X, k = lp.X, lp.step
    n = X.shape[1]
    idx = None
    if spec.draws is not None:
        H0 = lp.H0.index_select(0, k)[0]
        if lp.idx is not None:
            idx = lp.idx.index_select(0, k)[0]
    elif spec.subsample and spec.sampling == "block":
        # a contiguous wrap-around block of the once-permuted pool at a
        # random offset (PARITY.md #12); on the card a column gather is
        # cheap, so the block is gathered rather than sliced from a tiled
        # copy
        off = torch.randint(0, n, (1,), generator=gen, device=X.device)
        idx = lp.perm.index_select(0, (off + lp.offsets) % n)
    elif spec.subsample:
        idx = torch.randint(0, n, (spec.batch,), generator=gen,
                            device=X.device)
    if spec.draws is None:
        H0 = torch.rand((lp.A.shape[0], n if idx is None else len(idx)),
                        generator=gen, dtype=X.dtype, device=X.device)
    code = lp.code
    if spec.cols is not None:       # this rank's columns of the batch
        lo, hi = spec.cols
        H0 = H0[:, lo:hi]
        if idx is None:
            X = X.narrow(1, lo, hi - lo)
            code = None if code is None else code.narrow(1, lo, hi - lo)
        else:
            idx = idx[lo:hi]
    Xb = X if idx is None else X.index_select(1, idx)
    if weights is None:
        weights = lp.w.index_select(0, k), lp.omw.index_select(0, k)
    H, W = _step_math(
        lp.W, lp.A, lp.B, lp.C, Xb, H0, *weights, spec.alpha, spec.sub_iter,
        spec.stopping_diff, spec.dict_from, spec.backend, spec.coder,
        spec.group, spec.tp, None if spec.cols is None else spec.group)
    if spec.track_code:
        if idx is None:
            code += H
        else:
            code.index_add_(1, idx, H)
    if spec.track_metrics:
        # the batch objective 0.5|Xb - W H|^2 + alpha|H|_1, post-update W
        # (this rank's columns of it where the batch is split)
        lp.metrics.index_copy_(0, k, (
            0.5 * torch.sum((Xb - W @ H) ** 2)
            + spec.alpha * torch.sum(H)).reshape(1))
    k += 1
    return H


def _clear_graphs() -> None:
    """Drop every captured step and round, with its buffers and memory
    pool: before the process group goes (a graph holds its all-reduce's
    communicator), and where ``debug_nans`` turns training to the eager
    route."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()        # no replay in flight
    _GRAPHS.clear()
    _ROUND_GRAPHS.clear()


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
    *,
    tp=None,
    global_batch: bool = False,
    capture: bool = True,
):
    """``iterations - 1`` steps (the JAX ``_train_scan``); every training
    path funnels through here. Returns ``(state, code, metrics)``, new
    tensors; ``code`` is not written. With a ``group``, ``X`` is this
    rank's shard: the pool permutation of block sampling is drawn alike on
    every rank (as the JAX scan draws it from the replicated key), the
    batches and ``H0`` from the rank generator. With ``global_batch``,
    ``X`` is whole on every rank instead, which draws the global batch
    from ``state.gen`` (or takes the given draws, alike on every rank) and
    codes its columns of it (:func:`batch_cols`); the code and metrics are
    then this rank's part, to be summed over ``group``. ``tp``: the group
    over which the state's W and B are sharded (:func:`_step_math`).

    :func:`_train_route` picks the route: on a CUDA tensor one step is
    captured as a CUDA graph (once per :func:`_graph_key`, in
    :data:`_GRAPHS`) and replayed for every step, its generator taking
    ``gen``'s state before the replays and giving it back after; on the
    CPU, under ``debug_nans``, with a gloo group or with
    ``capture=False`` (tests and the card's comparisons) the same step
    function runs in a Python loop. A capture or replay that fails raises;
    no step falls back to the eager loop."""
    if sampling not in ("iid", "block"):
        raise ValueError(f"sampling must be 'iid' or 'block', got {sampling!r}")
    n = X.shape[1]
    t0 = state.t
    gen = state.gen
    perm = None
    if subsample and sampling == "block" and draws is None:
        perm = torch.randperm(n, generator=gen, device=X.device)
    if draws is None and not global_batch:
        gen = rank_generator(gen, group)
    steps = max(iterations, 1) - 1
    if steps == 0:
        return state, code, torch.zeros((0,), dtype=X.dtype,
                                        device=X.device)
    mode, idx, H0 = (None, None, None) if draws is None \
        else _stack_draws(draws, steps, X)
    if mode is not None:
        batch = n if idx is None else idx.shape[1]
    else:
        batch = batch_size if subsample else n
    cols = None
    backends = set()
    if group is not None or tp is not None:
        import torch.distributed as dist

        backends = {str(dist.get_backend(g)) for g in (group, tp)
                    if g is not None}
        if global_batch and group is not None \
                and dist.get_world_size(group) > 1:
            cols = batch_cols(batch, dist.get_world_size(group))[
                dist.get_rank(group)]
    spec = _StepSpec(
        batch=batch, steps=steps, alpha=float(alpha), sub_iter=int(sub_iter),
        stopping_diff=stopping_diff, dict_from=dict_from, backend=backend,
        coder=coder, draws=mode, subsample=bool(subsample),
        sampling=sampling, track_code=bool(track_code),
        track_metrics=bool(track_metrics), group=group, tp=tp, cols=cols)
    tables = dict(perm=perm, idx=idx, H0=H0)
    # one backend for all the step's groups, else none that captures
    group_backend = (None if not backends else backends.pop()
                     if len(backends) == 1 else "mixed")
    route = _train_route(X.device.type, backend, group_backend,
                         state.A.shape[0], _DEBUG_NANS, capture)

    def fill(lp):
        _refill(lp, state, X, code, tables)
        return lp

    if route == "captured":
        tables["w"], tables["omw"] = _round_weights(t0, 1, iterations,
                                                    steps, beta, X.dtype)
        owns_x = X.numel() * X.element_size() <= _OWN_X_BYTES
        lp = _GRAPHS.run(
            _graph_key(X, state, spec), X.device, (gen,), steps,
            lambda: fill(_new_loop(state, X, code, spec, tables, owns_x)),
            fill, lambda lp, g: _loop_step(lp, spec, g),
            reads=() if owns_x else (X,), hold=False)
        if not owns_x:
            lp.X = None         # read in place: not held past the call
    else:
        lp = fill(_new_loop(state, X, code, spec, tables))
        for i in range(1, steps + 1):
            w_t = (t0 + i) ** (-float(beta))     # as _step_inner has it
            H = _loop_step(lp, spec, gen, (w_t, 1.0 - w_t))
            if _DEBUG_NANS:
                _check_finite(lp, H, t0 + i)

    take = functools.partial(_take, route == "captured")
    st = dataclasses.replace(state, W=take(lp.W), A=take(lp.A),
                             B=take(lp.B), C=take(lp.C),
                             t=t0 + float(iterations))
    metrics = take(lp.metrics[:steps]) if track_metrics \
        else torch.zeros((0,), dtype=X.dtype, device=X.device)
    return st, take(lp.code) if track_code else code, metrics


# -------------------------------------------------------------- the rounds:
# one round of an app (its sampler, its patches, its inner steps) on static
# buffers, called in a Python loop (eager) or captured once as a CUDA graph
# and replayed a round at a time (captured), the counterpart of the JAX
# apps' outer lax.scan over rounds.

# Round graphs kept at once (utils/capture.py): each holds the state's
# buffers, the app's and a weight table of its capacity.
_ROUND_GRAPHS = GraphCache("round", 8, spans="train")
# The most inner steps (with a network round's chain blocks) that a round
# graph holds; a longer round runs on the per-round route. A capture costs
# two to three rounds of work at every size measured (chip_profile.py
# capture), but its instantiation (~10 us a device operation, ~20 of them
# a step) and the host memory it holds grow with the steps: 512 keeps a
# graph near 0.1 s and 20 MB, 5x NetworkReconstructor's default.
_MAX_ROUND_STEPS = 512


@dataclasses.dataclass
class _Round:
    """The buffers a round reads and writes in place: the step's
    (``loop``: the state, the code, the step counter and, on the captured
    route, the weight table of every step of the run), the round
    counter ``rnd`` that indexes the app's tables, the app's carried
    tensors ``carry`` (filled at the start of a run) and its per-round
    outputs ``outs`` (written at the round counter)."""

    loop: _Loop
    rnd: torch.Tensor
    carry: dict
    outs: dict


@dataclasses.dataclass
class _RoundCtx:
    """What a round function is handed besides its buffers and generator:
    ``steps(X)`` runs the round's inner steps on its data X; ``draw`` is
    the round's given draws (``(app's part, inner draws)``) or None;
    ``graphs`` says whether a part of the round (the chains) may replay
    graphs of its own, which only the per-round route allows, and there
    not with ``capture=False``."""

    steps: object
    draw: object
    graphs: bool


def _round_route(device_type: str, backend: str, group_backend, world: int,
                 r: int, debug_nans: bool, steps: int, host_read: bool,
                 capture: bool = True) -> str:
    """How :func:`_run_rounds` runs an app's rounds, from these arguments
    alone: ``"captured"`` (one round captured as a CUDA graph and replayed
    a round at a time) where :func:`_train_route` would capture the steps
    (not with ``capture=False``), the round holds no host read
    (``host_read``: a sampler on the host, given draws), one rank draws
    (``world`` 1: several draw a rank generator every round) and its
    ``steps`` (inner steps and chain blocks) are at most
    :data:`_MAX_ROUND_STEPS`; else ``"per_round"`` (the round function in
    a Python loop, its inner steps through :func:`_train_loop`, which
    replays its step graph on the card and runs eagerly on the CPU and
    with ``capture=False``)."""
    if (not host_read and world == 1 and steps <= _MAX_ROUND_STEPS
            and _train_route(device_type, backend, group_backend, r,
                             debug_nans, capture) == "captured"):
        return "captured"
    return "per_round"


def _round_capacity(rounds: int) -> int:
    """The rounds a captured round's tables hold: ``rounds`` rounded up to
    a power of two, so that runs of a few lengths share a graph."""
    return 1 << max(rounds - 1, 0).bit_length()


def _round_weights(t0: float, rounds: int, iterations: int, steps: int,
                   beta: float, dtype):
    """``(w, 1 - w)``, (rounds * steps,): round j's step i (from 1) at
    ``t = t_j + i``, ``t_j`` the counter after j rounds (from ``t0``, each
    round adding ``iterations`` as :func:`_train_loop` adds it): each
    computed on the host in float64 as :func:`_step_inner` computes its
    Python floats, then rounded once to ``dtype``, as such a float is where
    it multiplies a tensor of that dtype. One round is the step's table
    (:func:`_train_loop`)."""
    ts, t = [], t0
    for _ in range(rounds):
        ts += [t + i for i in range(1, steps + 1)]
        t = t + float(iterations)
    w = [v ** (-float(beta)) for v in ts]
    return (torch.tensor(w, dtype=torch.float64).to(dtype),
            torch.tensor([1.0 - v for v in w], dtype=torch.float64).to(dtype))


def _round_key(state, code, spec: _StepSpec, app: tuple, reads: tuple,
               carry: dict, outs: dict, cap: int, generators: int) -> tuple:
    """The cache key of a round graph: all that a capture bakes in. The
    app's round parameters ``app`` (its name first), the step's spec, the
    state's device, dtype, shape and whether it tracks X Xᵀ, the code's
    shape, the address, shape, strides and dtype of every tensor the round
    reads in place (``reads``: the image, the frames, the graph's tensors
    and the motif's tables), the shape and dtype of the carried tensors and
    of the outputs, the capacity in rounds and the number of generators
    the round draws from. Not the run's exact number of rounds, ``beta``,
    the counter ``t``, the generators themselves or any value."""
    return (app, spec, state.W.device, state.W.dtype, tuple(state.W.shape),
            state.tracks_xxt, None if code is None else tuple(code.shape),
            tuple(tensor_at(t) for t in reads),
            tuple((name, tuple(v.shape), v.dtype)
                  for name, v in carry.items()),
            tuple((name, tuple(shape), dtype)
                  for name, (shape, dtype) in outs.items()), cap, generators)


def _new_round(state, code, spec: _StepSpec, cap: int, carry: dict,
               outs: dict) -> _Round:
    """Buffers for runs of up to ``cap`` rounds like this one, the weight
    table not among them; not filled."""
    dev = state.W.device
    return _Round(
        loop=_new_loop(state, None, code, spec, {}),
        rnd=torch.zeros(1, dtype=torch.long, device=dev),
        carry={name: _like(v, dev) for name, v in carry.items()},
        outs={name: torch.empty((cap,) + tuple(shape), dtype=dtype,
                                device=dev)
              for name, (shape, dtype) in outs.items()})


def _fill_round(rb: _Round, state, code, carry: dict,
                weights=None) -> None:
    """Copy a run's state, code, carried tensors and, where given, its
    weight table (a prefix of the buffer) into the buffers; set both
    counters to 0."""
    _refill(rb.loop, state, None, code,
            dict(zip(("w", "omw"), weights or ())))
    for name, v in carry.items():
        rb.carry[name].copy_(v)
    rb.rnd.zero_()


def _round_steps(lp: _Loop, spec: _StepSpec, gen, X) -> None:
    """A round's inner steps on the buffers (the captured route):
    ``spec.steps`` calls of :func:`_loop_step` on the round's data
    ``X``, their weights from the table at the step counter, which runs on
    over the rounds."""
    lp.X = X
    for _ in range(spec.steps):
        _loop_step(lp, spec, gen)


def _run_rounds(state, code, spec: _StepSpec, *, rounds: int,
                iterations: int, beta: float, round_fn, gen, app: tuple,
                reads: tuple = (), carry: dict | None = None,
                outs: dict | None = None, blocks: int = 0,
                host_read: bool = False, draws=None, capture: bool = True):
    """``rounds`` rounds of an app, each ``round_fn(rb, gen, ctx)`` on the
    buffers ``rb`` (:class:`_Round`), with ``ctx.steps(X)`` running its
    ``iterations - 1`` inner steps (``spec``) on its data X; the round
    counter advances after each. ``gen`` draws the round's own numbers,
    ``state.gen`` the steps' (they may be one generator). ``carry``: the
    app's tensors that the rounds read and write (copied, not written);
    ``outs``: ``{name: (shape, dtype)}`` of what each round writes at the
    round counter; ``reads``: the tensors the round reads in place;
    ``app``: its round parameters (the key's); ``blocks``: the chain
    blocks of a round; ``draws``: per round ``(app's part, inner draws)``,
    given (tests).

    :func:`_round_route` picks the route. On the captured route one round
    is captured once per :func:`_round_key` (its first round run as it is
    captured) and replayed for the rest, its generators taking the
    callers' states before and giving them back after; state and carried
    tensors are copied into its buffers once at the start and cloned out
    once at the end. On the per-round route (the CPU, ``capture=False``
    and what a graph cannot take) the round function runs in a Python
    loop, its inner steps a call of :func:`_train_loop` with ``capture``.
    A capture or replay that fails raises; no round falls back to the
    per-round loop. Returns ``(state, code, carry, outs)``, the outputs'
    first ``rounds`` rows.

    Spans (``utils/profiling.py``): on the captured route
    ``train.weights`` (the weight table, made and copied to the card),
    ``train.fill``, ``train.capture`` (a cache miss), ``train.replay``
    (with its device time) and ``train.copy_out``; on the per-round route
    ``train.fill``, ``train.round`` for each round and
    ``train.copy_out``."""
    carry, outs = carry or {}, outs or {}
    if rounds <= 0:
        return state, code, dict(carry), {
            name: torch.empty((0,) + tuple(shape), dtype=dtype,
                              device=state.W.device)
            for name, (shape, dtype) in outs.items()}
    steps_gen = state.gen
    gens = (steps_gen,) if gen is steps_gen else (steps_gen, gen)
    group_backend, world = None, 1
    if spec.group is not None:
        import torch.distributed as dist

        group_backend = str(dist.get_backend(spec.group))
        world = dist.get_world_size(spec.group)
    route = _round_route(state.W.device.type, spec.backend, group_backend,
                         world, state.r, _DEBUG_NANS, spec.steps + blocks,
                         host_read, capture=capture)
    t_end = state.t
    for _ in range(rounds):
        if spec.steps:                  # as _train_loop advances t
            t_end = t_end + float(iterations)
    weights = None                      # the captured route's table

    def fill(rb):
        with span("train.fill"):
            _fill_round(rb, state, code, carry, weights)
        return rb

    if route == "captured":
        dev = state.W.device
        cap = _round_capacity(rounds)
        key = _round_key(state, code, spec, app, reads, carry, outs, cap,
                         len(gens))
        with span("train.weights"):
            weights = tuple(w.to(dev) for w in _round_weights(
                state.t, rounds, iterations, spec.steps, beta,
                state.W.dtype))

        def new():
            rb = _new_round(state, code, spec, cap, carry, outs)
            rb.loop.w = torch.empty(cap * spec.steps, dtype=state.W.dtype,
                                    device=dev)
            rb.loop.omw = torch.empty_like(rb.loop.w)
            return fill(rb)

        def one(rb, *gs):
            round_fn(rb, gs[-1], _RoundCtx(
                functools.partial(_round_steps, rb.loop, spec, gs[0]),
                None, False))
            rb.rnd += 1

        rb = _ROUND_GRAPHS.run(key, dev, gens, rounds, new, fill, one,
                               reads=reads)
    else:
        rb = fill(_new_round(state, code, spec, rounds, carry, outs))
        lp, t = rb.loop, state.t

        def steps(inner, X):            # the steps through _train_loop
            nonlocal t
            st = dataclasses.replace(state, W=lp.W, A=lp.A, B=lp.B, C=lp.C,
                                     t=t)
            st, new_code, _ = _train_loop(
                st, X, lp.code, spec.alpha, beta, spec.stopping_diff,
                iterations, spec.batch, spec.subsample, spec.sub_iter,
                spec.track_code, spec.dict_from, backend=spec.backend,
                draws=inner, coder=spec.coder, group=spec.group,
                capture=capture)
            for dst, src in ((lp.W, st.W), (lp.A, st.A), (lp.B, st.B),
                             (lp.C, st.C), (lp.code, new_code)):
                if dst is not None and dst is not src:
                    dst.copy_(src)
            t = st.t

        for j in range(rounds):
            draw = None if draws is None else draws[j]
            with span("train.round"):
                round_fn(rb, gens[-1], _RoundCtx(
                    functools.partial(steps,
                                      None if draw is None else draw[1]),
                    draw, capture))
                rb.rnd += 1

    take = functools.partial(_take, route == "captured")
    lp = rb.loop
    with span("train.copy_out"):
        st = dataclasses.replace(state, W=take(lp.W), A=take(lp.A),
                                 B=take(lp.B), C=take(lp.C), t=t_end)
        return (st, take(lp.code) if spec.track_code else code,
                {name: take(v) for name, v in rb.carry.items()},
                {name: take(v[:rounds]) for name, v in rb.outs.items()})


def _round_spec(width: int, iterations: int, batch_size: int,
                subsample: bool, alpha: float, sub_iter: int, stopping_diff,
                track_code: bool, dict_from: str, backend: str, coder: str,
                group=None) -> _StepSpec:
    """The inner step of a round on data of ``width`` columns, as
    :func:`_train_loop` would run it (iid minibatches, no given draws, no
    metrics)."""
    return _StepSpec(
        batch=batch_size if subsample else width,
        steps=max(iterations, 1) - 1, alpha=float(alpha),
        sub_iter=int(sub_iter), stopping_diff=stopping_diff,
        dict_from=dict_from, backend=backend, coder=coder, draws=None,
        subsample=bool(subsample), sampling="iid",
        track_code=bool(track_code), track_metrics=False, group=group)


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
        state, X, code, alpha, beta, stopping_diff, int(iterations),
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

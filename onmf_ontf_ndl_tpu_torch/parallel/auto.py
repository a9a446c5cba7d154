"""Placement of the state and ``train_dict`` over a two-axis mesh.

Counterpart of ``onmf_ontf_ndl_tpu/parallel/auto.py``, which annotates
shardings (the data's columns over ``dp``, optionally the dictionary's
columns over ``tp``) and lets XLA's partitioner insert the collectives.
PyTorch has no partitioner in the port's path: :func:`shard_state` places
the state by hand, and :func:`auto_train_dict` runs the training loop
(``models/onmf.py::_train_loop``) with the collectives the partitioner
would insert written into its step (``_step_math``): the statistics
summed over ``dp``, W, the projection's rows and B's rows gathered over
``tp``. As in JAX, the run is ``train_dict``'s: the same batches, the
same stop, the same state and code.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from onmf_ontf_ndl_tpu_torch.models.onmf import (
    _all_gather_rows, _all_reduce, _check_modes, _train_loop)
from onmf_ontf_ndl_tpu_torch.models.state import OnmfState
from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend
from onmf_ontf_ndl_tpu_torch.parallel.dp import _on
from onmf_ontf_ndl_tpu_torch.parallel.mesh import Mesh

__all__ = ["shard_state", "unshard_state", "auto_train_dict"]


@dataclasses.dataclass(frozen=True)
class TpSharding:
    """Where a state's W columns and B rows are split: over axis ``axis``
    of ``mesh``, the rank at coordinate j of it holding columns
    ``j r / tp`` to ``(j + 1) r / tp`` of the rank-``r`` dictionary."""

    mesh: Mesh
    axis: str
    r: int


def _whole_group(mesh, group):
    """The process group over all of ``mesh``'s ranks (``mesh`` a
    :class:`Mesh` or a one-axis mesh's group), else ``group``, else the
    world's."""
    if isinstance(mesh, Mesh):
        return mesh.group
    if mesh is not None:
        return mesh
    return group if group is not None else dist.group.WORLD


def unshard_state(state: OnmfState) -> OnmfState:
    """The state with its whole W and B on every rank (gathered over the
    ``tp`` axis where :func:`shard_state` split them): the counterpart of
    ``np.asarray`` on a JAX global array. A state that is not sharded is
    returned as it is."""
    sh = state.sharding
    if sh is None:
        return state
    tp = sh.mesh.get_group(sh.axis)
    return dataclasses.replace(
        state, W=_all_gather_rows(state.W.T, tp).T.contiguous(),
        B=_all_gather_rows(state.B, tp), sharding=None)


def shard_state(state: OnmfState, mesh=None, *, tp_axis: str | None = None,
                group=None) -> OnmfState:
    """Place the state on the mesh's ranks: every rank takes the first
    rank's ``W, A, B, C``, step counter and generator state (a sharded
    state is gathered first, :func:`unshard_state`). With ``tp_axis``
    (``mesh`` a :class:`Mesh`), the rank at coordinate j of that axis then
    keeps columns ``j r / tp`` to ``(j + 1) r / tp`` of W and the same rows
    of B, as JAX's ``P(None, tp)`` and ``P(tp, None)`` place them; A, C,
    the counter and the generator stay replicated. ``mesh`` None:
    ``group``'s ranks (the world's when None)."""
    state = unshard_state(state)
    if tp_axis is not None:
        if not isinstance(mesh, Mesh):
            raise ValueError(f"tp_axis={tp_axis!r} needs a named mesh "
                             "(make_mesh with two or more axes)")
        tp = mesh.size(tp_axis)
        if state.r % tp:
            raise ValueError(f"the dictionary's {state.r} columns should be "
                             f"divisible by {tp}, the size of mesh axis "
                             f"{tp_axis!r}")
    group = _whole_group(mesh, group)
    src = dist.get_global_rank(group, 0)
    out = {}
    for name in ("W", "A", "B", "C"):
        t = getattr(state, name).clone()
        if t.numel():               # C is (0, 0) where X Xᵀ is untracked
            dist.broadcast(t, src=src, group=group)
        out[name] = t
    meta = [state.t, state.gen.get_state()]
    dist.broadcast_object_list(meta, src=src, group=group,
                               device=state.W.device
                               if state.W.device.type == "cuda" else None)
    gen = torch.Generator(device=state.gen.device)
    gen.set_state(meta[1])
    sharding = None
    if tp_axis is not None:
        r_l = state.r // tp
        lo = mesh.coordinate(tp_axis) * r_l
        out["W"] = out["W"][:, lo:lo + r_l].contiguous()
        out["B"] = out["B"][lo:lo + r_l].contiguous()
        sharding = TpSharding(mesh, tp_axis, state.r)
    return dataclasses.replace(state, t=float(meta[0]), gen=gen,
                               sharding=sharding, **out)


def auto_train_dict(
    state: OnmfState,
    X,
    *,
    mesh=None,
    dp_axis: str = "dp",
    tp_axis: str | None = None,
    group=None,
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
    device="cuda",
):
    """:func:`~onmf_ontf_ndl_tpu_torch.models.onmf.train_dict` over a mesh,
    with its arguments, defaults and results: ``(state, code)``, plus the
    per-step objectives with ``return_metrics=True``.

    ``mesh``: a :class:`Mesh` (``make_mesh({"dp": a, "tp": b})``), whose
    ``dp_axis`` splits the batch and ``tp_axis`` (optional) the dictionary;
    or a one-axis mesh's group, or None for ``group`` (the world's when
    None), over which the batch is split. Every rank gets ``X`` (d, n)
    whole and draws one global batch a step from the replicated state's
    generator (or takes ``draws``, given alike to every rank); each ``dp``
    rank codes its whole tiles of it (``models/onmf.py::batch_cols``), the
    statistics and the early stop's norms summed over ``dp``. The state is
    placed by :func:`shard_state` first; the returned state holds this
    rank's shards under ``tp_axis`` (:func:`unshard_state` reads them
    whole), the code and objectives are summed over ``dp``, whole on every
    rank.
    """
    _check_modes(dict_from, coder)
    dev = _on(state, device)
    if isinstance(mesh, Mesh):
        dp = mesh.get_group(dp_axis)
        tp = None if tp_axis is None else mesh.get_group(tp_axis)
    else:
        dp, tp = _whole_group(mesh, group), None
    state = shard_state(state, mesh, tp_axis=tp_axis, group=group)
    X = torch.as_tensor(X, dtype=state.W.dtype, device=dev)
    code = torch.zeros((state.A.shape[0], X.shape[1]), dtype=X.dtype,
                       device=dev) if code0 is None else code0
    metrics = torch.zeros((0,), dtype=X.dtype, device=dev)
    if iterations > 1:
        world = dist.get_world_size(dp)
        # the ranks' parts of the code are summed: code0 counts once
        own = code if (world == 1 or not track_code
                       or dist.get_rank(dp) == 0) else torch.zeros_like(code)
        state, own, metrics = _train_loop(
            state, X, own, alpha, beta, stopping_diff, int(iterations),
            int(batch_size), bool(subsample), int(sub_iter),
            bool(track_code), dict_from, backend=resolve_backend(backend, X),
            track_metrics=bool(return_metrics), sampling=sampling,
            draws=draws, coder=coder, group=dp, tp=tp, global_batch=True)
        if world > 1 and (track_code or return_metrics):
            own, metrics = _all_reduce(
                [own if track_code else own.new_zeros(0), metrics], dp)
        code = own if track_code else code
    if return_metrics:
        return state, code, metrics
    return state, code

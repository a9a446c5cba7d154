"""Placement of the state and the data-parallel trainer.

Counterpart of ``onmf_ontf_ndl_tpu/parallel/auto.py``, which lets XLA's
partitioner insert the collectives for sharded inputs. PyTorch has no
partitioner in the port's path: the state is replicated by a broadcast
from the group's first rank, and :func:`auto_train_dict` is
:func:`~onmf_ontf_ndl_tpu_torch.parallel.dp.dp_train_dict`, whose explicit
``all_reduce`` is the collective the partitioner would insert.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from onmf_ontf_ndl_tpu_torch.models.state import OnmfState

__all__ = ["shard_state", "auto_train_dict"]


def shard_state(state: OnmfState, group=None) -> OnmfState:
    """Replicate the state over ``group`` (the world group when ``None``):
    every rank takes the first rank's ``W, A, B, C``, step counter and
    generator state."""
    group = group if group is not None else dist.group.WORLD
    src = dist.get_global_rank(group, 0)
    out = {}
    for name in ("W", "A", "B", "C"):
        t = getattr(state, name).clone()
        dist.broadcast(t, src=src, group=group)
        out[name] = t
    meta = [state.t, state.gen.get_state()]
    dist.broadcast_object_list(meta, src=src, group=group,
                               device=state.W.device
                               if state.W.device.type == "cuda" else None)
    gen = torch.Generator(device=state.gen.device)
    gen.set_state(meta[1])
    return dataclasses.replace(state, t=float(meta[0]), gen=gen, **out)


def auto_train_dict(state: OnmfState, X, *, group=None, **train_kwargs):
    """:func:`~onmf_ontf_ndl_tpu_torch.parallel.dp.dp_train_dict` from a
    replicated state (:func:`shard_state`)."""
    from onmf_ontf_ndl_tpu_torch.parallel.dp import dp_train_dict

    return dp_train_dict(shard_state(state, group), X, group=group,
                         **train_kwargs)

"""Process groups in place of device meshes.

Counterpart of ``onmf_ontf_ndl_tpu/parallel/mesh.py``. A JAX mesh names
axes over a device array; the port's parallel layer has one axis, data
parallelism, and runs it over a ``torch.distributed`` process group of
one rank per device.
"""

from __future__ import annotations

import math

import torch.distributed as dist

__all__ = ["make_mesh"]


def make_mesh(axes: dict[str, int] | None = None, devices=None):
    """The process group over the ranks ``devices`` (every rank when
    ``None``: the world group, ``dist.group.WORLD``).

    ``axes`` maps axis names to sizes; their product must equal the number
    of ranks. Named axes have no counterpart here: the group is one
    data-parallel axis over all of them. A group over some of the ranks is
    built with ``dist.new_group``, which every rank must call alike.
    """
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    if axes is not None and math.prod(axes.values()) != len(ranks):
        raise ValueError(
            f"mesh axes {axes} need {math.prod(axes.values())} ranks, "
            f"have {len(ranks)}")
    if devices is None:
        return dist.group.WORLD
    return dist.new_group(ranks)

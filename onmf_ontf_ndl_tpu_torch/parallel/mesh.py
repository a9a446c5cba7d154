"""Process groups in place of device meshes.

Counterpart of ``onmf_ontf_ndl_tpu/parallel/mesh.py``. A JAX mesh names
axes over a device array; the port runs one rank per device in a
``torch.distributed`` job. One axis (or none) is a process group, the
data-parallel layer's; two or more axes make a :class:`Mesh`, whose axes
keep their names and give each rank the process group along each of them
(``{"dp": a, "tp": b}``: data parallelism over ``dp``, the dictionary's
columns over ``tp``; ``parallel/auto.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch.distributed as dist

__all__ = ["make_mesh", "Mesh"]


class Mesh:
    """A named mesh of ranks: ``ranks`` laid out row-major over ``axes``
    (the last axis fastest, as JAX lays its device array out), so rank
    ``ranks[i]`` sits where JAX's device ``i`` sits.

    ``group`` is the process group over all of its ranks;
    :meth:`get_group` is this rank's group along an axis, in the axis's
    coordinate order; :meth:`coordinate` its index along it. Building one
    calls ``dist.new_group`` once for every line along every axis, which
    every rank of the job must do alike.
    """

    def __init__(self, axes: dict[str, int], ranks: list[int]):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.ranks = list(ranks)
        world = dist.get_world_size()
        self.group = (dist.group.WORLD if self.ranks == list(range(world))
                      else dist.new_group(self.ranks))
        me = dist.get_rank()
        grid = np.asarray(self.ranks).reshape(tuple(axes.values()))
        self._groups, self._coords = {}, {}
        for ax, name in enumerate(self.axis_names):
            for line in np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax]):
                line = [int(r) for r in line]
                # a group's ranks are in ascending order: the axis's
                # coordinates must be too
                if line != sorted(line):
                    raise ValueError(f"mesh axis {name!r}: ranks {line} do "
                                     "not ascend along it")
                group = (dist.group.WORLD if line == list(range(world))
                         else dist.new_group(line))
                if me in line:
                    self._groups[name] = group
                    self._coords[name] = line.index(me)

    def get_group(self, name: str):
        """This rank's process group along axis ``name``."""
        return self._groups[name]

    def coordinate(self, name: str) -> int:
        """This rank's index along axis ``name``."""
        return self._coords[name]

    def size(self, name: str) -> int:
        return self.shape[name]


def make_mesh(axes: dict[str, int] | None = None, devices=None):
    """The mesh over the ranks ``devices`` (every rank when ``None``).

    ``axes`` maps axis names to sizes; their product must equal the number
    of ranks. With two or more axes the result is a :class:`Mesh`. With
    one axis or none it is the process group of the data-parallel layer:
    the world group (``dist.group.WORLD``) over every rank, else a group
    built with ``dist.new_group``, which every rank must call alike.
    """
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    if axes is not None and math.prod(axes.values()) != len(ranks):
        raise ValueError(
            f"mesh axes {axes} need {math.prod(axes.values())} ranks, "
            f"have {len(ranks)}")
    if axes is not None and len(axes) >= 2:
        return Mesh(axes, ranks)
    if devices is None:
        return dist.group.WORLD
    return dist.new_group(ranks)

"""Multi-process entry point over ``torch.distributed``.

Counterpart of ``onmf_ontf_ndl_tpu/parallel/multihost.py``. Where the JAX
package joins every process's chips into one global device set
(``jax.distributed.initialize``) and builds a mesh over it, the port joins
one process per device into a process group: one rank is one device. The
data-parallel layer (``parallel/dp.py``) sums its statistics over that
group with ``all_reduce``.

Launch (the same command on every process)::

    from onmf_ontf_ndl_tpu_torch.parallel import multihost
    multihost.initialize()                    # env:// (torchrun's variables)
    group = multihost.global_mesh()           # the world group
    ... dp_train_dict(state, X, ..., group=group)
    mesh = multihost.global_mesh({"dp": hosts, "tp": gpus_per_host})
    ... auto_train_dict(state, X, mesh=mesh, tp_axis="tp", ...)

or explicitly::

    multihost.initialize(coordinator_address="host0:29500",
                         num_processes=4, process_id=rank)

The backend follows ``device``: ``"cuda"`` (the default) takes NCCL and
binds the rank's local GPU first; ``"cpu"`` takes gloo. Neither stands in
for the other.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from onmf_ontf_ndl_tpu_torch.models.state import entry_device

__all__ = ["initialize", "shutdown", "global_mesh", "is_initialized",
           "process_count", "process_index", "local_device_count"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None, *, device="cuda") -> None:
    """Join (or start) the process group.

    With no arguments the rendezvous is ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them).
    ``coordinator_address`` (``host:port``, rank 0's) with
    ``num_processes`` and ``process_id`` gives it explicitly. On the card
    the rank binds ``local_device_ids[0]``, else ``LOCAL_RANK``, else its
    rank modulo the local device count. A second call is a no-op.
    """
    if is_initialized():
        return
    device = entry_device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = -1 if num_processes is None else int(num_processes)
    rank = -1 if process_id is None else int(process_id)
    if device.type == "cuda":
        if local_device_ids is not None:
            local = int(list(local_device_ids)[0])
        elif "LOCAL_RANK" in os.environ:
            local = int(os.environ["LOCAL_RANK"])
        else:
            r = rank if rank >= 0 else int(os.environ.get("RANK", 0))
            local = r % torch.cuda.device_count()
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)


def shutdown() -> None:
    """Leave the process group (for clean teardown), after dropping the
    captured training steps, whose graphs may hold its collectives."""
    if is_initialized():
        from onmf_ontf_ndl_tpu_torch.models.onmf import _clear_graphs

        _clear_graphs()
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_device_count() -> int:
    """The devices of this host that ranks can take: its CUDA devices, or
    1 (its CPU) where it has none."""
    return torch.cuda.device_count() or 1


def global_mesh(axes: dict[str, int] | None = None):
    """The mesh over every rank of the job
    (:func:`~onmf_ontf_ndl_tpu_torch.parallel.mesh.make_mesh` over the
    world): the world group with one axis or none; with two or more a
    named :class:`~onmf_ontf_ndl_tpu_torch.parallel.mesh.Mesh`, e.g.
    ``{"dp": hosts, "tp": local_device_count()}``: dp across hosts, tp
    within a host, the ranks of a host consecutive."""
    from onmf_ontf_ndl_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axes)

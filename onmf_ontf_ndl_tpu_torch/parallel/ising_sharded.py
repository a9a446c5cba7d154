"""Row-sharded checkerboard Ising sweeps with a halo exchange.

Counterpart of ``onmf_ontf_ndl_tpu/parallel/ising_sharded.py``: the (n, n)
lattice is cut into equal row bands, one per rank of a process group, and
before each colour every band sends its first row to the rank above and
its last row to the rank below (torus wrap-around) with ``send``/``recv``,
as the JAX function's ring ``ppermute`` does. Each band then runs one
colour through the banded entry of the checkerboard kernel
(``ops/kernels/ising_kernel.py::checkerboard_band_half``).

The Philox counters of the port's sampler are keyed by the global
colour-site index, so a sharded run equals the one-device
:func:`~onmf_ontf_ndl_tpu_torch.samplers.ising.checkerboard_sweeps` site
for site (the JAX function only matches its stationary law).
:func:`banded_checkerboard_sweeps` runs the same bands in one process,
with the halo exchange done by copies.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from onmf_ontf_ndl_tpu_torch.models.state import entry_device
from onmf_ontf_ndl_tpu_torch.ops.kernels.ising_kernel import (
    checkerboard_band_half)

__all__ = ["sharded_checkerboard_sweeps", "banded_checkerboard_sweeps"]


def _sweep_bands(seed, bands, firsts, nsweeps, J, H, T, exchange):
    """``nsweeps`` sweeps of the bands (in place): before each colour
    ``exchange(bands)`` gives each band its (above, below) halo rows."""
    for sweep in range(int(nsweeps)):
        for colour in (0, 1):
            halos = exchange(bands)
            for band, first, (above, below) in zip(bands, firsts, halos):
                checkerboard_band_half(seed, band, above, below, first,
                                       sweep, colour, J, H, T)
    return bands


def _copy_halos(bands):
    """The halo rows of bands held in one process: copies of the
    neighbours' boundary rows."""
    k = len(bands)
    return [(bands[i - 1][-1].clone(), bands[(i + 1) % k][0].clone())
            for i in range(k)]


def _exchange(group):
    """The halo exchange of one band per rank: my last row goes to the
    next rank (its row above), my first row to the previous rank (its row
    below). Sends and receives to one peer are issued in the order the peer
    posts them, so the pairs match on NCCL (which ignores tags) also with
    two ranks, where the previous and the next rank are one."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    prev = dist.get_global_rank(group, (rank - 1) % world)
    nxt = dist.get_global_rank(group, (rank + 1) % world)

    def exchange(bands):
        (band,) = bands
        if world == 1:
            return _copy_halos(bands)
        above = torch.empty_like(band[0])
        below = torch.empty_like(band[0])
        ops = [dist.P2POp(dist.isend, band[-1].contiguous(), nxt, group, 0),
               dist.P2POp(dist.isend, band[0].contiguous(), prev, group, 1),
               dist.P2POp(dist.irecv, above, prev, group, 0),
               dist.P2POp(dist.irecv, below, nxt, group, 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [(above, below)]

    return exchange


def sharded_checkerboard_sweeps(seed: int, band, nsweeps: int,
                                J: float = 1.0, H: float = 0.0,
                                T: float = 0.5, group=None, *,
                                device="cuda") -> torch.Tensor:
    """``nsweeps`` red/black heat-bath sweeps of an (n, n) int8 +-1 torus
    held as row bands over ``group`` (the world group when ``None``): rank
    r holds rows ``r * n / world`` .. ``(r + 1) * n / world - 1`` as
    ``band`` (n / world, n). Returns this rank's new band, equal site for
    site to the same rows of ``checkerboard_sweeps(seed, lattice, ...)``.
    ``device`` (the card by default; a CPU run passes ``"cpu"``) places the
    band: on the card the kernel runs and NCCL carries the halos, on the
    CPU the plain version runs and gloo carries them."""
    band = torch.as_tensor(band, device=entry_device(device))
    group = group if group is not None else dist.group.WORLD
    world = dist.get_world_size(group)
    rows, n = band.shape
    if rows * world != n:
        raise ValueError(f"a band of {rows} rows on each of {world} ranks "
                         f"does not make an ({n}, {n}) lattice")
    first = dist.get_rank(group) * rows
    (out,) = _sweep_bands(seed, [band.to(torch.int8).clone()], [first],
                          nsweeps, J, H, T, _exchange(group))
    return out


def banded_checkerboard_sweeps(seed: int, lattice: torch.Tensor,
                               nsweeps: int, bands: int, J: float = 1.0,
                               H: float = 0.0, T: float = 0.5) -> torch.Tensor:
    """:func:`sharded_checkerboard_sweeps` in one process: the (n, n)
    lattice in ``bands`` equal row bands, each swept by the banded entry,
    the halos copied between them before each colour. Returns the
    reassembled lattice."""
    n = lattice.shape[0]
    if n % bands:
        raise ValueError(f"{bands} equal bands do not split {n} rows")
    rows = n // bands
    parts = [lattice[i * rows:(i + 1) * rows].to(torch.int8).clone()
             for i in range(bands)]
    _sweep_bands(seed, parts, [i * rows for i in range(bands)], nsweeps,
                 J, H, T, _copy_halos)
    return torch.cat(parts)

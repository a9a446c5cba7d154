"""2-D Ising model samplers on the torus, in PyTorch.

Counterpart of ``onmf_ontf_ndl_tpu/samplers/ising.py``, with the same
Hamiltonian and acceptance rules:

- :func:`metropolis_chain` and :func:`ising_diagnostics`: the exact
  sequential single-site Metropolis chain (one random site per step;
  ``dE = 2 s0 (H + J sn)``, accept iff ``dE < 0`` or ``u < exp(-dE/T)``, in
  float32 as the JAX chain computes it). A chain of single-site steps is not
  a device workload: it runs as a host loop, and a CUDA lattice comes back
  on its device.
- :func:`checkerboard_sweeps`: red/black heat-bath sweeps. A CUDA lattice
  runs the kernel of ``ops/kernels/ising_kernel.py``, a CPU lattice its
  plain version; both draw from the counter-based stream of an explicit
  32-bit ``seed`` (the JAX function takes a key, whose threefry bits torch
  cannot reproduce).

Randomness comes from explicit ``torch.Generator``s and seeds. ``draws=``
replaces a chain's per-step ``(i, j, u)`` with values given from outside
(tests replay the JAX draws through it).
"""

from __future__ import annotations

import numpy as np
import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels import ising_kernel

__all__ = [
    "init_lattice",
    "hamiltonian",
    "delta_e",
    "metropolis_chain",
    "checkerboard_sweeps",
    "ising_diagnostics",
]


def init_lattice(gen: torch.Generator, n: int) -> torch.Tensor:
    """Random +-1 int8 spin configuration on the generator's device."""
    bits = torch.randint(0, 2, (n, n), generator=gen, device=gen.device)
    return (1 - 2 * bits).to(torch.int8)


def _neighbor_sum(lattice: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 torus neighbours at every site."""
    return (torch.roll(lattice, 1, 0) + torch.roll(lattice, -1, 0)
            + torch.roll(lattice, 1, 1) + torch.roll(lattice, -1, 1))


def hamiltonian(lattice: torch.Tensor, J: float, H: float) -> torch.Tensor:
    """``-J * sum_adj s_i s_j - H * sum s_i`` (each adjacent pair counted
    twice, the reference's convention), in float32."""
    s = lattice.to(torch.float32)
    return torch.sum(s * (-J * _neighbor_sum(s) - H))


def delta_e(s0, sn, J, H):
    """Energy difference of flipping spin s0 with neighbour sum sn."""
    return 2.0 * s0 * (H + J * sn)


def _chain_draws(gen, n: int, nsteps: int, draws):
    """Per-step sites and uniforms ``(i, j, u)`` as host lists."""
    if draws is None:
        kw = dict(generator=gen, device=gen.device)
        draws = (torch.randint(0, n, (nsteps,), **kw),
                 torch.randint(0, n, (nsteps,), **kw),
                 torch.rand((nsteps,), dtype=torch.float32, **kw))
    i, j, u = (torch.as_tensor(d).cpu() for d in draws)
    if not len(i) == len(j) == len(u) == nsteps:
        raise ValueError(f"draws must hold {nsteps} steps each")
    return i.tolist(), j.tolist(), u.tolist()


def _acceptance_tables(J, H, T):
    """dE and exp(-dE/T) in float32 for (s0, sn), at index
    ``5 (s0 + 1) / 2 + (sn + 4) / 2``, as Python floats."""
    s0 = torch.tensor([-1.0] * 5 + [1.0] * 5, dtype=torch.float32)
    sn = torch.tensor([-4.0, -2.0, 0.0, 2.0, 4.0] * 2, dtype=torch.float32)
    Jf, Hf, Tf = (torch.tensor(v, dtype=torch.float32) for v in (J, H, T))
    dE = delta_e(s0, sn, Jf, Hf)
    return dE.tolist(), torch.exp(-dE / Tf).tolist()


def _metropolis(lattice, gen, nsteps, J, H, T, draws, observe):
    """The single-site chain as a host loop; ``observe(lat, i, j, s0,
    accept, dE)`` is called after every step."""
    n = lattice.shape[0]
    lat = lattice.to(torch.int8).cpu().tolist()
    ii, jj, uu = _chain_draws(gen, n, nsteps, draws)
    dE_tab, p_tab = _acceptance_tables(J, H, T)
    for i, j, u in zip(ii, jj, uu):
        s0 = lat[i][j]
        sn = (lat[(i - 1) % n][j] + lat[(i + 1) % n][j]
              + lat[i][(j - 1) % n] + lat[i][(j + 1) % n])
        k = (s0 + 1) // 2 * 5 + (sn + 4) // 2
        accept = dE_tab[k] < 0 or u < p_tab[k]
        if accept:
            lat[i][j] = -s0
        observe(lat, i, j, s0, accept, dE_tab[k])
    return torch.tensor(lat, dtype=torch.int8, device=lattice.device)


def metropolis_chain(gen: torch.Generator | None, lattice: torch.Tensor,
                     nsteps: int, J: float = 1.0, H: float = 0.0,
                     T: float = 0.5, *, draws=None):
    """Exact sequential single-site Metropolis: ``nsteps`` steps, the
    sites and uniforms drawn from ``gen`` (or given as ``draws=(i, j, u)``).

    Returns ``(lattice, energy_trace, magnetization_trace)``, the traces
    per-step cumulative float32 values.
    """
    energy = np.float32(0.0)
    mag = np.float32(lattice.to(torch.float32).sum().item())
    energies, mags = [], []

    def observe(lat, i, j, s0, accept, dE):
        nonlocal energy, mag
        if accept:
            energy = energy + np.float32(dE)
            mag = mag + np.float32(-2.0 * s0)
        energies.append(energy)
        mags.append(mag)

    out = _metropolis(lattice, gen, nsteps, J, H, T, draws, observe)
    dev = lattice.device
    return (out, torch.tensor(np.asarray(energies, np.float32), device=dev),
            torch.tensor(np.asarray(mags, np.float32), device=dev))


def ising_diagnostics(gen: torch.Generator | None, lattice: torch.Tensor,
                      nsteps: int, J: float = 1.0, H: float = 0.0,
                      T: float = 0.5, site: tuple[int, int] = (1, 1),
                      corr_r: int = 1, *, draws=None):
    """Single-site observables along the Metropolis chain: the tracked
    spin, its distance-``corr_r`` 4-neighbour correlation ``Si*Sn/4`` and
    the per-step flip indicator of the tracked site.

    Returns ``(lattice, Sis, SiSjs, flips)`` with per-step traces.
    """
    n = lattice.shape[0]
    ic, jc = site
    sis, sisjs, flips = [], [], []

    def observe(lat, i, j, s0, accept, dE):
        si = lat[ic][jc]
        snc = (lat[(ic - corr_r) % n][jc] + lat[(ic + corr_r) % n][jc]
               + lat[ic][(jc - corr_r) % n] + lat[ic][(jc + corr_r) % n])
        sis.append(float(si))
        sisjs.append(si * snc / 4.0)
        flips.append(accept and (i, j) == (ic % n, jc % n))

    out = _metropolis(lattice, gen, nsteps, J, H, T, draws, observe)
    dev = lattice.device
    return (out, torch.tensor(sis, dtype=torch.float32, device=dev),
            torch.tensor(sisjs, dtype=torch.float32, device=dev),
            torch.tensor(flips, dtype=torch.bool, device=dev))


def checkerboard_sweeps(seed, lattice: torch.Tensor, nsweeps: int,
                        J: float = 1.0, H: float = 0.0, T: float = 0.5):
    """Red/black parallel heat-bath sweeps: one sweep flips every
    even-parity site with probability ``1 / (1 + exp(dE/T))``, then every
    odd-parity one. Needs a square lattice with an even side. The kernel
    runs for a CUDA lattice, the plain version for a CPU one. ``seed``: a
    32-bit int, or a one-element int64 tensor holding it (on a CUDA
    lattice's device, read by the kernel there)."""
    lattice = lattice.to(torch.int8).contiguous()
    return ising_kernel.checkerboard_sweeps(seed, lattice, nsweeps, J, H, T)

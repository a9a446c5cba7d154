"""Hand-written CUDA kernel for red/black heat-bath sweeps of the 2-D Ising
model.

Counterpart of ``onmf_ontf_ndl_tpu/ops/pallas/ising_kernel.py``
(``checkerboard_sweeps_pallas``, ``:64``). The source is
``csrc/ising_kernels.cu``, built into the library of
:func:`~onmf_ontf_ndl_tpu_torch.ops.kernels._lib.build`. One
launch per half-sweep updates the sites of one colour in place on the int8
(n, n) torus; n must be even, and there is no other size limit. What bounds
it on the card: the lattice traffic (one byte per site and its four
neighbours) and the integer multiplies of the random bits; the design keeps
the lattice int8 in device memory and draws the bits in registers.

Semantics: each site of the colour being updated flips with the heat-bath
probability ``sigmoid(-dE / T)``, ``dE = 2 s (H + J sn)``. The TPU's
random bits cannot be reproduced, so both versions here use a counter-based
generator, Philox4x32-10 keyed by ``(seed, 0)`` with counter
``(site, sweep, colour, chain)``; ``u24`` is the top 24 bits of its first
word, as the Pallas kernel takes its uniform. With ``s`` in {-1, 1} and
``sn`` in {-4, -2, 0, 2, 4} there are 10 values of dE, so the wrapper
computes the 10 thresholds ``ceil(p 2^24)`` once (:func:`acceptance_thresholds`)
and a site flips when ``u24 < threshold``. The kernel and
:func:`checkerboard_sweeps_plain` are therefore equal site for site.

The wrapper runs the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises, and counts each launch in
``_lib.LAUNCHES["checkerboard_sweeps"]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (
    LAUNCHES, _on_cpu, _raise_on_error, _stream, build)

__all__ = ["checkerboard_sweeps", "checkerboard_sweeps_plain",
           "acceptance_thresholds", "philox4x32"]

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def acceptance_thresholds(J: float, H: float, T: float) -> list[int]:
    """The 24-bit thresholds ``ceil(2^24 sigmoid(-dE / T))`` of the 10
    values of ``dE = 2 s (H + J sn)``, at index ``5 (s + 1) / 2 +
    (sn + 4) / 2``. A uniform 24-bit integer u flips the site iff
    ``u < threshold``, i.e. iff ``u / 2^24 < sigmoid(-dE / T)``."""
    if not T > 0:
        raise ValueError(f"temperature must be positive, got {T}")
    out = []
    for s in (-1, 1):
        for sn in (-4, -2, 0, 2, 4):
            x = 2.0 * s * (H + J * sn) / T
            p = 0.0 if x > 700.0 else 1.0 / (1.0 + math.exp(x))
            out.append(min(1 << 24, math.ceil(p * (1 << 24))))
    return out


def _mulhilo(m: int, x: torch.Tensor):
    """High and low 32-bit words of ``m * x`` for a 32-bit constant m and
    an int64 tensor of 32-bit words. The 64-bit product overflows int64,
    so m is split into 16-bit halves."""
    p0 = x * (m & 0xFFFF)                      # < 2^48
    p1 = x * (m >> 16)                         # < 2^48
    s = p0 + ((p1 & 0xFFFF) << 16)             # < 2^49
    return (s >> 32) + (p1 >> 16), s & _MASK


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding 32-bit
    words (counter c0..c3, broadcast together) and a 32-bit key (k0, k1);
    returns the four output words."""
    dev = next((w.device for w in (c0, c1, c2, c3)
                if isinstance(w, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(w, dtype=torch.int64, device=dev)
          for w in (c0, c1, c2, c3)))
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be a 32-bit unsigned integer, got {seed}")
    return seed


def _check_lattice(lattice: torch.Tensor, batched: bool) -> int:
    if lattice.dim() < 2 or (lattice.dim() != 2 and not batched) \
            or lattice.shape[-1] != lattice.shape[-2]:
        raise ValueError(
            f"checkerboard_sweeps needs a square (n, n) lattice"
            f"{' (with leading batch dimensions)' if batched else ''}, "
            f"got {tuple(lattice.shape)}")
    n = lattice.shape[-1]
    if n < 2 or n % 2:
        raise ValueError(f"even lattice side required, got {n}")
    return n


def checkerboard_sweeps(seed: int, lattice: torch.Tensor, nsweeps: int,
                        J: float = 1.0, H: float = 0.0,
                        T: float = 0.5) -> torch.Tensor:
    """``nsweeps`` red/black heat-bath sweeps of an (n, n) int8 +-1
    lattice (n even) from the random stream of ``seed`` (32-bit); returns
    the new lattice."""
    if _on_cpu(lattice):
        return checkerboard_sweeps_plain(seed, lattice, nsweeps, J, H, T)
    n = _check_lattice(lattice, batched=False)
    if lattice.dtype != torch.int8 or not lattice.is_contiguous():
        raise TypeError("checkerboard_sweeps: the lattice must be a "
                        "contiguous int8 tensor")
    seed = _check_seed(seed)
    thr = (ctypes.c_uint * 10)(*acceptance_thresholds(J, H, T))
    out = lattice.clone()
    if nsweeps <= 0:
        return out
    lib = build()["lib"]
    with torch.cuda.device(out.device):
        err = lib.onmf_checkerboard_sweeps(out.data_ptr(), n, int(nsweeps),
                                           seed, thr, _stream(out))
    _raise_on_error("checkerboard_sweeps", err)
    LAUNCHES["checkerboard_sweeps"] += 2 * int(nsweeps)
    return out


def checkerboard_sweeps_plain(seed: int, lattice: torch.Tensor,
                              nsweeps: int, J: float = 1.0, H: float = 0.0,
                              T: float = 0.5) -> torch.Tensor:
    """Plain PyTorch :func:`checkerboard_sweeps`, the same bits. Takes
    leading batch dimensions ``(..., n, n)``: chain b (in row-major order
    of the batch) draws with counter word 3 = b, so an (n, n) lattice
    equals chain 0."""
    n = _check_lattice(lattice, batched=True)
    seed = _check_seed(seed)
    thr = torch.tensor(acceptance_thresholds(J, H, T), dtype=torch.int64,
                       device=lattice.device)
    lat = lattice.to(torch.int8)
    batch = lat.shape[:-2]
    dev = lat.device
    chain = torch.arange(math.prod(batch), dtype=torch.int64,
                         device=dev).view(batch + (1, 1))
    site = torch.arange(n * n, dtype=torch.int64, device=dev).view(n, n)
    ii = torch.arange(n, device=dev)
    parity = (ii[:, None] + ii[None, :]) % 2
    for sweep in range(int(nsweeps)):
        for colour in (0, 1):
            s = lat.to(torch.int64)
            sn = (torch.roll(s, 1, -2) + torch.roll(s, -1, -2)
                  + torch.roll(s, 1, -1) + torch.roll(s, -1, -1))
            u24 = philox4x32(site, sweep, colour, chain, seed, 0)[0] >> 8
            flip = (parity == colour) & (u24 < thr[(s + 1) // 2 * 5
                                                   + (sn + 4) // 2])
            lat = torch.where(flip, -lat, lat)
    return lat

"""Hand-written CUDA kernels for red/black heat-bath sweeps of the 2-D
Ising model.

Counterpart of ``onmf_ontf_ndl_tpu/ops/pallas/ising_kernel.py``
(``checkerboard_sweeps_pallas``, ``:64``), which runs every sweep of a call
with the lattice on chip. The source is ``csrc/ising_kernels.cu``, built
into the library of :func:`~onmf_ontf_ndl_tpu_torch.ops.kernels._lib.build`.
The int8 (n, n) torus is updated in place, one colour after the other; n
must be even. What bounds it on the card: the integer instructions of the
random bits and of the update, not the lattice's bytes. The design draws
one Philox call per four sites, gives a thread 4 or 8 sites of a row read
as one 8- or 16-byte vector (byte arithmetic on the packed words), and
takes one of three routes from ``(n, nsweeps)`` alone
(:func:`checkerboard_route`): the lattice resident in the shared memory of
one CTA or of a thread block cluster of up to 8 (halo rows through
distributed shared memory) with every sweep in one launch, or in device
memory with one launch per colour and sweep.

Semantics: each site of the colour being updated flips with the heat-bath
probability ``sigmoid(-dE / T)``, ``dE = 2 s (H + J sn)``. The TPU's
random bits cannot be reproduced, so both versions here use a counter-based
generator, Philox4x32-10 keyed by ``(seed, 0)``. The sites of a colour are
numbered ``q = i (n / 2) + jj`` (row i, the jj-th site of the colour in the
row, at column ``2 jj + ((i + colour) & 1)``, so ``jj = j >> 1``); the call
with counter ``(q >> 2, sweep, colour, chain)`` serves four sites, site q
taking its word ``q & 3``, and ``u24`` is the top 24 bits of that word, as
the Pallas kernel takes its uniform. With ``s`` in {-1, 1} and ``sn`` in
{-4, -2, 0, 2, 4} there are 10 values of dE, so the wrapper computes the 10
thresholds ``ceil(p 2^24)`` once (:func:`acceptance_thresholds`) and a site
flips when ``u24 < threshold``. The kernels and
:func:`checkerboard_sweeps_plain` are therefore equal site for site, for
every even n (a call straddles two rows when ``n / 2`` is not a multiple
of 4).

A banded entry serves a lattice sharded by rows over processes
(``parallel/ising_sharded.py``): :func:`checkerboard_band_half` runs one
colour of one sweep on a band of rows from global row ``first``, with the
two halo rows that the neighbouring bands sent, through the device-memory
kernel. Counters and parities follow the global row, so the bands together
equal :func:`checkerboard_sweeps` site for site; where a band starts inside
a Philox call (``n / 2`` not a multiple of 4) it computes that call too.
:func:`checkerboard_band_half_plain` is its plain version.

:func:`checkerboard_sweeps` takes its seed as a host int or as a
one-element int64 tensor on the lattice's device, which the kernels read
as they start (``onmf_checkerboard_sweeps_at``): the Ising learner's
captured rounds draw the seed on the device and never read it on the host.

The wrappers run the plain version only for a CPU tensor; for a CUDA
tensor they launch a kernel or raise, and count each launch in
``_lib.LAUNCHES``: ``"checkerboard_sweeps"`` one for a resident call, two a
sweep on the device-memory route; ``"checkerboard_sweeps_band"`` one a
band and colour.
"""

from __future__ import annotations

import ctypes
import math

import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (
    LAUNCHES, _on_cpu, _raise_on_error, _stream, build)

__all__ = ["checkerboard_sweeps", "checkerboard_sweeps_plain",
           "checkerboard_band_half", "checkerboard_band_half_plain",
           "checkerboard_route", "acceptance_thresholds", "philox4x32"]

_MASK = 0xFFFFFFFF
_MAX_N = 1 << 17          # n^2 / 8 calls a colour fit the 32-bit counter
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
    if n > _MAX_N:
        raise ValueError(f"lattice side {n} above {_MAX_N}: the counter of "
                         "a Philox call, q >> 2, is one 32-bit word")
    return n


# The resident kernel (csrc RES_*): shared memory of a CTA, the bytes
# before its rows, the largest cluster.
_RES_SMEM_BYTES = 232448
_RES_HEAD_BYTES = 64
_RES_MAX_CLUSTER = 8
# The crossovers of :func:`checkerboard_route`, from device times on an
# NVIDIA H100 80GB HBM3 (``chip_compare.py . new routes``: every route on a
# grid of n and sweeps). A launch of the device-memory route costs ~1.8 us
# whatever the lattice up to n ~ 800; a resident half-sweep ~0.65 us on one
# CTA at n = 16 and 1.0 to 1.7 us on a cluster of 8 from n = 64 to 256 (the
# barrier and one item's latency), 3.5 us at n = 384; a resident call adds
# ~3 us of its own. So: one CTA up to n = 16; a cluster from 4 sweeps on up
# to n = 160 and from 16 on up to n = 256; device memory for the rest.
_SHARED_MAX_N = 16
_CLUSTER_MIN_SWEEPS = ((160, 4), (256, 16))


def _resident_fits(n: int, ctas: int) -> bool:
    """Whether ``ctas`` CTAs, each with ``ceil(n / ctas)`` rows (the last
    one the rest, at least one), hold the lattice in shared memory."""
    band = -(-n // ctas)
    return ((ctas - 1) * band < n
            and _RES_HEAD_BYTES + band * n <= _RES_SMEM_BYTES)


def checkerboard_route(n: int, nsweeps: int) -> tuple[str, int]:
    """How :func:`checkerboard_sweeps` runs an (n, n) lattice for
    ``nsweeps`` sweeps, from these two alone: ``("shared", 1)`` (the
    lattice resident in one CTA's shared memory, one launch),
    ``("cluster", c)`` (in bands over a cluster of c CTAs, one launch) or
    ``("global", 0)`` (device memory, two launches a sweep). The measured
    crossovers are :data:`_SHARED_MAX_N` and :data:`_CLUSTER_MIN_SWEEPS`."""
    if n <= _SHARED_MAX_N:
        return "shared", 1
    min_sweeps = next((s for top, s in _CLUSTER_MIN_SWEEPS if n <= top), None)
    if min_sweeps is not None and nsweeps >= min_sweeps:
        c = next(c for c in (_RES_MAX_CLUSTER, 4, 2) if _resident_fits(n, c))
        return "cluster", c
    return "global", 0


def _launch(out: torch.Tensor, n: int, nsweeps: int, seed, thr,
            ctas: int) -> int:
    """Run the kernels of one route (``ctas`` as in
    :func:`checkerboard_route`) in place on ``out``, from a host ``seed``
    or one in device memory (a one-element int64 tensor, read by the
    kernels as they start); returns the launches made."""
    lib = build()["lib"]
    with torch.cuda.device(out.device):
        if isinstance(seed, torch.Tensor):
            err = lib.onmf_checkerboard_sweeps_at(
                out.data_ptr(), n, int(nsweeps), seed.data_ptr(), thr, ctas,
                _stream(out))
        else:
            err = lib.onmf_checkerboard_sweeps(
                out.data_ptr(), n, int(nsweeps), seed, thr, ctas,
                _stream(out))
    _raise_on_error("checkerboard_sweeps", err)
    return 1 if ctas else 2 * int(nsweeps)


def _device_seed(seed, device: torch.device):
    """``seed`` as the kernels take it on ``device``: a checked host int, or
    a one-element int64 tensor there, left where it lies (no host read)."""
    if not isinstance(seed, torch.Tensor):
        return _check_seed(seed)
    if seed.device != device:
        return _check_seed(int(seed))
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise TypeError(f"checkerboard_sweeps: a device seed is a "
                        f"one-element int64 tensor, got {seed.dtype} "
                        f"{tuple(seed.shape)}")
    return seed


def checkerboard_sweeps(seed, lattice: torch.Tensor, nsweeps: int,
                        J: float = 1.0, H: float = 0.0,
                        T: float = 0.5) -> torch.Tensor:
    """``nsweeps`` red/black heat-bath sweeps of an (n, n) int8 +-1
    lattice (n even) from the random stream of ``seed``; returns the new
    lattice. ``seed`` is a 32-bit int, or a one-element int64 tensor that
    holds one: on the lattice's device the kernels read it there at launch
    (a CUDA graph can capture the call), elsewhere it is read on the
    host."""
    if _on_cpu(lattice):
        return checkerboard_sweeps_plain(seed, lattice, nsweeps, J, H, T)
    n = _check_lattice(lattice, batched=False)
    if lattice.dtype != torch.int8 or not lattice.is_contiguous():
        raise TypeError("checkerboard_sweeps: the lattice must be a "
                        "contiguous int8 tensor")
    seed = _device_seed(seed, lattice.device)
    thr = (ctypes.c_uint * 10)(*acceptance_thresholds(J, H, T))
    out = lattice.clone()
    if nsweeps <= 0:
        return out
    _, ctas = checkerboard_route(n, int(nsweeps))
    LAUNCHES["checkerboard_sweeps"] += _launch(out, n, nsweeps, seed, thr,
                                               ctas)
    return out


def _u24(seed: int, first: int, rows: int, n: int, sweep: int, colour: int,
         chain) -> torch.Tensor:
    """The 24-bit uniforms of the sites of ``colour`` in rows ``first`` ..
    ``first + rows - 1``, each repeated over its column pair (``rows``,
    n); ``chain`` (int64, broadcast) is counter word 3. Call g serves
    q = 4 g .. 4 g + 3; site q takes word q & 3."""
    half = n // 2
    q_lo = first * half
    g0 = q_lo >> 2
    calls = torch.arange(g0, -(-(q_lo + rows * half) // 4), dtype=torch.int64,
                         device=chain.device)
    words = torch.stack(philox4x32(calls, sweep, colour, chain, seed, 0),
                        dim=-1)
    batch = words.shape[:-2]
    skip = q_lo - 4 * g0
    u24 = words.reshape(batch + (-1,))[..., skip:skip + rows * half] >> 8
    return u24.view(batch + (rows, half)).repeat_interleave(2, dim=-1)


def _flip(lat, s, sn, u24, thr, parity, colour):
    """The heat-bath update of the sites of ``colour``: flip where the
    site's uniform is below its threshold."""
    flip = (parity == colour) & (u24 < thr[(s + 1) // 2 * 5 + (sn + 4) // 2])
    return torch.where(flip, -lat, lat)


def checkerboard_sweeps_plain(seed, lattice: torch.Tensor,
                              nsweeps: int, J: float = 1.0, H: float = 0.0,
                              T: float = 0.5) -> torch.Tensor:
    """Plain PyTorch :func:`checkerboard_sweeps`, the same bits; ``seed``
    an int or a one-element tensor holding it (read on the host). Takes
    leading batch dimensions ``(..., n, n)``: chain b (in row-major order
    of the batch) draws with counter word 3 = b, so an (n, n) lattice
    equals chain 0."""
    n = _check_lattice(lattice, batched=True)
    seed = _check_seed(int(seed))
    thr = torch.tensor(acceptance_thresholds(J, H, T), dtype=torch.int64,
                       device=lattice.device)
    lat = lattice.to(torch.int8)
    batch = lat.shape[:-2]
    dev = lat.device
    chain = torch.arange(math.prod(batch), dtype=torch.int64,
                         device=dev).view(batch + (1,))
    ii = torch.arange(n, device=dev)
    parity = (ii[:, None] + ii[None, :]) % 2
    for sweep in range(int(nsweeps)):
        for colour in (0, 1):
            s = lat.to(torch.int64)
            sn = (torch.roll(s, 1, -2) + torch.roll(s, -1, -2)
                  + torch.roll(s, 1, -1) + torch.roll(s, -1, -1))
            lat = _flip(lat, s, sn, _u24(seed, 0, n, n, sweep, colour, chain),
                        thr, parity, colour)
    return lat


def _check_band(band, above, below, first: int, colour: int) -> tuple:
    if band.dim() != 2 or above.shape != (band.shape[1],) \
            or below.shape != (band.shape[1],):
        raise ValueError(
            f"checkerboard_band_half needs a (rows, n) band and two (n,) "
            f"halo rows, got {tuple(band.shape)}, {tuple(above.shape)}, "
            f"{tuple(below.shape)}")
    rows, n = band.shape
    if n < 2 or n % 2 or n > _MAX_N:
        raise ValueError(f"even lattice side up to {_MAX_N} required, "
                         f"got {n}")
    if not 0 <= first <= n - rows:
        raise ValueError(f"rows {first}..{first + rows - 1} are not rows of "
                         f"an ({n}, {n}) lattice")
    if colour not in (0, 1):
        raise ValueError(f"colour must be 0 or 1, got {colour}")
    return rows, n


def checkerboard_band_half(seed: int, band: torch.Tensor,
                           above: torch.Tensor, below: torch.Tensor,
                           first: int, sweep: int, colour: int,
                           J: float = 1.0, H: float = 0.0,
                           T: float = 0.5) -> torch.Tensor:
    """One colour of sweep ``sweep`` on ``band``, rows ``first`` ..
    ``first + rows - 1`` of an (n, n) int8 +-1 torus, with ``above`` the
    lattice row before the band and ``below`` the row after it (torus
    wrap-around); updates ``band`` in place and returns it. The colour's
    sites draw exactly the bits that :func:`checkerboard_sweeps` draws for
    them in that sweep."""
    rows, n = _check_band(band, above, below, int(first), int(colour))
    if _on_cpu(band, above, below):
        return band.copy_(checkerboard_band_half_plain(
            seed, band, above, below, first, sweep, colour, J, H, T))
    if any(t.dtype != torch.int8 or not t.is_contiguous()
           for t in (band, above, below)):
        raise TypeError("checkerboard_band_half: the band and the halo rows "
                        "must be contiguous int8 tensors")
    seed = _check_seed(seed)
    thr = (ctypes.c_uint * 10)(*acceptance_thresholds(J, H, T))
    lib = build()["lib"]
    with torch.cuda.device(band.device):
        err = lib.onmf_checkerboard_band_half(
            band.data_ptr(), above.data_ptr(), below.data_ptr(), n,
            int(first), rows, seed, int(sweep), int(colour), thr,
            _stream(band))
    _raise_on_error("checkerboard_band_half", err)
    LAUNCHES["checkerboard_sweeps_band"] += 1
    return band


def checkerboard_band_half_plain(seed: int, band: torch.Tensor,
                                 above: torch.Tensor, below: torch.Tensor,
                                 first: int, sweep: int, colour: int,
                                 J: float = 1.0, H: float = 0.0,
                                 T: float = 0.5) -> torch.Tensor:
    """Plain PyTorch :func:`checkerboard_band_half`; returns the new band
    (the inputs are not changed)."""
    rows, n = _check_band(band, above, below, int(first), int(colour))
    seed = _check_seed(seed)
    dev = band.device
    thr = torch.tensor(acceptance_thresholds(J, H, T), dtype=torch.int64,
                       device=dev)
    lat = band.to(torch.int8)
    s = lat.to(torch.int64)
    up = torch.cat([above.to(torch.int64)[None], s[:-1]])
    down = torch.cat([s[1:], below.to(torch.int64)[None]])
    sn = up + down + torch.roll(s, 1, -1) + torch.roll(s, -1, -1)
    ii = torch.arange(first, first + rows, device=dev)
    parity = (ii[:, None] + torch.arange(n, device=dev)[None, :]) % 2
    chain = torch.zeros((1,), dtype=torch.int64, device=dev)
    return _flip(lat, s, sn, _u24(seed, int(first), rows, n, int(sweep),
                                  int(colour), chain), thr, parity, colour)

"""Plain reference of the Ising configuration: red/black heat-bath sweeps
of a 2-D Ising lattice on the torus, and online dictionary learning on
random square patches of the lattice along its trajectory, with the
aggregate C of the patches' second moments and the surrogate error
``tr(W A W^T) - 2 tr(W B) + tr(C)`` after every round. The sweeps run in
NumPy on the host, the learner in plain PyTorch on the device (the steps
of ``reference/onmf.py``). Imports nothing of the port.

The sampler, written from its rule. A sweep updates the sites of colour
0 (row i, column j with (i + j) even), then those of colour 1; a site of
spin s whose four neighbours sum to sn flips with the heat-bath
probability ``sigmoid(-dE / T)``, ``dE = 2 s (H + J sn)``. Its random
bits: the sites of a colour are numbered ``q = i (n / 2) + (j >> 1)``;
Philox4x32-10 keyed by ``(seed, 0)`` at the counter
``(q >> 2, sweep, colour, 0)`` gives four 32-bit words, site q takes word
``q & 3``, and its uniform ``u24`` is that word's top 24 bits. The site
flips when ``u24 < ceil(2^24 sigmoid(-dE / T))``.

A call of the learner: an initial round on the lattice as it stands,
then ``rounds`` trajectory rounds, each first advancing the lattice by
``ceil(steps / n^2)`` sweeps. A round draws ``num_patches`` k x k patches
(top-left corners uniform below n - k, rows then columns), flattened
row-major into the columns of X, and runs ``sub_iterations - 1`` online
steps on all of them, step i of a round at counter t + i with weight
``w = t^-beta``; every step also blends X X^T into C with that weight.

Randomness: every draw is a call on a ``torch.Generator`` of the device,
in the order the port makes it. The learner's generator, seeded with the
run's learner seed, draws the initial lattice (one bit a site), the seed
of the state's generator (one integer below 2**62), then, each trajectory
round, the sweeps' seed (one integer below 2**31 - 1) and every round the
corners. The state's generator draws the initial dictionary, then each
step's code start.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchport.reference import onmf

_MASK = np.uint64(0xFFFFFFFF)
# Philox4x32's multipliers and key increments (Salmon et al., SC'11)
_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counters (c0, c1, c2, c3) (arrays of 32-bit
    words, broadcast together) under the key (k0, k1): ten rounds, each
    two 32 x 32 -> 64 products, the key raised by its increments after
    each. Returns the four output words (uint64 arrays)."""
    c0, c1, c2, c3 = np.broadcast_arrays(
        *(np.asarray(c, np.uint64) for c in (c0, c1, c2, c3)))
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        p0 = _M0 * c0                     # < 2^64: no wrap
        p1 = _M1 * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & _MASK,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & _MASK)
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def thresholds(J: float, H: float, T: float) -> dict:
    """``{(s, sn): ceil(2^24 sigmoid(-dE / T))}``, at most 2^24, for the
    ten (spin, neighbour sum) pairs."""
    out = {}
    for s in (-1, 1):
        for sn in (-4, -2, 0, 2, 4):
            x = 2.0 * s * (H + J * sn) / T              # dE / T
            p = 0.0 if x > 700.0 else 1.0 / (1.0 + math.exp(x))
            out[s, sn] = min(1 << 24, math.ceil(p * (1 << 24)))
    return out


def sweeps(seed: int, lattice: np.ndarray, nsweeps: int, J: float,
           H: float, T: float) -> np.ndarray:
    """``nsweeps`` red/black sweeps of the (n, n) +-1 lattice (n even)
    from the stream of ``seed``; returns the new lattice (int8)."""
    lat = np.asarray(lattice, np.int8).copy()
    n = lat.shape[0]
    thr = thresholds(J, H, T)
    table = np.zeros((3, 9), np.int64)          # [s + 1, sn + 4]
    for (s, sn), v in thr.items():
        table[s + 1, sn + 4] = v
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    q = i * (n // 2) + (j >> 1)
    word = q & 3
    for sweep in range(nsweeps):
        for colour in (0, 1):
            s = lat.astype(np.int64)
            sn = (np.roll(s, 1, 0) + np.roll(s, -1, 0) + np.roll(s, 1, 1)
                  + np.roll(s, -1, 1))
            words = np.stack(philox(q >> 2, sweep, colour, 0, seed, 0))
            u24 = np.take_along_axis(words, word[None], 0)[0] >> np.uint64(8)
            flip = (((i + j) & 1) == colour) \
                & (u24.astype(np.int64) < table[s + 1, sn + 4])
            lat = np.where(flip, -lat, lat).astype(np.int8)
    return lat


def patches(lattice: np.ndarray, a, b, k: int, dev) -> torch.Tensor:
    """The (k*k, M) float32 patches of the lattice with top-left corners
    (a[m], b[m]), each flattened row-major into a column."""
    lat = torch.as_tensor(lattice, device=dev).to(torch.float32)
    d = torch.arange(k, device=dev)
    rows = a[:, None, None] + d[None, :, None]
    cols = b[:, None, None] + d[None, None, :]
    return lat[rows, cols].reshape(a.shape[0], k * k).T.contiguous()


def _step(W, A, B, C, X, H0, w, *, alpha, sweeps, stop, tile, prec):
    """:func:`onmf.train_step` with the aggregate C of X X^T blended in
    with the step's weight."""
    W1, A1, B1, H = onmf.train_step(W, A, B, X, H0, w, alpha=alpha,
                                    sweeps=sweeps, stop=stop, tile=tile,
                                    prec=prec)
    return W1, A1, B1, C * (1.0 - w) + prec.mm(X, X.T) * w, H


def surrogate_error(st: onmf.State, C) -> float:
    """``tr(W A W^T) - 2 tr(W B) + tr(C)``, in float64."""
    W, A, B, C = (v.double() for v in (st.W, st.A, st.B, C))
    return float(torch.trace(W @ A @ W.T) - 2.0 * torch.trace(W @ B)
                 + torch.trace(C))


class Learner:
    """The Ising learner from its seed: the learner's generator, the
    initial lattice, the state (W, A, B and C) and its generator."""

    def __init__(self, seed: int, cfg: dict, dev):
        if cfg["sampler"] != "checkerboard":
            raise ValueError("the reference runs the checkerboard sampler")
        self.cfg, self.dev = cfg, dev
        n, k, r = cfg["lattice_size"], cfg["patch_size"], cfg["n_components"]
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        bits = torch.randint(0, 2, (n, n), generator=self.gen, device=dev)
        self.lattice = (1 - 2 * bits).to(torch.int8).cpu().numpy()
        state_seed = int(torch.randint(0, 2**62, (1,), generator=self.gen,
                                       device=dev))
        self.sgen = torch.Generator(device=dev).manual_seed(state_seed)
        W = torch.rand((k * k, r), generator=self.sgen, device=dev)
        self.st = onmf.State.fresh(W)
        self.C = W.new_zeros((k * k, k * k))
        self.t = 0.0
        self.nsweeps = max(1, -(-cfg["ising_subsampling_steps"] // (n * n)))

    def round(self, advance: bool, prec: onmf.Prec) -> float:
        """One round (the lattice advanced first where ``advance``);
        returns the surrogate error after it."""
        cfg, dev = self.cfg, self.dev
        n, k, M = cfg["lattice_size"], cfg["patch_size"], cfg["num_patches"]
        if advance and cfg["update_lattice"]:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self.gen,
                                     device=dev))
            self.lattice = sweeps(seed, self.lattice, self.nsweeps,
                                  cfg["J"], cfg["field"],
                                  cfg["temperature"])
        a = torch.randint(0, n - k, (M,), generator=self.gen, device=dev)
        b = torch.randint(0, n - k, (M,), generator=self.gen, device=dev)
        X = patches(self.lattice, a, b, k, dev)
        iters = cfg["sub_iterations"]
        stop = None if cfg["fast"] else cfg["stopping_diff"]
        key = ("ising-step", float(cfg["alpha"]), cfg["sub_iter"], stop,
               cfg["tile"], prec)
        for i in range(1, iters):
            H0 = torch.rand((cfg["n_components"], M), generator=self.sgen,
                            device=dev)
            w = torch.full((), (self.t + i) ** (-float(cfg["beta"])),
                           dtype=torch.float64, device=dev)
            st = self.st
            st.W, st.A, st.B, self.C, _ = onmf.graphed(
                key, lambda *a: _step(*a, alpha=cfg["alpha"],
                                      sweeps=cfg["sub_iter"], stop=stop,
                                      tile=cfg["tile"], prec=prec),
                st.W, st.A, st.B, self.C, X, H0, w)
        self.t += iters
        return surrogate_error(self.st, self.C)

    def call(self, rounds: int, prec: onmf.Prec) -> torch.Tensor:
        """The initial round and ``rounds`` trajectory rounds; returns
        their surrogate errors (float64, on the device)."""
        errors = [self.round(False, prec)]
        errors += [self.round(True, prec) for _ in range(rounds)]
        return torch.tensor(errors, dtype=torch.float64, device=self.dev)

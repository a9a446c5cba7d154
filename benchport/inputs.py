"""The benchmark's inputs, made from the run's seed: colour images on the
device and a Barabasi-Albert graph. Both sides of a comparison (the port
and the plain reference) are handed the same ones.

A seed is any whole number up to 2**64 - 1; each input takes a seed of
its own derived from it (:func:`sub_seed`), so an image and a graph of one
run are not made from one stream.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the input ``name`` of the run ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def images(seed: int, count: int, height: int, width: int, device,
           components: int = 24) -> torch.Tensor:
    """``count`` (height, width, 3) float32 images in [0, 1] on
    ``device``: each channel a sum of ``components`` plane waves of random
    frequency, direction and phase under a random smooth envelope, plus a
    little noise, so that patches have edges, texture and flat parts.
    Made in a few whole-batch calls from a generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "images"))

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    yy = torch.arange(height, device=device, dtype=torch.float32).view(
        1, height, 1, 1)
    xx = torch.arange(width, device=device, dtype=torch.float32).view(
        1, 1, width, 1)
    out = torch.zeros((count, height, width, 3), device=device)
    freq = 0.02 + 0.5 * rand(components, count, 1, 1, 3) ** 2
    angle = 2 * torch.pi * rand(components, count, 1, 1, 3)
    phase = 2 * torch.pi * rand(components, count, 1, 1, 3)
    amp = rand(components, count, 1, 1, 3)
    cy = height * rand(components, count, 1, 1, 1)
    cx = width * rand(components, count, 1, 1, 1)
    spread = (0.1 + 0.4 * rand(components, count, 1, 1, 1)) * max(height,
                                                                 width)
    for c in range(components):
        wave = torch.sin(freq[c] * (torch.cos(angle[c]) * xx
                                    + torch.sin(angle[c]) * yy) + phase[c])
        env = torch.exp(-((yy - cy[c]) ** 2 + (xx - cx[c]) ** 2)
                        / (2 * spread[c] ** 2))
        out += amp[c] * env * wave
    lo = out.amin(dim=(1, 2, 3), keepdim=True)
    hi = out.amax(dim=(1, 2, 3), keepdim=True)
    out = (out - lo) / (hi - lo)
    out = 0.98 * out + 0.02 * torch.rand(out.shape, generator=gen,
                                         device=device)
    return out.contiguous()


def ba_edges(n: int, m: int, seed: int, chunk: int = 4096) -> np.ndarray:
    """A Barabasi-Albert edge list (E, 2) from an (m+1)-clique: each new
    node joins m targets drawn from the repeated-endpoint bag as of its
    chunk's start (``benchmarks/scale_extras.py::ba_edges``)."""
    rng = np.random.default_rng(sub_seed(seed, "graph"))
    init = np.asarray([(i, j) for i in range(m + 1) for j in range(i)],
                      np.int64)
    bag = np.empty(2 * (m * n + len(init)), np.int64)
    bl = init.size
    bag[:bl] = init.reshape(-1)
    pieces, node = [init], m + 1
    while node < n:
        c = min(chunk, n - node, max(1, bl // (2 * m)))
        e = np.stack([np.repeat(np.arange(node, node + c), m),
                      bag[rng.integers(0, bl, c * m)]], axis=1)
        pieces.append(e)
        bag[bl:bl + e.size] = e.reshape(-1)
        bl += e.size
        node += c
    return np.concatenate(pieces)


def adjacency(edges: np.ndarray, n: int) -> np.ndarray:
    """The (n, n) boolean adjacency of a simple undirected graph: both
    directions of every edge, no self-loops."""
    adj = np.zeros((n, n), bool)
    adj[edges[:, 0], edges[:, 1]] = True
    adj[edges[:, 1], edges[:, 0]] = True
    np.fill_diagonal(adj, False)
    return adj

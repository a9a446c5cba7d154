"""Plain reference of the network configuration: motif chains on a
simple graph, online dictionary learning on the chains' k x k motif
patches, and the reconstruction that paints each sample's W H values onto
the node pairs of its embedding and averages them per pair. The chains'
moves run in NumPy on the host, one chain after another where a move
depends on a chain's own neighbourhood; the learner and the coder in plain
PyTorch on the device. Imports nothing of the port.

The motif is a path rooted at node 0 (node i's parent is node i - 1). The
moves, written from their definitions:

- a tree grown from a root: node i takes the neighbour of node i - 1's
  image at index min(floor(u d), d - 1) of its ascending neighbour row (u
  the node's uniform, d the degree), or the image itself if isolated;
- a pivot move: the root proposes the neighbour picked so by one uniform,
  accepted when a second uniform is below deg(root) / deg(proposal) (an
  isolated root jumps to a uniform node), then the tree is grown anew;
- a Glauber move: a uniform motif node j takes the target-th (target =
  min(floor(u c) + 1, c)) of the c candidates adjacent to the images of
  all of j's motif neighbours, counted along the ascending neighbour row
  of its lowest motif neighbour's image, or a uniform node if there is
  none.

Products u d and u c and the quotient of degrees are float32, as drawn.

Randomness: every draw is a call on a ``torch.Generator`` of the device,
in the order the port makes it (see ``draw_*``), so both sides see the
same numbers. The reconstructor's generator, seeded with the run's
learner seed, draws the initial chains (one uniform node a chain, then a
tree), then the seed of the learner's generator (one integer below
2**62), then each reconstruction's pivots, trees, moves and code start.
The learner's generator draws the initial dictionary, then each round's
chain moves and each inner step's code start.
"""

from __future__ import annotations

import numpy as np
import torch

from benchport.reference import onmf


class HostGraph:
    """A simple graph on the host: adjacency, ascending neighbour rows
    (padded) and degrees."""

    def __init__(self, adj: np.ndarray):
        self.adj = adj
        self.n = adj.shape[0]
        self.deg = adj.sum(1).astype(np.int64)
        self.nbr = np.zeros((self.n, max(int(self.deg.max()), 1)), np.int64)
        for i in range(self.n):
            row = np.flatnonzero(adj[i])
            self.nbr[i, :len(row)] = row


def _f32(x):
    return np.asarray(x, np.float32)


def _pick(g: HostGraph, x: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The neighbour of each node x that the uniforms u pick; x itself
    where it is isolated."""
    d = g.deg[x]
    d1 = np.maximum(d, 1)
    idx = np.minimum((_f32(u) * _f32(d1)).astype(np.int64), d1 - 1)
    return np.where(d > 0, g.nbr[x, idx], x)


def grow(g: HostGraph, emb: np.ndarray, u: np.ndarray) -> None:
    """Grow the path's tree from emb[:, 0] in place; u is (k - 1, C)."""
    for i in range(1, emb.shape[1]):
        emb[:, i] = _pick(g, emb[:, i - 1], u[i - 1])


def pivot(g: HostGraph, emb: np.ndarray, draws) -> None:
    """One pivot move of every chain, in place."""
    u_nb, u_acc, jump, u = draws
    x = emb[:, 0]
    y = _pick(g, x, u_nb)
    dx = g.deg[x]
    accept = _f32(u_acc) < _f32(dx) / _f32(np.maximum(g.deg[y], 1))
    emb[:, 0] = np.where(dx > 0, np.where(accept, y, x), jump)
    grow(g, emb, u)


def glauber(g: HostGraph, emb: np.ndarray, draws) -> None:
    """One Glauber move of every chain of the path motif, in place."""
    js, us, fallback = draws
    k = emb.shape[1]
    for c in range(emb.shape[0]):
        j = int(js[c])
        cons = [emb[c, q] for q in (j - 1, j + 1) if 0 <= q < k]
        row = g.nbr[cons[0], :g.deg[cons[0]]]
        ok = np.ones(len(row), bool)
        for other in cons[1:]:
            ok &= g.adj[other, row]
        total = int(ok.sum())
        if total == 0:
            emb[c, j] = fallback[c]
            continue
        target = min(int(_f32(us[c]) * _f32(total)) + 1, total)
        emb[c, j] = row[np.flatnonzero(ok)[target - 1]]


def draw_tree(gen, C: int, k: int, dev):
    return torch.rand((k - 1, C), generator=gen, device=dev)


def draw_pivot(gen, C: int, k: int, n: int, dev):
    return (torch.rand((C,), generator=gen, device=dev),
            torch.rand((C,), generator=gen, device=dev),
            torch.randint(0, n, (C,), generator=gen, device=dev),
            torch.rand((k - 1, C), generator=gen, device=dev))


def draw_glauber(gen, C: int, k: int, n: int, dev):
    return (torch.randint(0, k, (C,), generator=gen, device=dev),
            torch.rand((C,), generator=gen, device=dev),
            torch.randint(0, n, (C,), generator=gen, device=dev))


def host(draws):
    return [d.cpu().numpy() for d in draws]


def run(g: HostGraph, emb: np.ndarray, moves: list, move) -> np.ndarray:
    """Apply the drawn moves in order; returns the (C, S, k) trail of the
    state after each move (emb is left at the last)."""
    trail = np.empty((emb.shape[0], len(moves), emb.shape[1]), np.int64)
    for s, draws in enumerate(moves):
        move(g, emb, draws)
        trail[:, s] = emb
    return trail


def patches(g: HostGraph, embs: np.ndarray, dev) -> torch.Tensor:
    """The (k*k, M) float32 patches of (M, k) embeddings: entry
    (q*k + r, m) is 1 where embs[m, q] and embs[m, r] are adjacent."""
    M, k = embs.shape
    X = g.adj[embs[:, :, None], embs[:, None, :]].reshape(M, k * k)
    return torch.as_tensor(X.T.astype(np.float32), device=dev)


class Learner:
    """The network learner from its seed: the reconstructor's generator,
    the initial chains, the learner's state and generator."""

    def __init__(self, g: HostGraph, seed: int, cfg: dict, dev):
        self.g, self.cfg, self.dev = g, cfg, dev
        self.k = cfg["k1"] + cfg["k2"] + 1
        if cfg["k1"] != 0:
            raise ValueError("the reference grows path motifs rooted at 0")
        C = cfg["num_chains"]
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        x0 = torch.randint(0, g.n, (C,), generator=self.gen, device=dev)
        u = draw_tree(self.gen, C, self.k, dev)
        self.emb = np.zeros((C, self.k), np.int64)
        self.emb[:, 0] = x0.cpu().numpy()
        grow(g, self.emb, u.cpu().numpy())
        state_seed = int(torch.randint(0, 2**62, (1,), generator=self.gen,
                                       device=dev))
        self.sgen = torch.Generator(device=dev).manual_seed(state_seed)
        W = torch.rand((self.k * self.k, cfg["n_components"]),
                       generator=self.sgen, device=dev)
        self.st = onmf.State.fresh(W)
        self.t = 0.0

    def rounds(self, count: int, prec: onmf.Prec) -> None:
        cfg, g, dev, k = self.cfg, self.g, self.dev, self.k
        C = cfg["num_chains"]
        per = -(-cfg["sample_size"] // C)
        iters = cfg["sub_iterations"]
        stop = None if cfg["fast"] else cfg["stopping_diff"]
        for _ in range(count):
            moves = [draw_glauber(self.sgen, C, k, g.n, dev)
                     for _ in range(per)]
            trail = run(g, self.emb, [host(m) for m in moves], glauber)
            X = patches(g, trail.reshape(-1, k), dev)
            for i in range(1, iters):
                H0 = torch.rand((cfg["n_components"], X.shape[1]),
                                generator=self.sgen, device=dev)
                onmf.step(self.st, X, H0, self.t + i, alpha=cfg["alpha"],
                          sweeps=cfg["sub_iter"], stop=stop,
                          tile=cfg["tile"], prec=prec)
            self.t += iters


def job_draws(gen, n: int, cfg: dict, dev):
    """A reconstruction's draws, in order: the pivots, their trees, each
    pivot move, then the code start (r, M)."""
    C = cfg["recons_chains"]
    k = cfg["k1"] + cfg["k2"] + 1
    per = -(-cfg["recons_iter"] // C)
    pivots = torch.randint(0, n, (C,), generator=gen, device=dev)
    tree = draw_tree(gen, C, k, dev)
    moves = [draw_pivot(gen, C, k, n, dev) for _ in range(per)]
    H0 = torch.rand((cfg["n_components"], C * per), generator=gen,
                    device=dev)
    return pivots, tree, moves, H0


def reconstruct(g: HostGraph, W, draws, cfg: dict, prec: onmf.Prec):
    """One dense reconstruction from its draws (:func:`job_draws`): the
    mean painted value of every directed node pair (0 where none is
    painted), (n, n) float64."""
    dev = W.device
    pivots, tree, moves, H0 = draws
    C, k = pivots.shape[0], tree.shape[0] + 1
    emb = np.zeros((C, k), np.int64)
    emb[:, 0] = pivots.cpu().numpy()
    grow(g, emb, tree.cpu().numpy())
    embs = run(g, emb, [host(m) for m in moves], pivot).reshape(-1, k)
    X = patches(g, embs, dev)
    G = prec.mm(W.T, W)
    P = prec.mm(W.T, X)
    del X
    H = onmf.code_fixed(G, P, H0, cfg["recons_alpha"],
                        cfg["recons_sub_iter"], prec)
    vals = prec.mm(W, H).double()                     # (k*k, M)
    e = torch.as_tensor(embs, device=dev)
    key = (e[:, :, None] * g.n + e[:, None, :]).reshape(-1, k * k).T
    sums = torch.zeros(g.n * g.n, dtype=torch.float64, device=dev)
    cnt = torch.zeros_like(sums)
    sums.index_add_(0, key.reshape(-1), vals.reshape(-1))
    cnt.index_add_(0, key.reshape(-1), torch.ones_like(vals).reshape(-1))
    mean = torch.where(cnt > 0, sums / cnt.clamp_min(1.0), 0.0)
    return mean.view(g.n, g.n)

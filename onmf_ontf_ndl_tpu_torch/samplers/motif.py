"""MCMC motif-homomorphism samplers for network dictionary learning.

Counterpart of ``onmf_ontf_ndl_tpu/samplers/motif.py`` (the reference's
networkx Glauber and pivot chains). Chains are a batch dimension: an
embedding batch is a (C, k) int64 tensor, one chain is C = 1, and every
move advances all C chains at once. Randomness comes from an explicit
``torch.Generator`` on the graph's device; its numbers differ from JAX's
threefry stream, so the tests compare laws, or inject embeddings.

What the moves mean, as in the JAX module:

- ``tree_sample`` grows an embedding from a pivot: each motif node in
  depth-first order takes a uniform neighbour of its parent's image (a
  uniform node when it has no parent; the parent's image itself when that
  is isolated);
- ``rw_update`` is the Metropolis-Hastings walk with acceptance
  ``min(1, deg x / deg y)``; ``pivot_update`` walks the root and regrows
  the tree;
- ``glauber_update`` picks a uniform motif node j and resamples its image
  uniformly from the common neighbours of the images of j's motif
  neighbours, or uniformly from all nodes when that set is empty. On
  every representation the candidates are the first valid constraint's
  neighbour row (ascending), each tested against the other constraints
  (a dense lookup, one bit test on a :class:`BitsetGraph`, a binary search
  of a CSR row), and the winner is rank-selected from one uniform per
  chain. Rows ascend in all three representations, so the same uniforms
  give the same draws.

The chain (``run_chains``, under every caller: NDL training through
``sample_patches_ensemble``, every reconstruction, the data-parallel
forms) runs one move function on static buffers (``_chain_move``): on a
CUDA tensor it is captured once as a CUDA graph per cache key
(``_chain_key``; ``_CHAIN_GRAPHS`` holds eight) and replayed for every
move, its draws from a generator registered with the graph, which hands
the caller's generator state in and back (``utils/capture.py``); on the
CPU, and with ``capture=False``, it runs in a Python loop. After each
move the trail records the embeddings at a device step counter
(``_record``), outside the graph, so that a graph holds no trail. Both
routes draw the same numbers and give the same chains.

Each move is split into its draws (a fixed number of tensors of
data-independent shape, drawn in torch from the generator: ``_walk_draws``,
``_tree_draws``, ``_glauber_draws``) and their use (``_walk_apply``,
``_tree_apply``, ``_glauber_apply``). On a CUDA tensor the use is one
launch of the hand-written kernel of ``ops/kernels/motif_kernel.py``
(``chain_move``; every move of ``run_chains`` on both routes, and
``tree_sample``); the apply functions are its plain version, which runs on
the CPU and, for comparisons, with ``run_chains(..., backend="torch")``.
The kernel repeats the plain arithmetic, so both give the same chains bit
for bit.

Patches: ``pair_matrices_T`` returns a batch's k x k induced adjacency
(or weight) patches as a (k*k, M) matrix with the sample axis minor. A
binary graph is symmetric and has no self-loops, so only the k(k-1)/2
unordered pairs are tested; on a CSR graph each by binary search
(``ceil(log2(max_deg))`` gathers per pair), never by a padded
(max_deg, k, M) block.

Left out, because they are TPU cost-model workarounds
(``motif.py:37-61,521-568``): ``_CANDIDATE_DEG_FACTOR`` (the packed-AND
Glauber kernel for bitsets), ``_BSEARCH_DEG_THRESHOLD`` (the whole-row
compare for low-degree CSR graphs), ``_SLOT_BLOCK_BYTES`` and the
``nbr_pad_T`` slot blocks, the sort-join membership and the
sorted-multiplicity hub branch. They change the cost of a query on the
TPU, not its answer.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from onmf_ontf_ndl_tpu_torch.data.graphs import BitsetGraph, CsrGraph
from onmf_ontf_ndl_tpu_torch.ops.kernels.motif_kernel import (
    _device_parents, chain_move, chain_move_plain, chain_move_route)
from onmf_ontf_ndl_tpu_torch.utils.capture import capture_step, replay

__all__ = ["path_adj", "tree_parents", "tree_sample", "rw_update",
           "glauber_update", "pivot_update", "patch_from_embedding",
           "pair_matrices_T", "sample_patches", "sample_patches_ensemble"]


def path_adj(k1: int, k2: int) -> np.ndarray:
    """Adjacency of the path motif with k1 left / k2 right arms rooted at
    node 0 (``network_reconstruction_nx.py:86-95``)."""
    if k1 == 0 or k2 == 0:
        return np.eye(max(k1, k2) + 1, k=1, dtype=int)
    A = np.eye(k1 + k2 + 1, k=1, dtype=int)
    A[k1, k1 + 1] = 0
    A[0, k1 + 1] = 1
    return A


def tree_parents(B: np.ndarray) -> tuple[int, ...]:
    """Parent of each non-root motif node: its smallest in-neighbour, or
    -1 (embed as a uniform node) when it has none."""
    B = np.asarray(B)
    parents = []
    for i in range(1, B.shape[0]):
        js = np.flatnonzero(B[:, i] == 1)
        parents.append(int(js.min()) if len(js) else -1)
    return tuple(parents)


def _motif_neighbor_table(B: np.ndarray) -> np.ndarray:
    """(k, max_deg) neighbours of each node in the symmetrized motif,
    padded with -1."""
    Bsym = np.asarray((np.asarray(B) + np.asarray(B).T) > 0)
    k = Bsym.shape[0]
    deg = Bsym.sum(axis=1).astype(int)
    tbl = np.full((k, max(int(deg.max()), 1)), -1, np.int64)
    for i in range(k):
        js = np.flatnonzero(Bsym[i])
        tbl[i, :len(js)] = js
    return tbl


@functools.lru_cache(maxsize=16)
def _device_neighbor_table(B_bytes: bytes, k: int, device: torch.device):
    return torch.as_tensor(_motif_neighbor_table(
        np.frombuffer(B_bytes, np.int8).reshape(k, k)), device=device)


def _neighbor_table_on(B: np.ndarray, device) -> torch.Tensor:
    """:func:`_motif_neighbor_table` on ``device``, copied there once per
    motif (a copy per chain step would wait for the device each time)."""
    B = np.asarray(B, np.int8)
    return _device_neighbor_table(B.tobytes(), B.shape[0],
                                  torch.device(device))


def _uniform(gen, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device)


def _randint(gen, high: int, shape, device) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=gen, device=device)


def _csr_at(g, pos: torch.Tensor) -> torch.Tensor:
    """``nbr_flat[pos]`` with positions past the end clamped, and zeros for
    an empty edge set (both are masked out by every caller)."""
    if g.nbr_flat.shape[0] == 0:
        return torch.zeros_like(pos)
    return g.nbr_flat[pos.clamp(max=g.nbr_flat.shape[0] - 1)]


def _row_slots(g, u: torch.Tensor):
    """The ascending neighbour rows of nodes ``u``, padded to the maximum
    degree: ``(slots, ok)``, each ``u.shape + (D,)``."""
    if isinstance(g, (CsrGraph, BitsetGraph)):
        D = max(g.max_deg, 1)
        d_idx = torch.arange(D, device=u.device)
        if g.nbr_flat.shape[0] == 0:
            slots = torch.zeros(u.shape + (D,), dtype=torch.int64,
                                device=u.device)
        else:
            slots = _csr_at(g, g.offsets[u][..., None] + d_idx)
    else:
        d_idx = torch.arange(g.nbr.shape[1], device=u.device)
        slots = g.nbr[u]
    return slots, d_idx < g.deg[u][..., None]


def _bsearch_membership(g, row: torch.Tensor, col: torch.Tensor):
    """Whether (row, col) is an edge of a CSR-backed graph, for equal-shaped
    index tensors: a lower-bound binary search of ``col`` in ``row``'s
    ascending CSR row, ``bit_length(max_deg)`` halvings."""
    if g.nbr_flat.shape[0] == 0:
        return torch.zeros(row.shape, dtype=torch.bool, device=row.device)
    off = g.offsets[row]
    deg = g.deg[row]
    lo = torch.zeros_like(row)
    hi = deg.clone()
    for _ in range(max(int(g.max_deg).bit_length(), 1)):
        active = lo < hi
        mid = (lo + hi) // 2
        go_right = active & (_csr_at(g, off + mid) < col)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return (lo < deg) & (_csr_at(g, off + lo) == col)


def _has_edges(g, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Edge indicators for equal-shaped index tensors, any representation."""
    if isinstance(g, BitsetGraph):
        words = g.bits[row, col >> 5]
        return ((words >> (col & 31).to(words.dtype)) & 1).bool()
    if isinstance(g, CsrGraph):
        return _bsearch_membership(g, row, col)
    return g.adj[row, col]


# ------------------------------------------------------------ the moves:
# each its draws and their use, the apply half (see the module docstring)
def _neighbor_at(g, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The neighbour of each node of ``x`` that the uniforms ``u`` pick (a
    uniform one); ``x`` itself where it is isolated."""
    d = g.deg[x]
    d1 = d.clamp_min(1)
    idx = torch.minimum((u * d1).long(), d1 - 1)
    if isinstance(g, (CsrGraph, BitsetGraph)):
        y = _csr_at(g, g.offsets[x] + idx)
    else:
        y = g.nbr[x, idx]
    return torch.where(d > 0, y, x)


def _walk_draws(gen, n: int, x: torch.Tensor) -> tuple:
    """The draws of one walk step of the chains at ``x``: the neighbour's
    uniform, the acceptance's uniform and the jump of an isolated node."""
    return (_uniform(gen, x.shape, x.device), _uniform(gen, x.shape, x.device),
            _randint(gen, n, x.shape, x.device))


def _walk_apply(g, x: torch.Tensor, draws: tuple) -> torch.Tensor:
    """The walk step of :func:`rw_update` from its draws."""
    u_nb, u_acc, jump = draws
    y = _neighbor_at(g, x, u_nb)
    dx = g.deg[x]
    accept = u_acc < dx.float() / g.deg[y].clamp_min(1).float()
    y = torch.where(accept, y, x)
    return torch.where(dx > 0, y, jump)


def _tree_draws(gen, parents: tuple[int, ...], n: int,
                x: torch.Tensor) -> tuple:
    """The draws of a tree grown from pivots ``x``: one uniform per non-root
    motif node, (k-1,) + x.shape, then a uniform node per parentless motif
    node in node order, one randint call each, into the rows of one
    (P,) + x.shape tensor."""
    u = _uniform(gen, (len(parents),) + x.shape, x.device)
    roots = torch.empty((sum(p < 0 for p in parents),) + x.shape,
                        dtype=torch.int64, device=x.device)
    for row in roots:
        torch.randint(0, n, x.shape, generator=gen, out=row)
    return u, roots


def _tree_apply(g, emb: torch.Tensor, draws: tuple,
                parents: tuple[int, ...]) -> None:
    """Grow the trees of :func:`tree_sample` from the roots ``emb[:, 0]``
    and their draws, in place: each motif node in depth-first order takes
    the neighbour of its parent's image that its uniform picks."""
    u, roots = draws
    q = 0
    for i, p in enumerate(parents, start=1):
        if p < 0:   # parentless motif node: uniform over all nodes
            emb[:, i] = roots[q]
            q += 1
        else:
            emb[:, i] = _neighbor_at(g, emb[:, p], u[i - 1])


def _glauber_draws(gen, C: int, k: int, n: int, device) -> tuple:
    """The draws of one Glauber move of C chains, k > 1: the motif node j,
    the rank-select's uniform and the uniform fallback node."""
    return (_randint(gen, k, (C,), device), _uniform(gen, (C,), device),
            _randint(gen, n, (C,), device))


def _glauber_apply(g, emb: torch.Tensor, draws: tuple,
                   tbl: torch.Tensor) -> None:
    """The Glauber move of :func:`glauber_update` from its draws, in place
    on ``emb`` (only ``emb[c, j[c]]`` changes, after every read)."""
    j, u, fallback = draws
    C = emb.shape[0]
    sel = tbl[j]                                      # (C, S)
    S = sel.shape[1]
    valid = sel >= 0
    imgs = emb.gather(1, sel.clamp_min(0))            # constraint images
    first = valid.long().argmax(1)                    # first valid slot
    cand, ok = _row_slots(g, imgs.gather(1, first[:, None])[:, 0])
    # every candidate against every other valid constraint, in one query
    D = cand.shape[1]
    member = _has_edges(g, imgs[:, :, None].expand(C, S, D),
                        cand[:, None, :].expand(C, S, D))
    active = valid & (torch.arange(S, device=emb.device) != first[:, None])
    ok &= (member | ~active[:, :, None]).all(1)
    # no valid constraint (edgeless motif): the uniform fallback
    ok &= valid.any(1)[:, None]
    # rank-select: the target-th valid candidate, target from one uniform
    c = ok.long().cumsum(1)
    total = c[:, -1]
    target = torch.minimum((u * total).long() + 1, total.clamp_min(1))
    idx = (c >= target[:, None]).long().argmax(1)
    y = cand.gather(1, idx[:, None])[:, 0]
    emb[torch.arange(C, device=emb.device), j] = torch.where(total > 0, y,
                                                             fallback)


def _move(kind: str, emb: torch.Tensor, draws: tuple, g, tbl=None,
          parents: tuple = (), backend: str = "auto") -> torch.Tensor:
    """Apply a move's draws in place on ``emb``: the kernel
    (``chain_move``) or its plain version, as :func:`chain_move_route`
    picks from the device and ``backend``."""
    apply = (chain_move if chain_move_route(emb.device.type, backend)
             == "kernel" else chain_move_plain)
    return apply(kind, emb, draws, g, tbl, parents)


def tree_sample(gen, parents: tuple[int, ...], g, x: torch.Tensor):
    """Grow embeddings from pivots ``x`` (C,): each motif node in
    depth-first order takes a uniform neighbour of its parent's image.
    Returns (C, k)."""
    k = len(parents) + 1
    emb = torch.empty(x.shape + (k,), dtype=torch.int64, device=x.device)
    emb[:, 0] = x
    return _move("tree", emb, _tree_draws(gen, parents, g.num_nodes, x), g,
                 parents=parents)


def rw_update(gen, g, x: torch.Tensor) -> torch.Tensor:
    """One Metropolis-Hastings walk step per chain (uniform stationary
    law): propose a uniform neighbour y, accept with probability
    min(1, deg x / deg y); an isolated x jumps to a uniform node."""
    draws = _walk_draws(gen, g.num_nodes, x.reshape(-1))
    emb = x.reshape(-1, 1).to(torch.int64, copy=True)
    return _move("walk", emb, draws, g)[:, 0].reshape(x.shape)


def glauber_update(gen, B: np.ndarray, parents: tuple[int, ...], g,
                   emb: torch.Tensor) -> torch.Tensor:
    """One Glauber move per chain on (C, k) embeddings; returns new ones."""
    C, k = emb.shape
    emb = emb.clone()
    if k == 1:   # a single-node motif moves as the walk
        return _move("walk", emb, _walk_draws(gen, g.num_nodes, emb[:, 0]),
                     g)
    return _move("glauber", emb, _glauber_draws(gen, C, k, g.num_nodes,
                                                emb.device), g,
                 _neighbor_table_on(B, emb.device))


def pivot_update(gen, B: np.ndarray, parents: tuple[int, ...], g,
                 emb: torch.Tensor) -> torch.Tensor:
    """Pivot move per chain: walk the root, then regrow the whole tree."""
    x = emb[:, 0]
    draws = (_walk_draws(gen, g.num_nodes, x)
             + _tree_draws(gen, parents, g.num_nodes, x))
    return _move("pivot", emb.to(torch.int64, copy=True), draws, g,
                 parents=parents)


def pair_matrices_T(g, embs: torch.Tensor, *,
                    weighted: bool = False) -> torch.Tensor:
    """Patches of a batch of (M, k) embeddings as a float32 (k*k, M)
    matrix: entry ``(q*k + r, m)`` is the edge indicator (or weight) of
    pair (q, r) in sample m."""
    M, k = embs.shape
    eT = embs.T                                        # (k, M)
    if weighted:
        if getattr(g, "weight", None) is None:
            raise ValueError("weighted patches need a weighted Graph")
        row = eT[:, None, :].expand(k, k, M).reshape(k * k, M)
        col = eT[None, :, :].expand(k, k, M).reshape(k * k, M)
        return g.weight[row, col].float()
    iu, ju = np.triu_indices(k, 1)
    P = len(iu)
    mem = _has_edges(g, eT[torch.as_tensor(iu, device=eT.device)],
                     eT[torch.as_tensor(ju, device=eT.device)])  # (P, M)
    stacked = torch.cat([mem.float(),
                         mem.new_zeros((1, M), dtype=torch.float32)])
    pairidx = np.full((k, k), P, np.int64)             # P: the zero row
    pairidx[iu, ju] = np.arange(P)
    pairidx[ju, iu] = np.arange(P)
    return stacked[torch.as_tensor(pairidx.reshape(-1), device=eT.device)]


def patch_from_embedding(g, emb: torch.Tensor, *,
                         weighted: bool = False) -> torch.Tensor:
    """The k x k induced adjacency (or weight) patch of one embedding."""
    k = emb.shape[0]
    return pair_matrices_T(g, emb[None], weighted=weighted).reshape(k, k)


# ------------------------------------------------------------- the chain:
# one move function on static buffers, called in a Python loop (eager) or
# captured once as a CUDA graph and replayed (captured), the counterpart of
# the JAX package's jitted lax.scan over the moves
# (onmf_ontf_ndl_tpu/samplers/motif.py:652-700).

# Chain graphs kept at once, the least recently used dropped first: each
# holds its buffers, a memory pool of its move's intermediates and the
# graph tensors its move reads. Eight hold the training and reconstruction
# chains of four graphs.
_CHAIN_CACHE_SIZE = 8
_CHAIN_GRAPHS: collections.OrderedDict = collections.OrderedDict()


@dataclasses.dataclass
class _Chains:
    """The buffers a move reads and writes in place: the (C, k)
    embeddings, and the step counter at which the trail records them."""

    emb: torch.Tensor
    step: torch.Tensor


def _new_chains(emb0: torch.Tensor) -> _Chains:
    """Buffers for the chains ``emb0``, filled from it."""
    emb = torch.empty(emb0.shape, dtype=torch.int64, device=emb0.device)
    emb.copy_(emb0)
    return _Chains(emb=emb, step=torch.zeros(1, dtype=torch.int64,
                                             device=emb0.device))


def _chain_move(ch: _Chains, gen, B: np.ndarray, parents: tuple[int, ...],
                g, use_glauber: bool, backend: str = "auto") -> None:
    """One Glauber or pivot move of every chain on the buffers ``ch``: its
    draws from ``gen``, then the kernel or its plain version (as
    ``backend`` and the device pick, :func:`_move`) in place on
    ``ch.emb``. This is what a chain graph captures."""
    C, k = ch.emb.shape
    dev, n = ch.emb.device, g.num_nodes
    if use_glauber and k > 1:
        _move("glauber", ch.emb, _glauber_draws(gen, C, k, n, dev), g,
              _neighbor_table_on(B, dev), backend=backend)
    elif use_glauber:   # a single-node motif moves as the walk
        _move("walk", ch.emb, _walk_draws(gen, n, ch.emb[:, 0]), g,
              backend=backend)
    else:
        x = ch.emb[:, 0]
        _move("pivot", ch.emb, _walk_draws(gen, n, x)
              + _tree_draws(gen, parents, n, x), g, parents=parents,
              backend=backend)


def _record(ch: _Chains, trail: torch.Tensor) -> None:
    """Record the chains' embeddings in the (C, steps, k) ``trail`` at the
    step counter, and advance it. Both routes run it after each move, the
    captured one outside its graph: a graph keeps no trail of its own, and
    a run of any length replays it."""
    trail.index_copy_(1, ch.step, ch.emb[:, None])
    ch.step += 1


def _chain_route(device_type: str, capture: bool = True) -> str:
    """How :func:`run_chains` runs its moves: ``"captured"`` (one move
    captured as a CUDA graph, replayed) on a CUDA tensor, ``"eager"`` (the
    move function in a Python loop) on the CPU or with ``capture=False``
    (tests and the card's comparisons)."""
    return "captured" if capture and device_type == "cuda" else "eager"


def _graph_tensors(g) -> tuple:
    """The tensors of ``g`` that a move of either kind reads."""
    if isinstance(g, BitsetGraph):
        return g.bits, g.nbr_flat, g.offsets, g.deg
    if isinstance(g, CsrGraph):
        return g.nbr_flat, g.offsets, g.deg
    return g.adj, g.nbr, g.deg


def _chain_key(g, emb0: torch.Tensor, B: np.ndarray, use_glauber: bool,
               backend: str = "auto") -> tuple:
    """The cache key of the graph of a move like this call's: all that a
    capture bakes in. The chain count and k, the device, the motif and its
    tree, the kind of move, the route of its arithmetic (the kernel or the
    plain version: :func:`chain_move_route` of the device and
    ``backend``), the graph's representation, node count and maximum
    degree, and the address, shape, strides and dtype of each graph tensor
    the move reads. Not the embeddings' values or dtype (they are copied
    into an int64 buffer), the generator or the number of moves."""
    B = np.asarray(B, np.int8)
    return (tuple(emb0.shape), emb0.device, B.tobytes(), tree_parents(B),
            bool(use_glauber), chain_move_route(emb0.device.type, backend),
            type(g), g.num_nodes,
            getattr(g, "max_deg", None),
            tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in _graph_tensors(g)))


@dataclasses.dataclass
class _ChainGraph:
    """A captured move: its graph, its buffers, the generator registered
    with it, the kernel launches of one replay (one ``chain_move`` on the
    kernel's route, none on the plain one), and the tensors it reads that
    its caller owns (the graph's, the motif's neighbour table and parent
    list), held so that no replay reads freed memory."""

    graph: object
    chains: _Chains
    gen: torch.Generator
    launches: dict
    reads: tuple


def _run_captured_chains(gen, g, emb0: torch.Tensor, B: np.ndarray,
                         trail: torch.Tensor, use_glauber: bool,
                         backend: str) -> None:
    """The captured route: the graph of this key (captured on a miss, with
    its first move run as it is captured), replayed for the remaining
    moves, each followed by its record in ``trail``; the graph's generator
    takes ``gen``'s state before the replays and gives it back after."""
    key = _chain_key(g, emb0, B, use_glauber, backend)
    entry = _CHAIN_GRAPHS.pop(key, None)
    done = 0
    if entry is None:
        while len(_CHAIN_GRAPHS) >= _CHAIN_CACHE_SIZE:
            _CHAIN_GRAPHS.popitem(last=False)
        parents = tree_parents(B)
        ch = _new_chains(emb0)
        reads = _graph_tensors(g)
        if use_glauber and emb0.shape[1] > 1:
            reads += (_neighbor_table_on(B, emb0.device),)
        elif not use_glauber:
            reads += (_device_parents(parents, emb0.device),)
        graph, own, launches = capture_step(
            lambda gn: _chain_move(ch, gn, B, parents, g, use_glauber,
                                   backend),
            gen, emb0.device)
        entry = _ChainGraph(graph, ch, own, launches, reads)
        _record(ch, trail)
        done = 1
    else:
        entry.chains.emb.copy_(emb0)
        entry.chains.step.zero_()
    _CHAIN_GRAPHS[key] = entry
    replay(entry.graph, entry.gen, gen, trail.shape[1] - done,
           entry.launches, each=lambda: _record(entry.chains, trail))


def run_chains(gen, g, emb0: torch.Tensor, B: np.ndarray, steps: int, *,
               use_glauber: bool = True, capture: bool = True,
               backend: str = "auto") -> torch.Tensor:
    """Advance (C, k) chains ``steps`` moves; returns every state after a
    move, (C, steps, k).

    :func:`_chain_route` picks the route: on a CUDA tensor one move is
    captured as a CUDA graph (once per :func:`_chain_key`) and replayed
    for every move; on the CPU, or with ``capture=False``, the same move
    function runs in a Python loop. On both, each move's state is then
    recorded in the trail (:func:`_record`). A move's arithmetic runs the
    kernel of ``ops/kernels/motif_kernel.py`` on a CUDA tensor, or its
    plain version on the CPU and with ``backend="torch"`` (the
    comparisons); it raises where the kernel fails to build or launch.
    Every route draws the same numbers from ``gen``, leaves it in the same
    state and gives the same chains. A capture or replay that fails
    raises; no move falls back to the eager loop."""
    trail = torch.empty((emb0.shape[0], steps, emb0.shape[1]),
                        dtype=torch.int64, device=emb0.device)
    if steps and _chain_route(emb0.device.type, capture) == "captured":
        with torch.cuda.device(emb0.device):
            _run_captured_chains(gen, g, emb0, B, trail, use_glauber,
                                 backend)
        return trail
    parents = tree_parents(B)
    ch = _new_chains(emb0)
    for _ in range(steps):
        _chain_move(ch, gen, B, parents, g, use_glauber, backend)
        _record(ch, trail)
    return trail


def sample_patches_ensemble(gen, g, emb0: torch.Tensor, B: np.ndarray,
                            num: int, *, use_glauber: bool = True,
                            weighted: bool = False, capture: bool = True):
    """C chains (``emb0`` is (C, k)) advanced ``num`` moves each, a patch
    per move. Returns ``(X, embs)``: X (k^2, C*num), column ``c*num + s``
    the patch of chain c after move s; embs the final (C, k).
    ``capture``: as in :func:`run_chains`."""
    trail = run_chains(gen, g, emb0, B, num, use_glauber=use_glauber,
                       capture=capture)
    X = pair_matrices_T(g, trail.reshape(-1, emb0.shape[1]),
                        weighted=weighted)
    return X, trail[:, -1] if num else emb0


def sample_patches(gen, g, emb0: torch.Tensor, B: np.ndarray, num: int, *,
                   use_glauber: bool = True, weighted: bool = False):
    """One chain from the (k,) embedding ``emb0``, ``num`` moves, a patch
    per move (the reference's ``get_patches_glauber``). Returns
    ``(X, emb)`` with X of shape (k^2, num)."""
    X, embs = sample_patches_ensemble(gen, g, emb0[None], B, num,
                                      use_glauber=use_glauber,
                                      weighted=weighted)
    return X, embs[0]

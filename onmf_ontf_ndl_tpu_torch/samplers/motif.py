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
forms) runs in blocks of M moves (``_chain_block_moves``: M from the
shapes alone, the run's moves where a block's draws and trail fit 16 MiB;
a last block of the rest), one block function on static buffers
(``_chain_block``): the M moves' draws into (M, ...) buffers, then one
call that runs the M moves and writes the block's trail. On a CUDA tensor
it is captured once as a CUDA graph per cache key (``_chain_key``, which
holds M; ``_CHAIN_GRAPHS``, a ``utils/capture.py::GraphCache``, holds
sixteen) and replayed for every block, its draws from a generator
registered with the graph, which hands the caller's generator state in
and back; on the CPU,
and with ``capture=False``, it runs in a Python loop. After each block
its trail is copied into the run's. All routes draw the same numbers and
give the same chains as moves run one at a time.

Each move is split into its draws (a fixed number of tensors of
data-independent shape, drawn in torch from the generator: ``_walk_draws``,
``_tree_draws``, ``_glauber_draws``) and their use (``_walk_apply``,
``_tree_apply``, ``_glauber_apply``). On a CUDA tensor the use of a block
is one launch of the hand-written kernel of ``ops/kernels/motif_kernel.py``
(``chain_moves``; every block of ``run_chains`` on both routes, and the
single moves: ``tree_sample`` and the three updates, blocks of one); the
apply functions, one move after another (``chain_moves_plain``), are its
plain version, which runs on the CPU and, for comparisons, with
``run_chains(..., backend="torch")``. The kernel repeats the plain
arithmetic, so both give the same chains bit for bit.

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

import dataclasses
import functools

import numpy as np
import torch

from onmf_ontf_ndl_tpu_torch.data.graphs import BitsetGraph, CsrGraph
from onmf_ontf_ndl_tpu_torch.ops.kernels.motif_kernel import (
    _device_parents, chain_move_route, chain_moves, chain_moves_plain)
from onmf_ontf_ndl_tpu_torch.utils.capture import GraphCache, tensor_at

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
    B = np.asarray(B) == 1
    return _tree_parents(B.tobytes(), B.shape[0])


@functools.lru_cache(maxsize=64)
def _tree_parents(edges: bytes, k: int) -> tuple[int, ...]:
    """:func:`tree_parents` of the motif whose (k, k) edge indicators are
    ``edges``, once per motif (every chain run asks)."""
    B = np.frombuffer(edges, bool).reshape(k, k)
    parents = []
    for i in range(1, k):
        js = np.flatnonzero(B[:, i])
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


def _walk_draws(gen, n: int, x: torch.Tensor, out=None) -> tuple:
    """The draws of one walk step of the chains at ``x``: the neighbour's
    uniform, the acceptance's uniform and the jump of an isolated node;
    into the three tensors ``out`` (of x's shape) where given."""
    u_nb, u_acc, jump = out if out is not None else (
        torch.empty(x.shape, device=x.device),
        torch.empty(x.shape, device=x.device),
        torch.empty(x.shape, dtype=torch.int64, device=x.device))
    torch.rand(x.shape, generator=gen, out=u_nb)
    torch.rand(x.shape, generator=gen, out=u_acc)
    torch.randint(0, n, x.shape, generator=gen, out=jump)
    return u_nb, u_acc, jump


def _walk_apply(g, x: torch.Tensor, draws: tuple) -> torch.Tensor:
    """The walk step of :func:`rw_update` from its draws."""
    u_nb, u_acc, jump = draws
    y = _neighbor_at(g, x, u_nb)
    dx = g.deg[x]
    accept = u_acc < dx.float() / g.deg[y].clamp_min(1).float()
    y = torch.where(accept, y, x)
    return torch.where(dx > 0, y, jump)


def _tree_draws(gen, parents: tuple[int, ...], n: int, x: torch.Tensor,
                out=None) -> tuple:
    """The draws of a tree grown from pivots ``x``: one uniform per non-root
    motif node, (k-1,) + x.shape, then a uniform node per parentless motif
    node in node order, one randint call each, into the rows of one
    (P,) + x.shape tensor; into the two tensors ``out`` where given."""
    u, roots = out if out is not None else (
        torch.empty((len(parents),) + x.shape, device=x.device),
        torch.empty((sum(p < 0 for p in parents),) + x.shape,
                    dtype=torch.int64, device=x.device))
    torch.rand(u.shape, generator=gen, out=u)
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


def _glauber_draws(gen, C: int, k: int, n: int, device, out=None) -> tuple:
    """The draws of one Glauber move of C chains, k > 1: the motif node j,
    the rank-select's uniform and the uniform fallback node; into the
    three (C,) tensors ``out`` where given."""
    j, u, fallback = out if out is not None else (
        torch.empty(C, dtype=torch.int64, device=device),
        torch.empty(C, device=device),
        torch.empty(C, dtype=torch.int64, device=device))
    torch.randint(0, k, (C,), generator=gen, out=j)
    torch.rand((C,), generator=gen, out=u)
    torch.randint(0, n, (C,), generator=gen, out=fallback)
    return j, u, fallback


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


def _moves(kind: str, emb: torch.Tensor, draws: tuple, g, tbl=None,
           parents: tuple = (), trail=None,
           backend: str = "auto") -> torch.Tensor:
    """Apply a block of moves' (M, ...) draws in place on ``emb``, each
    move's state into ``trail`` where given: the kernel (``chain_moves``)
    or its plain version, as :func:`chain_move_route` picks from the
    device and ``backend``."""
    apply = (chain_moves if chain_move_route(emb.device.type, backend)
             == "kernel" else chain_moves_plain)
    return apply(kind, emb, draws, g, tbl, parents, trail)


def _one(draws: tuple) -> tuple:
    """One move's draws as a block of M = 1."""
    return tuple(d[None] for d in draws)


def tree_sample(gen, parents: tuple[int, ...], g, x: torch.Tensor):
    """Grow embeddings from pivots ``x`` (C,): each motif node in
    depth-first order takes a uniform neighbour of its parent's image.
    Returns (C, k)."""
    k = len(parents) + 1
    emb = torch.empty(x.shape + (k,), dtype=torch.int64, device=x.device)
    emb[:, 0] = x
    return _moves("tree", emb, _one(_tree_draws(gen, parents, g.num_nodes,
                                                x)), g, parents=parents)


def rw_update(gen, g, x: torch.Tensor) -> torch.Tensor:
    """One Metropolis-Hastings walk step per chain (uniform stationary
    law): propose a uniform neighbour y, accept with probability
    min(1, deg x / deg y); an isolated x jumps to a uniform node."""
    draws = _walk_draws(gen, g.num_nodes, x.reshape(-1))
    emb = x.reshape(-1, 1).to(torch.int64, copy=True)
    return _moves("walk", emb, _one(draws), g)[:, 0].reshape(x.shape)


def glauber_update(gen, B: np.ndarray, parents: tuple[int, ...], g,
                   emb: torch.Tensor) -> torch.Tensor:
    """One Glauber move per chain on (C, k) embeddings; returns new ones."""
    C, k = emb.shape
    emb = emb.clone()
    if k == 1:   # a single-node motif moves as the walk
        return _moves("walk", emb, _one(_walk_draws(gen, g.num_nodes,
                                                    emb[:, 0])), g)
    return _moves("glauber", emb, _one(_glauber_draws(
        gen, C, k, g.num_nodes, emb.device)), g,
        _neighbor_table_on(B, emb.device))


def pivot_update(gen, B: np.ndarray, parents: tuple[int, ...], g,
                 emb: torch.Tensor) -> torch.Tensor:
    """Pivot move per chain: walk the root, then regrow the whole tree."""
    x = emb[:, 0]
    draws = (_walk_draws(gen, g.num_nodes, x)
             + _tree_draws(gen, parents, g.num_nodes, x))
    return _moves("pivot", emb.to(torch.int64, copy=True), _one(draws), g,
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
    iu, ju, pairidx = _pair_tables(k, eT.device)
    mem = _has_edges(g, eT[iu], eT[ju])                # (P, M)
    stacked = torch.cat([mem.float(),
                         mem.new_zeros((1, M), dtype=torch.float32)])
    return stacked[pairidx]


@functools.lru_cache(maxsize=16)
def _pair_tables(k: int, device: torch.device) -> tuple:
    """The index tables of :func:`pair_matrices_T` on ``device``, copied
    there once per (k, device) (a copy per batch would wait for the device,
    and a CUDA graph cannot capture one): the P = k(k-1)/2 unordered pairs'
    rows ``iu`` and columns ``ju``, and ``pairidx`` (k*k,), each pair
    (q, r)'s row of the stacked (P + 1, M) indicators, P (the zero row) on
    the diagonal."""
    iu, ju = np.triu_indices(k, 1)
    P = len(iu)
    pairidx = np.full((k, k), P, np.int64)
    pairidx[iu, ju] = np.arange(P)
    pairidx[ju, iu] = np.arange(P)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (iu, ju, pairidx.reshape(-1)))


def patch_from_embedding(g, emb: torch.Tensor, *,
                         weighted: bool = False) -> torch.Tensor:
    """The k x k induced adjacency (or weight) patch of one embedding."""
    k = emb.shape[0]
    return pair_matrices_T(g, emb[None], weighted=weighted).reshape(k, k)


# ------------------------------------------------------------- the chain:
# one block of moves on static buffers, called in a Python loop (eager) or
# captured once as a CUDA graph and replayed (captured), the counterpart of
# the JAX package's jitted lax.scan over the moves
# (onmf_ontf_ndl_tpu/samplers/motif.py:652-700).

# Chain graphs kept at once, the least recently used dropped first: each
# holds its buffers (the embeddings, a block's draws and trail: at most
# _BLOCK_BYTES), a memory pool of its block's intermediates (none on the
# kernel's route) and the graph tensors its block reads. A network app
# makes up to six (a block and its rest for training, for reconstruction
# and for a chunked reconstruction's chunks, which share theirs), so
# sixteen hold the chains of two apps without capturing any again.
_CHAIN_GRAPHS = GraphCache("chain", 16)
# The bytes of a block's draws and trail at most: they set its moves.
_BLOCK_BYTES = 16 << 20


def _chain_kind(use_glauber: bool, k: int) -> str:
    """The move of a chain: ``"glauber"``, ``"walk"`` (a one-node motif's
    Glauber move) or ``"pivot"``."""
    if use_glauber:
        return "glauber" if k > 1 else "walk"
    return "pivot"


def _chain_block_moves(C: int, k: int, kind: str, steps: int,
                       roots: int = 0) -> int:
    """The moves M of a block of a run of ``steps`` moves of C chains of k
    nodes (``roots``: the motif's parentless nodes): ``steps`` where the
    block's draws and its (C, M, k) trail fit :data:`_BLOCK_BYTES`, else
    the most that fit (at least 1). Shapes alone."""
    draw = {"glauber": 8 + 4 + 8, "walk": 4 + 4 + 8,
            "pivot": 4 + 4 + 8 + 4 * (k - 1) + 8 * roots}[kind]
    return max(1, min(steps, _BLOCK_BYTES // (max(C, 1) * (draw + 8 * k))))


def _chain_blocks(steps: int, moves: int) -> list:
    """A run's blocks as ``(moves, times)``: ``steps // moves`` blocks of
    ``moves``, then one of the rest where there is a rest."""
    blocks = [(moves, steps // moves)]
    if steps % moves:
        blocks.append((steps % moves, 1))
    return blocks


@dataclasses.dataclass
class _Chains:
    """The buffers a block of M moves reads and writes in place: the
    (C, k) embeddings, the block's (M, ...) draws (those of
    :func:`_glauber_draws`, or of :func:`_walk_draws` and, for the pivot,
    :func:`_tree_draws`) and its (C, M, k) trail."""

    emb: torch.Tensor
    draws: tuple
    trail: torch.Tensor


def _new_chains(emb0: torch.Tensor, kind: str, moves: int,
                roots: int = 0) -> _Chains:
    """Buffers for a block of ``moves`` moves of kind ``kind`` of the
    chains ``emb0``, the embeddings filled from it."""
    C, k = emb0.shape
    dev = emb0.device
    emb = torch.empty((C, k), dtype=torch.int64, device=dev)
    emb.copy_(emb0)
    ints = functools.partial(torch.empty, dtype=torch.int64, device=dev)
    floats = functools.partial(torch.empty, device=dev)
    if kind == "glauber":
        draws = (ints(moves, C), floats(moves, C), ints(moves, C))
    else:
        draws = (floats(moves, C), floats(moves, C), ints(moves, C))
        if kind == "pivot":
            draws += (floats(moves, k - 1, C), ints(moves, roots, C))
    return _Chains(emb=emb, draws=draws, trail=ints(C, moves, k))


def _block_draws(ch: _Chains, gen, parents: tuple[int, ...], n: int,
                 kind: str) -> None:
    """The block's draws from ``gen``: each move's in the plain move's
    order into row s of ``ch.draws``."""
    C, k = ch.emb.shape
    x = ch.emb[:, 0]          # its shape only
    for s in range(ch.trail.shape[1]):
        row = tuple(d[s] for d in ch.draws)
        if kind == "glauber":
            _glauber_draws(gen, C, k, n, x.device, out=row)
        else:
            _walk_draws(gen, n, x, out=row[:3])
            if kind == "pivot":
                _tree_draws(gen, parents, n, x, out=row[3:])


def _chain_block(ch: _Chains, gen, B: np.ndarray, parents: tuple[int, ...],
                 g, use_glauber: bool, backend: str = "auto") -> None:
    """A block of Glauber or pivot moves of every chain on the buffers
    ``ch``: the M moves' draws (:func:`_block_draws`), then one call of the
    kernel or its plain version (as ``backend`` and the device pick,
    :func:`_moves`) that runs the M moves in place on ``ch.emb`` and
    writes ``ch.trail``. This is what a chain graph captures."""
    kind = _chain_kind(use_glauber, ch.emb.shape[1])
    _block_draws(ch, gen, parents, g.num_nodes, kind)
    tbl = _neighbor_table_on(B, ch.emb.device) if kind == "glauber" else None
    _moves(kind, ch.emb, ch.draws, g, tbl, parents, ch.trail, backend)


def _chain_route(device_type: str, capture: bool = True) -> str:
    """How :func:`run_chains` runs its blocks: ``"captured"`` (a block
    captured as a CUDA graph, replayed) on a CUDA tensor, ``"eager"`` (the
    block function in a Python loop) on the CPU or with ``capture=False``
    (tests and the card's comparisons)."""
    return "captured" if capture and device_type == "cuda" else "eager"


def _graph_tensors(g) -> tuple:
    """The tensors of ``g`` that a move of either kind reads."""
    if isinstance(g, BitsetGraph):
        return g.bits, g.nbr_flat, g.offsets, g.deg
    if isinstance(g, CsrGraph):
        return g.nbr_flat, g.offsets, g.deg
    return g.adj, g.nbr, g.deg


def _chain_baked(g, B: np.ndarray, use_glauber: bool, device_type: str,
                 backend: str = "auto") -> tuple:
    """What a graph of chain blocks bakes in besides its shapes and the
    graph tensors' addresses: the motif (which sets its tree), the kind of
    move, the route of its arithmetic (the kernel or the plain version:
    :func:`chain_move_route` of the device and ``backend``) and the graph's
    representation, node count and maximum degree."""
    B = np.asarray(B, np.int8)
    return (B.tobytes(), B.shape, bool(use_glauber),
            chain_move_route(device_type, backend), type(g), g.num_nodes,
            getattr(g, "max_deg", None))


def _chain_reads(g, B: np.ndarray, kind: str, device) -> tuple:
    """The tensors a block of moves of ``kind`` reads in place: the
    graph's, and the motif's neighbour table (Glauber) or parent list
    (pivot)."""
    reads = _graph_tensors(g)
    if kind == "glauber":
        reads += (_neighbor_table_on(B, device),)
    elif kind == "pivot":
        reads += (_device_parents(tree_parents(B), torch.device(device)),)
    return reads


def _chain_key(g, emb0: torch.Tensor, B: np.ndarray, use_glauber: bool,
               moves: int, backend: str = "auto") -> tuple:
    """The cache key of the graph of a block like this call's: all that a
    capture bakes in. The chain count and k, the device, the block's moves,
    :func:`_chain_baked`, and the address, shape, strides and dtype of each
    graph tensor the block reads. Not the embeddings' values or dtype
    (they are copied into an int64 buffer), the generator or the run's
    number of moves (only through ``moves``)."""
    return (tuple(emb0.shape), emb0.device, int(moves),
            *_chain_baked(g, B, use_glauber, emb0.device.type, backend),
            tuple(tensor_at(t) for t in _graph_tensors(g)))


def run_chains(gen, g, emb0: torch.Tensor, B: np.ndarray, steps: int, *,
               use_glauber: bool = True, capture: bool = True,
               backend: str = "auto") -> torch.Tensor:
    """Advance (C, k) chains ``steps`` moves; returns every state after a
    move, (C, steps, k).

    The moves run in blocks of M (:func:`_chain_block_moves`, from the
    shapes alone; a last block of the rest), each its M moves' draws and
    one call of the kernel of ``ops/kernels/motif_kernel.py`` (or, on the
    CPU and with ``backend="torch"``, its plain version), which writes the
    block's trail; the block's trail is then copied into the run's.
    :func:`_chain_route` picks the route: on a CUDA tensor a block is
    captured as a CUDA graph (once per :func:`_chain_key`) and replayed;
    on the CPU, or with ``capture=False``, the same block function runs in
    a Python loop. It raises where the kernel fails to build or launch.
    Every route draws the same numbers from ``gen``, leaves it in the same
    state and gives the same chains as moves run one at a time. A capture
    or replay that fails raises; no block falls back to the eager loop."""
    C, k = emb0.shape
    trail = torch.empty((C, steps, k), dtype=torch.int64, device=emb0.device)
    if not steps:
        return trail
    parents = tree_parents(B)
    kind = _chain_kind(use_glauber, k)
    roots = sum(p < 0 for p in parents)
    captured = _chain_route(emb0.device.type, capture) == "captured"

    def block(ch, gn):
        _chain_block(ch, gn, B, parents, g, use_glauber, backend)

    emb, done = emb0, 0
    for moves, times in _chain_blocks(
            steps, _chain_block_moves(C, k, kind, steps, roots)):

        def record(ch, i):          # block i's trail into the run's
            at = done + i * moves
            trail[:, at:at + moves] = ch.trail

        new = functools.partial(_new_chains, emb, kind, moves, roots)
        if captured:
            ch = _CHAIN_GRAPHS.run(
                _chain_key(g, emb, B, use_glauber, moves, backend),
                emb0.device, (gen,), times, new,
                lambda ch: ch.emb.copy_(emb), block,
                reads=_chain_reads(g, B, kind, emb0.device), each=record)
        else:
            ch = new()
            for i in range(times):
                block(ch, gen)
                record(ch, i)
        emb, done = ch.emb, done + moves * times
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

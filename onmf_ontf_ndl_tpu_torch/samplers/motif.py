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
    """``nbr_flat[pos]`` with positions past the end clamped (they are
    masked out by every caller)."""
    return g.nbr_flat[pos.clamp(max=max(g.nbr_flat.shape[0] - 1, 0))]


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


def _uniform_neighbor(gen, g, x: torch.Tensor, u=None) -> torch.Tensor:
    """A uniform neighbour of each node of ``x`` (from the uniforms ``u``,
    drawn when None); ``x`` itself where it is isolated."""
    d = g.deg[x]
    if u is None:
        u = _uniform(gen, x.shape, x.device)
    d1 = d.clamp_min(1)
    idx = torch.minimum((u * d1).long(), d1 - 1)
    if isinstance(g, (CsrGraph, BitsetGraph)):
        y = _csr_at(g, g.offsets[x] + idx)
    else:
        y = g.nbr[x, idx]
    return torch.where(d > 0, y, x)


def tree_sample(gen, parents: tuple[int, ...], g, x: torch.Tensor):
    """Grow embeddings from pivots ``x`` (C,): each motif node in
    depth-first order takes a uniform neighbour of its parent's image.
    Returns (C, k)."""
    k = len(parents) + 1
    emb = torch.empty(x.shape + (k,), dtype=torch.int64, device=x.device)
    emb[:, 0] = x
    u = _uniform(gen, (k - 1,) + x.shape, x.device)   # one draw per tree
    for i, p in enumerate(parents, start=1):
        if p < 0:   # parentless motif node: uniform over all nodes
            emb[:, i] = _randint(gen, g.num_nodes, x.shape, x.device)
        else:
            emb[:, i] = _uniform_neighbor(gen, g, emb[:, p], u[i - 1])
    return emb


def rw_update(gen, g, x: torch.Tensor) -> torch.Tensor:
    """One Metropolis-Hastings walk step per chain (uniform stationary
    law): propose a uniform neighbour y, accept with probability
    min(1, deg x / deg y); an isolated x jumps to a uniform node."""
    y = _uniform_neighbor(gen, g, x)
    dx = g.deg[x]
    accept = (_uniform(gen, x.shape, x.device)
              < dx.float() / g.deg[y].clamp_min(1).float())
    y = torch.where(accept, y, x)
    jump = _randint(gen, g.num_nodes, x.shape, x.device)
    return torch.where(dx > 0, y, jump)


def _rank_select(gen, cand: torch.Tensor, ok: torch.Tensor, n: int):
    """Per row, a uniform pick among ``cand[ok]`` (rank-select from one
    uniform); uniform over [0, n) where a row has none."""
    c = ok.long().cumsum(1)
    total = c[:, -1]
    u = _uniform(gen, total.shape, cand.device)
    target = torch.minimum((u * total).long() + 1, total.clamp_min(1))
    idx = (c >= target[:, None]).long().argmax(1)
    y = cand.gather(1, idx[:, None])[:, 0]
    fallback = _randint(gen, n, total.shape, cand.device)
    return torch.where(total > 0, y, fallback)


def glauber_update(gen, B: np.ndarray, parents: tuple[int, ...], g,
                   emb: torch.Tensor) -> torch.Tensor:
    """One Glauber move per chain on (C, k) embeddings; returns new ones."""
    C, k = emb.shape
    emb = emb.clone()
    if k == 1:   # a single-node motif moves as the walk
        emb[:, 0] = rw_update(gen, g, emb[:, 0])
        return emb
    tbl = _neighbor_table_on(B, emb.device)
    j = _randint(gen, k, (C,), emb.device)
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
    emb[torch.arange(C, device=emb.device), j] = _rank_select(
        gen, cand, ok, g.num_nodes)
    return emb


def pivot_update(gen, B: np.ndarray, parents: tuple[int, ...], g,
                 emb: torch.Tensor) -> torch.Tensor:
    """Pivot move per chain: walk the root, then regrow the whole tree."""
    return tree_sample(gen, parents, g, rw_update(gen, g, emb[:, 0]))


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
                g, use_glauber: bool) -> None:
    """One Glauber or pivot move of every chain on the buffers ``ch``, its
    draws from ``gen``: the new embeddings are written back into
    ``ch.emb``. This is what a chain graph captures."""
    move = glauber_update if use_glauber else pivot_update
    ch.emb.copy_(move(gen, B, parents, g, ch.emb))


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


def _chain_key(g, emb0: torch.Tensor, B: np.ndarray,
               use_glauber: bool) -> tuple:
    """The cache key of the graph of a move like this call's: all that a
    capture bakes in. The chain count and k, the device, the motif and its
    tree, the kind of move, the graph's representation, node count and
    maximum degree, and the address, shape, strides and dtype of each graph
    tensor the move reads. Not the embeddings' values or dtype (they are
    copied into an int64 buffer), the generator or the number of moves."""
    B = np.asarray(B, np.int8)
    return (tuple(emb0.shape), emb0.device, B.tobytes(), tree_parents(B),
            bool(use_glauber), type(g), g.num_nodes,
            getattr(g, "max_deg", None),
            tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in _graph_tensors(g)))


@dataclasses.dataclass
class _ChainGraph:
    """A captured move: its graph, its buffers, the generator registered
    with it, the kernel launches of one replay (none: the move is plain
    PyTorch), and the tensors it reads that its caller owns (the graph's
    and the motif's neighbour table), held so that no replay reads freed
    memory."""

    graph: object
    chains: _Chains
    gen: torch.Generator
    launches: dict
    reads: tuple


def _run_captured_chains(gen, g, emb0: torch.Tensor, B: np.ndarray,
                         trail: torch.Tensor, use_glauber: bool) -> None:
    """The captured route: the graph of this key (captured on a miss, with
    its first move run as it is captured), replayed for the remaining
    moves, each followed by its record in ``trail``; the graph's generator
    takes ``gen``'s state before the replays and gives it back after."""
    key = _chain_key(g, emb0, B, use_glauber)
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
        graph, own, launches = capture_step(
            lambda gn: _chain_move(ch, gn, B, parents, g, use_glauber),
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
               use_glauber: bool = True, capture: bool = True
               ) -> torch.Tensor:
    """Advance (C, k) chains ``steps`` moves; returns every state after a
    move, (C, steps, k).

    :func:`_chain_route` picks the route: on a CUDA tensor one move is
    captured as a CUDA graph (once per :func:`_chain_key`) and replayed
    for every move; on the CPU, or with ``capture=False``, the same move
    function runs in a Python loop. On both, each move's state is then
    recorded in the trail (:func:`_record`). Both draw the same numbers
    from ``gen`` and leave it in the same state. A capture or replay that
    fails raises; no move falls back to the eager loop."""
    trail = torch.empty((emb0.shape[0], steps, emb0.shape[1]),
                        dtype=torch.int64, device=emb0.device)
    if steps and _chain_route(emb0.device.type, capture) == "captured":
        with torch.cuda.device(emb0.device):
            _run_captured_chains(gen, g, emb0, B, trail, use_glauber)
        return trail
    parents = tree_parents(B)
    ch = _new_chains(emb0)
    for _ in range(steps):
        _chain_move(ch, gen, B, parents, g, use_glauber)
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

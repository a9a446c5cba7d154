"""A hand-written CUDA kernel for the moves of the motif chains.

No Pallas kernel stands behind it: the JAX package runs its chains as one
jitted program (``onmf_ontf_ndl_tpu/samplers/motif.py:653-700``, a
``lax.scan`` over the moves, vmapped over the chains), and on this card the
kernels of ``csrc/motif_kernels.cu`` stand for that program's arithmetic.
Each call runs a block of M consecutive moves of every chain, in place on
the (C, k) int64 embeddings ``emb``, from draws that the caller took from
torch's generator in the plain moves' order (``samplers/motif.py``'s draw
functions) into (M, ...) tensors, row s for move s; with the block's
(C, M, k) int64 ``trail`` it writes the state after move s to
``trail[:, s]``. Kinds:

- ``"glauber"`` (k > 1): draws ``(j, u, fallback)``, each (M, C); ``tbl``
  the motif's (k, S) neighbour table. A warp a chain, or a team of warps a
  chain where chains are few for the card's SMs (:func:`chain_glauber_warps`).
- ``"walk"``: one Metropolis-Hastings step of ``emb[:, 0]`` a move, draws
  ``(u_neighbour, u_accept, jump)``, each (M, C) (a one-node motif).
- ``"pivot"``: the walk, then the tree regrown from the new root, draws
  the walk's three and ``(u_tree, roots)``: ``u_tree`` (M, k-1, C)
  float32, ``roots`` (M, P, C) int64, one row per parentless motif node in
  node order.
- ``"tree"``: the regrowth alone from ``emb[:, 0]`` as it stands, draws
  ``(u_tree, roots)`` (``tree_sample``: M = 1, no trail).

The last three run ``chain_pivot_kernel``: the walk a thread a chain,
then every move's tree a thread a (chain, move) pair, the chains spread
over the SMs (:func:`chain_pivot_chains`). Where the
graph is small (:func:`chain_staged`) both kernels stage its degrees (and
CSR row starts) in shared memory. The kernels compute what the plain moves
compute, float32 roundings included, so their chains equal the plain
moves' bit for bit. :func:`chain_moves_plain` is the plain version: the
"apply" half of ``samplers/motif.py``'s moves, one move after another,
each followed by its trail row.

:func:`chain_move_route` picks the kernel from the device and a backend
alone; ``samplers/motif.py`` calls it for every block. On a CUDA tensor
:func:`chain_moves` launches the kernel on the current stream or raises
(no host read of a device value, no allocation, no sync: a CUDA graph can
capture it) and counts the launch in ``_lib.LAUNCHES["chain_move"]``; on a
CPU tensor it runs the plain version. The kernels also count their own
runs on the card (``_lib.device_runs``).
"""

from __future__ import annotations

import functools

import torch

from onmf_ontf_ndl_tpu_torch.data.graphs import BitsetGraph, CsrGraph
from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (
    LAUNCHES, _on_cpu, _raise_on_error, _sm_count, _stream, build)

__all__ = ["chain_moves", "chain_moves_plain", "chain_move_route",
           "chain_glauber_warps", "chain_pivot_chains", "chain_staged",
           "KINDS"]

KINDS = ("glauber", "walk", "pivot", "tree")
_REP = {"dense": 0, "csr": 1, "bitset": 2}

# Team sizes of a Glauber chain, and the warps a team may take in all on
# each of the card's SMs: past that, warps of other chains fill the card
# anyway.
GLAUBER_TEAMS = (1, 2, 4, 8)
_TEAM_WARPS_PER_SM = 8
# The staged graph's bytes at most (STAGE_BYTES in csrc/motif_kernels.cu).
STAGE_BYTES = 96 * 1024
# The threads (chains at most) of a pivot block (PIVOT_THREADS in
# csrc/motif_kernels.cu).
PIVOT_THREADS = 128


def chain_move_route(device_type: str, backend: str = "auto") -> str:
    """How a block of moves of chains on ``device_type`` runs:
    ``"kernel"`` (:func:`chain_moves`) for ``backend="auto"`` on a CUDA
    tensor, ``"plain"`` (:func:`chain_moves_plain`) on the CPU or with
    ``backend="torch"`` (the comparisons of the tests and the chip
    scripts)."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown chain backend {backend!r}")
    return "kernel" if backend == "auto" and device_type == "cuda" else "plain"


def chain_glauber_warps(chains: int, max_deg: int, sms: int) -> int:
    """Warps of one chain's Glauber move on a card of ``sms`` SMs: the
    largest team of :data:`GLAUBER_TEAMS` that has a chunk of 32
    candidates of the longest row for each warp and keeps
    ``chains * warps`` within the warps that teams may take (8 an SM); 1
    (a warp a chain) where chains are many or rows short."""
    chunks = -(-max(max_deg, 1) // 32)
    warps = 1
    while (2 * warps in GLAUBER_TEAMS and 2 * warps <= chunks
           and 2 * warps * chains <= _TEAM_WARPS_PER_SM * sms):
        warps *= 2
    return warps


def chain_pivot_chains(chains: int, sms: int) -> int:
    """Chains of a block of the pivot kernel: the chains spread over the
    card's ``sms`` SMs, a block each where there are no more chains than
    SMs, at most :data:`PIVOT_THREADS` (the block's threads regrow its
    chains' trees)."""
    return min(max(-(-chains // sms), 1), PIVOT_THREADS)


def chain_staged(num_nodes: int, rep: str) -> bool:
    """Whether the kernels stage the graph in shared memory: its degrees
    as int32 (4 bytes a node), and for CSR and bitset graphs also the row
    starts (8 bytes a node), within :data:`STAGE_BYTES`."""
    return num_nodes * (4 if rep == "dense" else 8) <= STAGE_BYTES


def _rep(g) -> str:
    if isinstance(g, BitsetGraph):
        return "bitset"
    return "csr" if isinstance(g, CsrGraph) else "dense"


def _max_deg(g) -> int:
    return g.max_deg if isinstance(g, (CsrGraph, BitsetGraph)) \
        else g.nbr.shape[1]


def _apply(kind: str, emb: torch.Tensor, draws: tuple, g, tbl,
           parents: tuple) -> None:
    """One move of the plain version from its draws (each without the M
    axis), in place on ``emb``."""
    from onmf_ontf_ndl_tpu_torch.samplers import motif

    if kind == "glauber":
        motif._glauber_apply(g, emb, draws, tbl)
    elif kind in ("walk", "pivot"):
        emb[:, 0] = motif._walk_apply(g, emb[:, 0], draws[:3])
        if kind == "pivot":
            motif._tree_apply(g, emb, draws[3:], parents)
    elif kind == "tree":
        motif._tree_apply(g, emb, draws, parents)
    else:
        raise ValueError(f"unknown move {kind!r}; one of {KINDS}")


def chain_moves_plain(kind: str, emb: torch.Tensor, draws: tuple, g,
                      tbl=None, parents: tuple = (),
                      trail=None) -> torch.Tensor:
    """Plain PyTorch :func:`chain_moves`: the M moves of ``draws`` (M is
    their first axis), each the apply half of ``samplers/motif.py``'s move
    in place on ``emb``, then its state in ``trail[:, s]``; returns
    ``emb``."""
    for s in range(draws[0].shape[0]):
        _apply(kind, emb, tuple(d[s] for d in draws), g, tbl, parents)
        if trail is not None:
            trail[:, s] = emb
    return emb


@functools.lru_cache(maxsize=16)
def _device_parents(parents: tuple, device: torch.device) -> torch.Tensor:
    """The motif's parent list as an int64 tensor on ``device``, copied
    there once per motif (a copy per block would wait for the device)."""
    return torch.tensor(parents, dtype=torch.int64, device=device)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _graph_args(g) -> tuple:
    """The graph arguments of the C entry points: representation, node
    count, then the pointers and widths of ``GraphView``."""
    rep = _rep(g)
    if rep == "dense":
        tensors = {"adj": (g.adj, torch.bool), "nbr": (g.nbr, torch.int64),
                   "deg": (g.deg, torch.int64)}
    else:
        tensors = {"nbr_flat": (g.nbr_flat, torch.int64),
                   "offsets": (g.offsets, torch.int64),
                   "deg": (g.deg, torch.int64)}
        if rep == "bitset":
            tensors["bits"] = (g.bits, torch.int32)
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"chain_moves: the graph's {name} must be a "
                            f"contiguous {dtype} tensor")
    get = {name: t for name, (t, _) in tensors.items()}.get
    nbr, bits = get("nbr"), get("bits")
    return (_REP[rep], g.num_nodes, _ptr(get("adj")), _ptr(nbr),
            nbr.shape[1] if nbr is not None else 0, _ptr(get("nbr_flat")),
            _ptr(get("offsets")), g.deg.data_ptr(), _ptr(bits),
            bits.shape[1] if bits is not None else 0)


def _check(name: str, t: torch.Tensor, dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise TypeError(f"chain_moves: {name} must be a contiguous {dtype} "
                        f"tensor of shape {shape}, got {t.dtype} "
                        f"{tuple(t.shape)}")


def chain_moves(kind: str, emb: torch.Tensor, draws: tuple, g, tbl=None,
                parents: tuple = (), trail=None) -> torch.Tensor:
    """M moves of kind ``kind`` (see the module docstring) of every chain
    of the (C, k) int64 ``emb``, in place, from the (M, ...) ``draws``;
    with a (C, M, k) ``trail``, move s's state to ``trail[:, s]``. Returns
    ``emb``. On a CPU tensor: :func:`chain_moves_plain`."""
    if kind not in KINDS:
        raise ValueError(f"unknown move {kind!r}; one of {KINDS}")
    extra = tuple(t for t in (tbl, trail) if t is not None)
    if _on_cpu(emb, g.deg, *draws, *extra):
        return chain_moves_plain(kind, emb, draws, g, tbl, parents, trail)
    if emb.dim() != 2:
        raise ValueError(f"chain_moves needs (C, k) embeddings, got "
                         f"{tuple(emb.shape)}")
    C, k = emb.shape
    _check("emb", emb, torch.int64, (C, k))
    M = draws[0].shape[0] if draws and draws[0].dim() else 0
    if C == 0 or M == 0:
        return emb
    gargs = _graph_args(g)
    stage = int(chain_staged(g.num_nodes, _rep(g)))
    if trail is not None:
        _check("trail", trail, torch.int64, (C, M, k))
    sms = _sm_count(emb.device)
    lib = build()["lib"]
    if kind == "glauber":
        if k < 2 or tbl is None:
            raise ValueError("a Glauber move needs k > 1 and the motif's "
                             "neighbour table")
        j, u, fallback = draws
        for name, t, dtype in (("j", j, torch.int64), ("u", u, torch.float32),
                               ("fallback", fallback, torch.int64)):
            _check(name, t, dtype, (M, C))
        _check("tbl", tbl, torch.int64, (k, tbl.shape[1]))
        warps = chain_glauber_warps(C, _max_deg(g), sms)
        with torch.cuda.device(emb.device):
            err = lib.onmf_chain_glauber(
                emb.data_ptr(), C, k, M, j.data_ptr(), u.data_ptr(),
                fallback.data_ptr(), tbl.data_ptr(), tbl.shape[1],
                _ptr(trail), warps, stage, *gargs, _stream(emb))
    else:
        walk = kind in ("walk", "pivot")
        u_nb, u_acc, jump = draws[:3] if walk else (None, None, None)
        if walk:
            for name, t, dtype in (("u_neighbour", u_nb, torch.float32),
                                   ("u_accept", u_acc, torch.float32),
                                   ("jump", jump, torch.int64)):
                _check(name, t, dtype, (M, C))
        grow = 0 if kind == "walk" else len(parents)
        P = sum(p < 0 for p in parents) if grow else 0
        u_tree = roots = par = None
        if grow:
            if grow >= k:
                raise ValueError(f"{grow} parents for a {k}-node motif")
            u_tree, roots = draws[-2:]
            _check("u_tree", u_tree, torch.float32, (M, grow, C))
            _check("roots", roots, torch.int64, (M, P, C))
            par = _device_parents(tuple(parents), emb.device)
        with torch.cuda.device(emb.device):
            err = lib.onmf_chain_pivot(
                emb.data_ptr(), C, k, M, int(walk), grow, P,
                chain_pivot_chains(C, sms), _ptr(u_nb),
                _ptr(u_acc), _ptr(jump), _ptr(u_tree), _ptr(roots),
                _ptr(par), _ptr(trail), stage, *gargs, _stream(emb))
    _raise_on_error("chain_moves", err)
    LAUNCHES["chain_move"] += 1
    return emb

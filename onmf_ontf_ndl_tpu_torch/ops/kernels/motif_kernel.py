"""A hand-written CUDA kernel for the moves of the motif chains.

No Pallas kernel stands behind it: the JAX package runs its chains as one
jitted program (``onmf_ontf_ndl_tpu/samplers/motif.py:653-700``, a
``lax.scan`` over the moves, vmapped over the chains), and on this card the
kernel of ``csrc/motif_kernels.cu`` stands for that program's arithmetic.
Each call moves every chain once, in place on the (C, k) int64 embeddings
``emb``, from draws that the caller took from torch's generator in the
plain move's order (``samplers/motif.py``'s draw functions). Kinds:

- ``"glauber"`` (k > 1): draws ``(j, u, fallback)``; ``tbl`` the motif's
  (k, S) neighbour table. One warp a chain (``chain_glauber_kernel``).
- ``"walk"``: one Metropolis-Hastings step of ``emb[:, 0]``, draws
  ``(u_neighbour, u_accept, jump)`` (the move of a one-node motif).
- ``"pivot"``: the walk, then the tree regrown from the new root, draws
  the walk's three and ``(u_tree, roots)``: ``u_tree`` (k-1, C) float32,
  ``roots`` (P, C) int64, one row per parentless motif node in node order.
- ``"tree"``: the regrowth alone from ``emb[:, 0]`` as it stands, draws
  ``(u_tree, roots)`` (``tree_sample``).

The last three run ``chain_pivot_kernel``, one thread a chain. The kernel
computes what the plain move computes, float32 roundings included, so its
chains equal the plain moves' bit for bit. :func:`chain_move_plain` is the
plain version: the "apply" half of ``samplers/motif.py``'s moves.

:func:`chain_move_route` picks the kernel from the device and a backend
alone; ``samplers/motif.py`` calls it for every move. On a CUDA tensor
:func:`chain_move` launches the kernel on the current stream or raises (no
host read of a device value, no allocation, no sync: a CUDA graph can
capture it) and counts the launch in ``_lib.LAUNCHES["chain_move"]``; on a
CPU tensor it runs the plain version. The kernels also count their own
runs on the card (``_lib.device_runs``).
"""

from __future__ import annotations

import functools

import torch

from onmf_ontf_ndl_tpu_torch.data.graphs import BitsetGraph, CsrGraph
from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (
    LAUNCHES, _on_cpu, _raise_on_error, _stream, build)

__all__ = ["chain_move", "chain_move_plain", "chain_move_route", "KINDS"]

KINDS = ("glauber", "walk", "pivot", "tree")
_REP = {"dense": 0, "csr": 1, "bitset": 2}


def chain_move_route(device_type: str, backend: str = "auto") -> str:
    """How a move of chains on ``device_type`` runs: ``"kernel"``
    (:func:`chain_move`) for ``backend="auto"`` on a CUDA tensor,
    ``"plain"`` (:func:`chain_move_plain`) on the CPU or with
    ``backend="torch"`` (the comparisons of the tests and the chip
    scripts)."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown chain backend {backend!r}")
    return "kernel" if backend == "auto" and device_type == "cuda" else "plain"


def chain_move_plain(kind: str, emb: torch.Tensor, draws: tuple, g,
                     tbl=None, parents: tuple = ()) -> torch.Tensor:
    """Plain PyTorch :func:`chain_move`: the apply half of
    ``samplers/motif.py``'s moves, in place on ``emb``; returns it."""
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
    return emb


@functools.lru_cache(maxsize=16)
def _device_parents(parents: tuple, device: torch.device) -> torch.Tensor:
    """The motif's parent list as an int64 tensor on ``device``, copied
    there once per motif (a copy per move would wait for the device)."""
    return torch.tensor(parents, dtype=torch.int64, device=device)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _graph_args(g) -> tuple:
    """The graph arguments of the C entry points: representation, node
    count, then the pointers and widths of ``GraphView``."""
    if isinstance(g, (CsrGraph, BitsetGraph)):
        rep = "bitset" if isinstance(g, BitsetGraph) else "csr"
        tensors = {"nbr_flat": (g.nbr_flat, torch.int64),
                   "offsets": (g.offsets, torch.int64),
                   "deg": (g.deg, torch.int64)}
        if rep == "bitset":
            tensors["bits"] = (g.bits, torch.int32)
    else:
        rep = "dense"
        tensors = {"adj": (g.adj, torch.bool), "nbr": (g.nbr, torch.int64),
                   "deg": (g.deg, torch.int64)}
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"chain_move: the graph's {name} must be a "
                            f"contiguous {dtype} tensor")
    get = {name: t for name, (t, _) in tensors.items()}.get
    nbr, bits = get("nbr"), get("bits")
    return (_REP[rep], g.num_nodes, _ptr(get("adj")), _ptr(nbr),
            nbr.shape[1] if nbr is not None else 0, _ptr(get("nbr_flat")),
            _ptr(get("offsets")), g.deg.data_ptr(), _ptr(bits),
            bits.shape[1] if bits is not None else 0)


def _check(name: str, t: torch.Tensor, dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise TypeError(f"chain_move: {name} must be a contiguous {dtype} "
                        f"tensor of shape {shape}, got {t.dtype} "
                        f"{tuple(t.shape)}")


def chain_move(kind: str, emb: torch.Tensor, draws: tuple, g, tbl=None,
               parents: tuple = ()) -> torch.Tensor:
    """One move of kind ``kind`` (see the module docstring) of every chain
    of the (C, k) int64 ``emb``, in place, from ``draws``; returns
    ``emb``. On a CPU tensor: :func:`chain_move_plain`."""
    if kind not in KINDS:
        raise ValueError(f"unknown move {kind!r}; one of {KINDS}")
    if _on_cpu(emb, g.deg, *draws, *(() if tbl is None else (tbl,))):
        return chain_move_plain(kind, emb, draws, g, tbl, parents)
    if emb.dim() != 2:
        raise ValueError(f"chain_move needs (C, k) embeddings, got "
                         f"{tuple(emb.shape)}")
    C, k = emb.shape
    _check("emb", emb, torch.int64, (C, k))
    if C == 0:
        return emb
    gargs = _graph_args(g)
    lib = build()["lib"]
    if kind == "glauber":
        if k < 2 or tbl is None:
            raise ValueError("a Glauber move needs k > 1 and the motif's "
                             "neighbour table")
        j, u, fallback = draws
        for name, t, dtype in (("j", j, torch.int64), ("u", u, torch.float32),
                               ("fallback", fallback, torch.int64)):
            _check(name, t, dtype, (C,))
        _check("tbl", tbl, torch.int64, (k, tbl.shape[1]))
        with torch.cuda.device(emb.device):
            err = lib.onmf_chain_glauber(
                emb.data_ptr(), C, k, j.data_ptr(), u.data_ptr(),
                fallback.data_ptr(), tbl.data_ptr(), tbl.shape[1], *gargs,
                _stream(emb))
    else:
        walk = kind in ("walk", "pivot")
        u_nb, u_acc, jump = draws[:3] if walk else (None, None, None)
        if walk:
            for name, t, dtype in (("u_neighbour", u_nb, torch.float32),
                                   ("u_accept", u_acc, torch.float32),
                                   ("jump", jump, torch.int64)):
                _check(name, t, dtype, (C,))
        grow = 0 if kind == "walk" else len(parents)
        u_tree = roots = par = None
        if grow:
            if grow >= k:
                raise ValueError(f"{grow} parents for a {k}-node motif")
            u_tree, roots = draws[-2:]
            _check("u_tree", u_tree, torch.float32, (grow, C))
            _check("roots", roots, torch.int64,
                   (sum(p < 0 for p in parents), C))
            par = _device_parents(tuple(parents), emb.device)
        with torch.cuda.device(emb.device):
            err = lib.onmf_chain_pivot(
                emb.data_ptr(), C, k, int(walk), grow, _ptr(u_nb),
                _ptr(u_acc), _ptr(jump), _ptr(u_tree), _ptr(roots),
                _ptr(par), *gargs, _stream(emb))
    _raise_on_error("chain_move", err)
    LAUNCHES["chain_move"] += 1
    return emb

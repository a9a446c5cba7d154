"""Graphs for network dictionary learning, as PyTorch tensors.

Counterpart of ``onmf_ontf_ndl_tpu/data/graphs.py``, with the same three
representations, the same constructors and the same arrays:

- :class:`Graph`: dense (N, N) boolean ``adj``, optional (N, N) float32
  ``weight`` (WAN matrices), the padded (N, max_deg) neighbour table
  ``nbr`` and the degrees ``deg``;
- :class:`CsrGraph`: the O(E) form, ``nbr_flat`` (2E,) with each row's
  neighbours ascending, ``offsets`` and ``deg``;
- :class:`BitsetGraph`: the CSR arrays plus the (N, ceil(N/32)) packed
  adjacency rows ``bits``.

Node indices are assigned by first appearance in the edge list (the
networkx order the reference relies on) and ``node_ids`` maps them back
to the original labels. CSR rows stay ascending: the samplers' draws
depend on that order, which is also the order of the dense rows and the
packed bits, so all three representations give the same draws.

Index arrays are int64 (torch indexes with int64; pair keys ``i * n + j``
never wrap). ``bits`` holds the JAX package's uint32 words as int32
(torch has no uint32 arithmetic); the bit patterns are the same. Every
constructor and loader takes ``device=`` and defaults to ``"cuda"``
(raising where there is no CUDA device; a CPU run passes
``device="cpu"``); the host arrays of the CSR constructors are kept for
:func:`host_csr`.

Left out, because they exist for the TPU: the padded ``nbr_pad_T`` table
(``graphs.py:266,317``) and its byte gates, the on-device bitset and table
builds with their size thresholds, and the built-CSR npz cache and its
key. Edge interning runs the numpy path (the JAX package's pandas path
gives the same arrays).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from onmf_ontf_ndl_tpu_torch.models.state import entry_device

__all__ = ["Graph", "BitsetGraph", "CsrGraph", "graph_from_edgelist",
           "graph_from_adjacency", "load_edgelist", "load_edgelist_dense",
           "load_edgelist_csr", "bitset_graph_from_edges",
           "load_edgelist_bitset", "csr_graph_from_edges", "host_csr"]


def _moved(g, device):
    """``g`` with every tensor field on ``device``."""
    return dataclasses.replace(g, **{
        f.name: getattr(g, f.name).to(device)
        for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), torch.Tensor)})


@dataclasses.dataclass(frozen=True, eq=False)
class Graph:
    adj: torch.Tensor            # (N, N) bool
    weight: torch.Tensor | None  # (N, N) float32, None for binary graphs
    nbr: torch.Tensor            # (N, max(max_deg, 1)) int64, padded with 0
    deg: torch.Tensor            # (N,) int64
    node_ids: tuple = ()         # original label of each index

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def num_edges(self) -> int:
        return int(self.deg.sum()) // 2

    @property
    def device(self) -> torch.device:
        return self.adj.device

    def to(self, device) -> "Graph":
        return _moved(self, device)


@dataclasses.dataclass(frozen=True, eq=False)
class CsrGraph:
    """Pure CSR: O(E) memory. Adjacency queries search a node's ascending
    row (``samplers/motif.py``). Binary graphs only."""

    nbr_flat: torch.Tensor       # (2E,) int64, ascending within each row
    offsets: torch.Tensor        # (N,) int64 row starts
    deg: torch.Tensor            # (N,) int64
    node_ids: tuple = ()
    max_deg: int = 0
    # host copies (offsets, nbr_flat) from the constructor, for host_csr
    host: tuple | None = dataclasses.field(default=None, repr=False)

    weight = None                # no weights for the CSR representation

    @property
    def num_nodes(self) -> int:
        return self.offsets.shape[0]

    @property
    def num_edges(self) -> int:
        return self.nbr_flat.shape[0] // 2

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def to(self, device) -> "CsrGraph":
        return _moved(self, device)


@dataclasses.dataclass(frozen=True, eq=False)
class BitsetGraph:
    """Bit-packed adjacency rows (N^2 / 8 bytes) beside the CSR arrays:
    an adjacency query is one bit test. Binary graphs only."""

    bits: torch.Tensor           # (N, ceil(N/32)) int32: the uint32 words
    nbr_flat: torch.Tensor       # (2E,) int64, ascending within each row
    offsets: torch.Tensor        # (N,) int64 row starts
    deg: torch.Tensor            # (N,) int64
    node_ids: tuple = ()
    max_deg: int = 0
    host: tuple | None = dataclasses.field(default=None, repr=False)

    weight = None

    @property
    def num_nodes(self) -> int:
        return self.bits.shape[0]

    @property
    def words_per_row(self) -> int:
        return self.bits.shape[1]

    @property
    def num_edges(self) -> int:
        return int(self.deg.sum()) // 2

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def to(self, device) -> "BitsetGraph":
        return _moved(self, device)


def host_csr(g):
    """``(offsets, nbr_flat)`` host copies of a graph built by
    :func:`csr_graph_from_edges` or :func:`bitset_graph_from_edges`, or
    None (a dense :class:`Graph`, or a graph assembled by hand)."""
    return getattr(g, "host", None)


def _build(adj_np: np.ndarray, weight_np, node_ids, device) -> Graph:
    n = adj_np.shape[0]
    deg = adj_np.sum(axis=1).astype(np.int64)
    rows, cols = np.nonzero(adj_np)        # row-major: each row ascending
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])[:n]
    nbr = np.zeros((n, max(int(deg.max()) if n else 0, 1)), np.int64)
    nbr[rows, np.arange(len(rows)) - starts[rows]] = cols
    return Graph(
        adj=torch.as_tensor(adj_np, dtype=torch.bool, device=device),
        weight=(None if weight_np is None else torch.as_tensor(
            weight_np, dtype=torch.float32, device=device)),
        nbr=torch.as_tensor(nbr, device=device),
        deg=torch.as_tensor(deg, device=device),
        node_ids=tuple(int(v) for v in np.asarray(node_ids)),
    )


def graph_from_edgelist(edges, num_nodes: int | None = None, *,
                        device="cuda") -> Graph:
    """A simple undirected :class:`Graph` from an (E, 2) edge array.

    Labels may be arbitrary ints; indices go by first appearance.
    ``num_nodes`` may only pad with isolated nodes (labelled by their
    index); fewer nodes than distinct labels is an error."""
    device = entry_device(device)
    e, node_ids = _intern_edges(edges)
    n = len(node_ids) if num_nodes is None else int(num_nodes)
    if n < len(node_ids):
        raise ValueError(f"num_nodes={n} < {len(node_ids)} distinct labels")
    if n > len(node_ids):
        node_ids = np.concatenate(
            [node_ids, np.arange(len(node_ids), n, dtype=np.int64)])
    adj = np.zeros((n, n), bool)
    adj[e[:, 0], e[:, 1]] = True
    adj[e[:, 1], e[:, 0]] = True
    return _build(adj, None, node_ids, device)


def graph_from_adjacency(A, *, normalize: bool = False,
                         device="cuda") -> Graph:
    """A :class:`Graph` from a (weighted) adjacency matrix.

    ``normalize=True`` divides by the maximum (the WAN convention). The
    structure is ``A > 0`` symmetrized; the weight of pair (i, j) is
    ``A[i, j]`` when that direction is present, else ``A[j, i]``."""
    device = entry_device(device)
    A = np.array(A, np.float64)
    if normalize and A.max() > 0:
        A = A / A.max()
    np.fill_diagonal(A, 0.0)
    adj = A > 0
    adj = adj | adj.T
    W = np.where(A > 0, A, A.T)
    return _build(adj, W.astype(np.float32), np.arange(A.shape[0]), device)


def load_edgelist(path: str, delimiter: str = ",", use_native: str = "auto",
                  *, device="cuda") -> Graph:
    """A :class:`Graph` from an integer edge-list file. ``use_native``:
    ``"auto"`` parses with the C++ loader (``native/graph_loader.cpp``)
    when it builds here and with numpy otherwise, ``"always"`` raises
    without it, ``"never"`` takes numpy; both give the same graph."""
    device = entry_device(device)
    if use_native in ("auto", "always"):
        from onmf_ontf_ndl_tpu_torch.data.native import load_edgelist_native

        try:
            adj, nbr, deg, node_ids = load_edgelist_native(path)
        except RuntimeError:
            if use_native == "always":
                raise
        else:
            return Graph(
                adj=torch.as_tensor(adj, device=device), weight=None,
                nbr=torch.as_tensor(nbr.astype(np.int64), device=device),
                deg=torch.as_tensor(deg.astype(np.int64), device=device),
                node_ids=tuple(int(v) for v in node_ids))
    return graph_from_edgelist(_parse_edge_file(path, delimiter),
                               device=device)


def _parse_edge_file(path: str, delimiter: str = ",") -> np.ndarray:
    """Integer (E, 2) edge table from a file: ``delimiter`` first, then
    whitespace (SNAP-style files); ``#`` starts a comment."""
    def attempt(delim):
        try:
            e = np.genfromtxt(path, delimiter=delim, dtype=np.float64,
                              comments="#")
        except (OSError, ValueError):
            return None
        if e.ndim == 1:
            if e.size % 2:
                return None
            e = e.reshape(-1, 2)
        if e.ndim != 2 or (e.size and e.shape[1] != 2):
            return None
        if e.size and (np.isnan(e).any() or (e != np.round(e)).any()):
            return None
        return e.astype(np.int64)

    edges = attempt(delimiter)
    if edges is None:
        edges = attempt(None)
    if edges is None:
        raise ValueError(f"could not parse edge list {path!r}")
    return edges


def load_edgelist_csr(path: str, delimiter: str = ",",
                      use_native: str = "auto", *, device="cuda") -> CsrGraph:
    """Edge-list file -> :class:`CsrGraph`."""
    device = entry_device(device)
    return csr_graph_from_edges(_parse_edge_file(path, delimiter),
                                use_native=use_native, device=device)


def load_edgelist_dense(path: str, delimiter: str = ",") -> np.ndarray:
    """Edge-list file -> dense (N, N) 0/1 float64 adjacency (the
    reference's ``read_networks``), nodes in first-appearance order,
    self-loops dropped."""
    e, node_ids = _intern_edges(_parse_edge_file(path, delimiter))
    n = len(node_ids)
    a = np.zeros((n, n), np.float64)
    a[e[:, 0], e[:, 1]] = 1.0
    a[e[:, 1], e[:, 0]] = 1.0
    return a


def load_edgelist_bitset(path: str, delimiter: str = ",", *,
                         device="cuda") -> BitsetGraph:
    """Edge-list file -> :class:`BitsetGraph`."""
    device = entry_device(device)
    edges = np.genfromtxt(path, delimiter=delimiter, dtype=np.int64)
    return bitset_graph_from_edges(edges, device=device)


def _normalize_edges(edges) -> np.ndarray:
    """(E, 2) int64 node pairs; a flat array of even length is paired."""
    edges = np.asarray(edges, dtype=np.int64)
    if edges.ndim == 1:
        if edges.size % 2:
            raise ValueError("flat edge array must have even length")
        edges = edges.reshape(-1, 2)
    if edges.ndim != 2 or (edges.size and edges.shape[1] != 2):
        raise ValueError(
            f"edge list must be (E, 2) node pairs, got shape {edges.shape} "
            f"(pass the first two columns of a weighted edge file)")
    return edges


def _intern_edges(edges):
    """First-appearance node interning over the interleaved label stream
    ``[a0, b0, a1, b1, ...]``; returns the deduplicated, self-loop-free
    (E, 2) index pairs sorted by (lo, hi), and the labels."""
    flat = _normalize_edges(edges).reshape(-1)
    uniq, first_idx = np.unique(flat, return_index=True)
    appearance = np.argsort(first_idx, kind="stable")
    node_ids = uniq[appearance]
    index_of_sorted = np.empty(len(uniq), np.int64)
    index_of_sorted[appearance] = np.arange(len(uniq))
    e = index_of_sorted[np.searchsorted(uniq, flat)].reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    n = np.int64(len(node_ids))
    key = np.unique(np.minimum(e[:, 0], e[:, 1]) * n
                    + np.maximum(e[:, 0], e[:, 1]))
    e = np.stack([key // n, key % n], axis=1) if len(node_ids) else e[:0]
    return e, node_ids


def _csr_arrays(e, n):
    """CSR from deduplicated (E, 2) undirected pairs: both directions,
    sorted by (src, dst) so each row lists its neighbours ascending.
    Returns ``(src, dst, deg, offsets)``."""
    nn = np.int64(max(n, 1))
    key = np.concatenate([e[:, 0] * nn + e[:, 1], e[:, 1] * nn + e[:, 0]])
    key.sort()
    src, dst = key // nn, key % nn
    deg = np.bincount(src, minlength=n).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(deg)[:-1]])[:n].astype(np.int64)
    return src, dst, deg, offsets


def _host_csr_build(edges, use_native: str = "auto"):
    """Intern, dedup and build the row-ascending CSR on the host, with
    the C++ loader (``"auto"``: when it builds here) or numpy. Returns
    int64 ``(dst, offsets, deg, node_ids, max_deg)``."""
    edges = _normalize_edges(edges)
    if use_native in ("auto", "always"):
        from onmf_ontf_ndl_tpu_torch.data.native import csr_from_edges_native

        try:
            dst, offsets, deg, node_ids, max_deg = \
                csr_from_edges_native(edges)
        except RuntimeError:
            if use_native == "always":
                raise
        else:
            return (dst.astype(np.int64), offsets.astype(np.int64),
                    deg.astype(np.int64), node_ids, max_deg)
    e, node_ids = _intern_edges(edges)
    n = len(node_ids)
    _, dst, deg, offsets = _csr_arrays(e, n)
    return dst, offsets, deg, np.asarray(node_ids), \
        (int(deg.max()) if n else 0)


def csr_graph_from_edges(edges, *, use_native: str = "auto",
                         device="cuda") -> CsrGraph:
    """A :class:`CsrGraph` from an (E, 2) edge array: O(E) host work and
    device memory. ``use_native`` as in :func:`load_edgelist`."""
    device = entry_device(device)
    dst, offsets, deg, node_ids, max_deg = _host_csr_build(edges, use_native)
    return CsrGraph(
        nbr_flat=torch.as_tensor(dst, device=device),
        offsets=torch.as_tensor(offsets, device=device),
        deg=torch.as_tensor(deg, device=device),
        node_ids=tuple(int(v) for v in node_ids), max_deg=int(max_deg),
        host=(offsets, dst))


def bitset_graph_from_edges(edges, *, use_native: str = "auto",
                            device="cuda") -> BitsetGraph:
    """A :class:`BitsetGraph` from an (E, 2) edge array, never forming the
    dense adjacency; the packed rows are built on the host."""
    device = entry_device(device)
    dst, offsets, deg, node_ids, max_deg = _host_csr_build(edges, use_native)
    n = len(node_ids)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    bits = np.zeros((n, (n + 31) // 32), np.uint32)
    np.bitwise_or.at(bits, (src, dst // 32),
                     np.uint32(1) << (dst % 32).astype(np.uint32))
    return BitsetGraph(
        bits=torch.as_tensor(bits.view(np.int32), device=device),
        nbr_flat=torch.as_tensor(dst, device=device),
        offsets=torch.as_tensor(offsets, device=device),
        deg=torch.as_tensor(deg, device=device),
        node_ids=tuple(int(v) for v in node_ids), max_deg=int(max_deg),
        host=(offsets, dst))

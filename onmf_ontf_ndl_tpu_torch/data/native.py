"""ctypes bindings and on-demand build of the native C++ graph loader.

Counterpart of ``onmf_ontf_ndl_tpu/data/native.py`` for the port, which
cannot import that module (importing ``onmf_ontf_ndl_tpu.data`` imports the
JAX package). The shared library is compiled from the repository's
``native/graph_loader.cpp`` with the system's ``g++`` on first use and kept
beside the source under the same source-hash name, so both packages load
the same file. Host code: without a compiler the graph constructors' ``"auto"``
mode parses and builds with numpy instead.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["native_available", "load_edgelist_native",
           "csr_from_edges_native"]

_SRC = Path(__file__).resolve().parents[2] / "native" / "graph_loader.cpp"


def _build_lib() -> str:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _SRC.parent / f"libgraph_loader.{digest}.so"
    if not out.exists():
        # build under a temporary name and rename: a concurrent process
        # never opens a half-written library
        tmp = f"{out}.tmp.{os.getpid()}"
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        str(_SRC), "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    return str(out)


@functools.cache
def _get_lib():
    """The bound library, or None when it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(_build_lib())
    except (OSError, subprocess.CalledProcessError):
        return None
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64

    def arrays(*dtypes):
        return [np.ctypeslib.ndpointer(dtype=dt, flags="C_CONTIGUOUS")
                for dt in dtypes]

    for name, res, args in (
            ("gl_load", vp, [ctypes.c_char_p]),
            ("gl_error", ctypes.c_char_p, [vp]),
            ("gl_num_nodes", i32, [vp]),
            ("gl_num_edges", i64, [vp]),
            ("gl_max_deg", i32, [vp]),
            ("gl_fill", None,
             [vp] + arrays(np.uint8, np.int32, np.int32, np.int64)),
            ("gl_free", None, [vp]),
            ("gl_csr_from_edges", vp, arrays(np.int64) + [i64]),
            ("gl_csr_error", ctypes.c_char_p, [vp]),
            ("gl_csr_num_nodes", i64, [vp]),
            ("gl_csr_nnz", i64, [vp]),
            ("gl_csr_max_deg", i32, [vp]),
            ("gl_csr_fill", None,
             [vp] + arrays(np.int32, np.int32, np.int32, np.int64)),
            ("gl_csr_free", None, [vp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def native_available() -> bool:
    return _get_lib() is not None


def _lib():
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native graph loader unavailable")
    return lib


def load_edgelist_native(path: str):
    """Parse an edge-list file with the C++ loader. Returns
    ``(adj_bool, nbr, deg, node_ids)`` numpy arrays; raises
    ``RuntimeError`` when the loader is unavailable or the parse fails."""
    lib = _lib()
    h = lib.gl_load(str(path).encode())
    try:
        err = lib.gl_error(h)
        if err:
            raise RuntimeError(f"graph_loader: {err.decode()}")
        n = lib.gl_num_nodes(h)
        adj = np.zeros((n, n), np.uint8)
        nbr = np.zeros((n, lib.gl_max_deg(h)), np.int32)
        deg = np.zeros((n,), np.int32)
        node_ids = np.zeros((n,), np.int64)
        lib.gl_fill(h, adj, nbr, deg, node_ids)
        return adj.astype(bool), nbr, deg, node_ids
    finally:
        lib.gl_free(h)


def csr_from_edges_native(edges: np.ndarray):
    """Intern, dedup and build the row-ascending CSR of an (E, 2) int64
    edge array with the C++ loader (``gl_csr_from_edges``): the same
    arrays as the numpy path of ``data/graphs.py``. Returns
    ``(nbr_flat, offsets, deg, node_ids, max_deg)``; raises
    ``RuntimeError`` when the library is unavailable."""
    lib = _lib()
    edges = np.ascontiguousarray(edges, np.int64)
    if edges.ndim != 2 or (edges.size and edges.shape[1] != 2):
        raise ValueError(f"edge list must be (E, 2), got {edges.shape}")
    h = lib.gl_csr_from_edges(edges.reshape(-1), edges.shape[0])
    try:
        err = lib.gl_csr_error(h)
        if err:
            raise RuntimeError(f"graph_loader csr: {err.decode()}")
        n = lib.gl_csr_num_nodes(h)
        nbr_flat = np.zeros((lib.gl_csr_nnz(h),), np.int32)
        offsets = np.zeros((n,), np.int32)
        deg = np.zeros((n,), np.int32)
        node_ids = np.zeros((n,), np.int64)
        lib.gl_csr_fill(h, nbr_flat, offsets, deg, node_ids)
        return nbr_flat, offsets, deg, node_ids, int(lib.gl_csr_max_deg(h))
    finally:
        lib.gl_csr_free(h)

"""The port's graphs (data/graphs.py, data/native.py) against the JAX
package's, field by field and exactly, with and without the native C++
loader. The file loaders read files written under ``tmp_path``."""

import os
import sys

import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu.data import graphs as jg
from onmf_ontf_ndl_tpu.data import native as jnative
from onmf_ontf_ndl_tpu_torch.data import graphs as tg
from onmf_ontf_ndl_tpu_torch.data import native as tnative

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))
from scale_extras import ba_edges, torus_edges  # noqa: E402

torch.set_num_threads(1)

NATIVE = ["never", "always"]

# duplicates (both orientations), self-loops, large and negative labels,
# labels given as numeric strings, and a node seen only in a self-loop
EDGE_LISTS = {
    "messy": [[7, 3], [3, 9], [9, 7], [3, 7], [7, 7], [9, 3], [12, 7],
              [-4, 9], [10**12, 3], [5, 5]],
    "strings": [["30", "10"], ["10", "20"], ["20", "30"], ["20", "10"]],
    "random": np.random.default_rng(3).integers(0, 60, (300, 2)),
    "torus": torus_edges(7),
}


def _np(x):
    return np.asarray(x)


def assert_csr_equal(t, j):
    np.testing.assert_array_equal(t.nbr_flat.numpy(), _np(j.nbr_flat))
    np.testing.assert_array_equal(t.offsets.numpy(), _np(j.offsets))
    np.testing.assert_array_equal(t.deg.numpy(), _np(j.deg))
    assert t.max_deg == j.max_deg
    assert t.node_ids == j.node_ids
    assert t.num_nodes == j.num_nodes and t.num_edges == j.num_edges


def assert_dense_equal(t, j):
    np.testing.assert_array_equal(t.adj.numpy(), _np(j.adj))
    np.testing.assert_array_equal(t.nbr.numpy(), _np(j.nbr))
    np.testing.assert_array_equal(t.deg.numpy(), _np(j.deg))
    assert t.node_ids == j.node_ids
    if j.weight is None:
        assert t.weight is None
    else:
        np.testing.assert_array_equal(t.weight.numpy(), _np(j.weight))
    assert t.num_nodes == j.num_nodes and t.num_edges == j.num_edges


@pytest.mark.parametrize("name", sorted(EDGE_LISTS))
@pytest.mark.parametrize("use_native", NATIVE)
def test_csr_and_bitset_graphs_equal_jax(name, use_native):
    edges = EDGE_LISTS[name]
    t = tg.csr_graph_from_edges(edges, use_native=use_native, device="cpu")
    assert_csr_equal(t, jg.csr_graph_from_edges(edges, use_native=use_native))
    tb = tg.bitset_graph_from_edges(edges, use_native=use_native, device="cpu")
    jb = jg.bitset_graph_from_edges(edges, use_native=use_native)
    assert_csr_equal(tb, jb)
    np.testing.assert_array_equal(tb.bits.numpy().view(np.uint32),
                                  _np(jb.bits))
    assert tb.words_per_row == jb.words_per_row
    # the host copies the constructors keep
    offsets, dst = tg.host_csr(t)
    np.testing.assert_array_equal(offsets, _np(jg.host_csr(
        jg.csr_graph_from_edges(edges))[0]))
    np.testing.assert_array_equal(dst, t.nbr_flat.numpy())


@pytest.mark.parametrize("name", sorted(EDGE_LISTS))
def test_dense_graph_equals_jax(name):
    edges = EDGE_LISTS[name]
    assert_dense_equal(tg.graph_from_edgelist(edges, device="cpu"),
                       jg.graph_from_edgelist(edges))
    n = len(jg.graph_from_edgelist(edges).node_ids)
    # padding with isolated nodes
    assert_dense_equal(tg.graph_from_edgelist(edges, num_nodes=n + 3,
                                              device="cpu"),
                       jg.graph_from_edgelist(edges, num_nodes=n + 3))
    with pytest.raises(ValueError, match="distinct labels"):
        tg.graph_from_edgelist(edges, num_nodes=n - 1, device="cpu")
    assert tg.host_csr(tg.graph_from_edgelist(edges, device="cpu")) is None


@pytest.mark.parametrize("normalize", [False, True])
def test_graph_from_adjacency_wan_semantics(normalize):
    rng = np.random.default_rng(5)
    A = rng.random((30, 30)) * (rng.random((30, 30)) < 0.2) * 7.0
    A[3, 3] = 2.0                      # diagonal dropped
    A[4, 5], A[5, 4] = 0.5, 0.0        # one direction only: backfilled
    A[6, 7], A[7, 6] = 0.25, 0.75      # each orientation keeps its own
    A_before = A.copy()
    t = tg.graph_from_adjacency(A, normalize=normalize, device="cpu")
    assert_dense_equal(t, jg.graph_from_adjacency(A, normalize=normalize))
    np.testing.assert_array_equal(A, A_before)   # the caller's matrix


def test_graph_moves_between_devices_and_keeps_fields():
    g = tg.csr_graph_from_edges(EDGE_LISTS["torus"], device="cpu")
    h = g.to("cpu")
    assert h.max_deg == g.max_deg and h.node_ids == g.node_ids
    assert tg.host_csr(h) is tg.host_csr(g)
    assert torch.equal(h.nbr_flat, g.nbr_flat)


def _write(path, text):
    path.write_text(text)
    return str(path)


FILES = {
    "comma": "7,3\n3,9\n9,7\n3,7\n12,7\n",
    "space": "# SNAP-style header\n1 2\n2 3\n3 1\n3 4\n4 4\n",
    "tab": "10\t20\n20\t30\n",
}


@pytest.mark.parametrize("kind", sorted(FILES))
@pytest.mark.parametrize("use_native", ["auto", "never"])
def test_file_loaders_equal_jax(tmp_path, kind, use_native):
    delim = {"comma": ",", "space": " ", "tab": "\t"}[kind]
    path = _write(tmp_path / f"{kind}.txt", FILES[kind])
    assert_dense_equal(tg.load_edgelist(path, use_native=use_native,
                                        device="cpu"),
                       jg.load_edgelist(path, use_native=use_native))
    assert_csr_equal(tg.load_edgelist_csr(path, use_native=use_native,
                                          device="cpu"),
                     jg.load_edgelist_csr(path, use_native=use_native))
    np.testing.assert_array_equal(tg.load_edgelist_dense(path),
                                  jg.load_edgelist_dense(path))
    tb = tg.load_edgelist_bitset(path, delimiter=delim, device="cpu")
    jb = jg.load_edgelist_bitset(path, delimiter=delim)
    assert_csr_equal(tb, jb)
    np.testing.assert_array_equal(tb.bits.numpy().view(np.uint32),
                                  _np(jb.bits))


def test_parse_rejects_what_jax_rejects(tmp_path):
    bad = _write(tmp_path / "bad.txt", "1,2,3\n4,5,6\n")
    floats = _write(tmp_path / "floats.txt", "1.5,2\n3,4\n")
    for path in (bad, floats):
        with pytest.raises(ValueError, match="could not parse"):
            jg._parse_edge_file(path)
        with pytest.raises(ValueError, match="could not parse"):
            tg._parse_edge_file(path)
    with pytest.raises(ValueError, match="pairs"):
        tg.csr_graph_from_edges(np.zeros((3, 3), np.int64), device="cpu")
    with pytest.raises(ValueError, match="even length"):
        tg.csr_graph_from_edges([1, 2, 3], device="cpu")


def test_native_binding_matches_jax_binding(tmp_path):
    if not jnative.native_available():
        pytest.skip("no C++ toolchain for the native loader")
    assert tnative.native_available()
    edges = ba_edges(500, 3, seed=2)
    got = tnative.csr_from_edges_native(edges)
    want = jnative.csr_from_edges_native(edges)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]
    path = _write(tmp_path / "g.txt", FILES["comma"])
    for a, b in zip(tnative.load_edgelist_native(path),
                    jnative.load_edgelist_native(path)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError):
        tnative.load_edgelist_native(str(tmp_path / "missing.txt"))


def test_skewed_graph_equal_jax_at_scale():
    # a Barabasi-Albert graph with hub rows (max_deg > 256)
    edges = ba_edges(3000, 8, seed=1)
    t = tg.csr_graph_from_edges(edges, device="cpu")
    assert t.max_deg > 256
    assert_csr_equal(t, jg.csr_graph_from_edges(edges))

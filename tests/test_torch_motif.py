"""The port's motif samplers (samplers/motif.py) against the JAX package.

Patches are deterministic and must equal JAX's exactly on every
representation. The chains draw from torch generators, which cannot
replay JAX's threefry stream, so they are held to their laws, as
tests/test_motif.py holds the JAX chains: every emitted embedding is a
homomorphism, the Glauber one-step law is the exact uniform law over common
neighbours (TV < 0.02 over 60,000 chains; < 0.03 for the 5-node motif),
the walk keeps the uniform law (max deviation 0.01 over 40,000 chains), an
edgeless motif embeds uniformly (0.02 over 8,000). The three
representations consume the same uniforms in the same order and their
rows ascend alike, so from one seed they draw the same chains exactly.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from onmf_ontf_ndl_tpu.data import graphs as jg
from onmf_ontf_ndl_tpu.samplers import motif as jm
from onmf_ontf_ndl_tpu_torch.data import graphs as tg
from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))
from scale_extras import ba_edges, torus_edges  # noqa: E402

torch.set_num_threads(1)

GLAUBER_EDGES = [[0, 1], [1, 2], [2, 0], [2, 3], [3, 4], [4, 0], [1, 3]]


def gen(seed):
    return torch.Generator().manual_seed(seed)


def three(edges):
    """The port's dense, CSR and bitset graphs of one edge list."""
    return {"dense": tg.graph_from_edgelist(edges, device="cpu"),
            "csr": tg.csr_graph_from_edges(edges, device="cpu"),
            "bitset": tg.bitset_graph_from_edges(edges, device="cpu")}


def jax_three(edges):
    return {"dense": jg.graph_from_edgelist(edges),
            "csr": jg.csr_graph_from_edges(edges),
            "bitset": jg.bitset_graph_from_edges(edges)}


def is_homomorphism(adj, B, embs):
    q, r = np.nonzero(np.asarray(B))
    return bool(adj[embs[:, q], embs[:, r]].all())


@pytest.mark.parametrize("k1,k2", [(0, 0), (0, 2), (1, 2), (0, 20), (3, 4)])
def test_motif_tables_equal_jax(k1, k2):
    B = tm.path_adj(k1, k2)
    np.testing.assert_array_equal(B, jm.path_adj(k1, k2))
    assert tm.tree_parents(B) == jm.tree_parents(B)
    np.testing.assert_array_equal(tm._motif_neighbor_table(B),
                                  jm._motif_neighbor_table(B))
    assert tm.tree_parents(np.zeros((3, 3), int)) == (-1, -1)


def _embeddings(n, k, M, seed):
    return np.random.default_rng(seed).integers(0, n, (M, k))


GRAPHS = {
    "torus": torus_edges(9),
    "random": np.random.default_rng(4).integers(0, 50, (260, 2)),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("rep", ["dense", "csr", "bitset"])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_pair_matrices_equal_jax(name, rep, k):
    tgr, jgr = three(GRAPHS[name])[rep], jax_three(GRAPHS[name])[rep]
    embs = _embeddings(tgr.num_nodes, k, 300, seed=k)
    got = tm.pair_matrices_T(tgr, torch.as_tensor(embs))
    want = jm.pair_matrices_T(jgr, jnp.asarray(embs, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32
    e = embs[7]
    np.testing.assert_array_equal(
        tm.patch_from_embedding(tgr, torch.as_tensor(e)).numpy(),
        np.asarray(jm.patch_from_embedding(jgr, jnp.asarray(e, jnp.int32))))


def test_weighted_patches_equal_jax():
    rng = np.random.default_rng(8)
    A = rng.random((25, 25)) * (rng.random((25, 25)) < 0.3)
    A[2, 3], A[3, 2] = 0.4, 0.9          # orientation-dependent weights
    tgr = tg.graph_from_adjacency(A, normalize=True, device="cpu")
    jgr = jg.graph_from_adjacency(A, normalize=True)
    embs = _embeddings(25, 4, 200, seed=1)
    embs[0, :2] = [2, 3]
    got = tm.pair_matrices_T(tgr, torch.as_tensor(embs), weighted=True)
    want = jm.pair_matrices_T(jgr, jnp.asarray(embs, jnp.int32),
                              weighted=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tm.patch_from_embedding(tgr, torch.as_tensor(embs[0]),
                                weighted=True).numpy(),
        np.asarray(jm.patch_from_embedding(
            jgr, jnp.asarray(embs[0], jnp.int32), weighted=True)))
    with pytest.raises(ValueError, match="weighted"):
        tm.pair_matrices_T(
            tg.csr_graph_from_edges(GRAPHS["torus"], device="cpu"),
            torch.as_tensor(embs), weighted=True)


def test_pair_matrices_skewed_graph_k21_equal_jax():
    # hub rows past the JAX binary-search threshold (max_deg > 256), the
    # reference's 21-node motif; embeddings from the port's own chains
    edges = ba_edges(3000, 8, seed=1)
    tcsr = tg.csr_graph_from_edges(edges, device="cpu")
    jcsr = jg.csr_graph_from_edges(edges)
    assert tcsr.max_deg > 256
    B = tm.path_adj(0, 20)
    x0 = torch.randint(0, tcsr.num_nodes, (8,), generator=gen(0))
    emb0 = tm.tree_sample(gen(1), tm.tree_parents(B), tcsr, x0)
    embs = tm.run_chains(gen(2), tcsr, emb0, B, 12).reshape(-1, 21)
    embs = torch.cat([embs, torch.as_tensor(_embeddings(3000, 21, 64, 3))])
    want = np.asarray(jm.pair_matrices_T(jcsr, jnp.asarray(embs.numpy(),
                                                           jnp.int32)))
    for rep in (tcsr, tg.bitset_graph_from_edges(edges, device="cpu"),
                tg.graph_from_edgelist(edges, device="cpu")):
        np.testing.assert_array_equal(tm.pair_matrices_T(rep, embs).numpy(),
                                      want)
    # the chain's own patches are homomorphisms of the path: ones on the
    # motif's edges
    adj = tg.graph_from_edgelist(edges, device="cpu").adj.numpy()
    assert is_homomorphism(adj, B, embs[:96].numpy())


@pytest.mark.parametrize("use_glauber", [True, False])
def test_chains_emit_homomorphisms_and_agree_across_representations(
        use_glauber):
    graphs = three(torus_edges(6))
    adj = graphs["dense"].adj.numpy()
    B = tm.path_adj(1, 2)
    parents = tm.tree_parents(B)
    out = {}
    for rep, g in graphs.items():
        x0 = torch.randint(0, g.num_nodes, (16,), generator=gen(5))
        emb0 = tm.tree_sample(gen(6), parents, g, x0)
        assert is_homomorphism(adj, B, emb0.numpy())
        trail = tm.run_chains(gen(7), g, emb0, B, 50,
                              use_glauber=use_glauber)
        assert is_homomorphism(adj, B, trail.reshape(-1, 4).numpy())
        X, embs = tm.sample_patches_ensemble(gen(7), g, emb0, B, 50,
                                             use_glauber=use_glauber)
        assert torch.equal(embs, trail[:, -1])
        assert torch.equal(X, tm.pair_matrices_T(g, trail.reshape(-1, 4)))
        out[rep] = trail
    assert torch.equal(out["dense"], out["csr"])
    assert torch.equal(out["dense"], out["bitset"])


def test_sample_patches_one_chain_layout():
    g = tg.graph_from_edgelist(torus_edges(5), device="cpu")
    B = tm.path_adj(0, 2)
    emb0 = tm.tree_sample(gen(0), tm.tree_parents(B), g,
                          torch.tensor([3]))[0]
    X, emb = tm.sample_patches(gen(1), g, emb0, B, 20)
    assert X.shape == (9, 20) and emb.shape == (3,)
    trail = tm.run_chains(gen(1), g, emb0[None], B, 20)[0]
    assert torch.equal(emb, trail[-1])
    np.testing.assert_array_equal(
        X[:, 4].numpy().reshape(3, 3),
        tm.patch_from_embedding(g, trail[4]).numpy())


def test_rw_update_preserves_uniform():
    # non-regular graph: one MH step from uniform stays uniform
    edges = [[0, 1], [1, 2], [2, 0], [2, 3], [3, 4], [4, 2], [0, 4]]
    for g in three(edges).values():
        n, reps = g.num_nodes, 40000
        ys = tm.rw_update(gen(0), g, torch.arange(reps) % n)
        counts = np.bincount(ys.numpy(), minlength=n) / reps
        assert np.abs(counts - 1.0 / n).max() < 0.01


def _glauber_tv(g, adj, B, emb0, reps, seed):
    n, k = adj.shape[0], B.shape[0]
    Bsym = (B + B.T) > 0
    want = {}
    for j in range(k):
        mask = np.ones(n, bool)
        for r in range(k):
            if Bsym[r, j]:
                mask &= adj[emb0[r]]
        support = np.flatnonzero(mask) if mask.any() else np.arange(n)
        for y in support:
            e = emb0.copy()
            e[j] = y
            want[tuple(e)] = want.get(tuple(e), 0.0) + 1.0 / (k * len(support))
    outs = tm.glauber_update(gen(seed), B, tm.tree_parents(B), g,
                             torch.as_tensor(emb0).repeat(reps, 1)).numpy()
    keys, counts = np.unique(outs, axis=0, return_counts=True)
    got = {tuple(int(v) for v in key): c / reps
           for key, c in zip(keys, counts)}
    return 0.5 * sum(abs(got.get(s, 0.0) - p) for s, p in want.items()) \
        + 0.5 * sum(p for s, p in got.items() if s not in want)


@pytest.mark.parametrize("rep", ["dense", "csr", "bitset"])
def test_glauber_single_step_conditional_law(rep):
    g = three(GLAUBER_EDGES)[rep]
    adj = three(GLAUBER_EDGES)["dense"].adj.numpy()
    tv = _glauber_tv(g, adj, tm.path_adj(0, 2),
                     np.array([0, 1, 2]), 60000, seed=1)
    assert tv < 0.02, tv


def test_glauber_law_long_motif():
    edges = torus_edges(5)
    g = tg.csr_graph_from_edges(edges, device="cpu")
    adj = tg.graph_from_edgelist(edges, device="cpu").adj.numpy()
    B = tm.path_adj(0, 4)
    emb0 = tm.tree_sample(gen(8), tm.tree_parents(B), g,
                          torch.tensor([7]))[0].numpy()
    assert _glauber_tv(g, adj, B, emb0, 60000, seed=9) < 0.03


def test_glauber_empty_common_neighbourhood_falls_back_to_uniform():
    # images 0 and 4 of node 1's motif neighbours share no neighbour in a
    # path 0-1-2-3-4: node 1 resamples uniformly over all nodes
    edges = [[0, 1], [1, 2], [2, 3], [3, 4]]
    B = tm.path_adj(0, 2)
    emb0 = np.array([0, 1, 4])
    for g in three(edges).values():
        adj = tg.graph_from_edgelist(edges, device="cpu").adj.numpy()
        assert _glauber_tv(g, adj, B, emb0, 30000, seed=3) < 0.03


def test_edgeless_motif_embeds_uniformly():
    g = tg.graph_from_edgelist(torus_edges(4), device="cpu")
    parents = tm.tree_parents(np.zeros((3, 3), int))
    reps = 8000
    outs = tm.tree_sample(gen(9), parents, g,
                          torch.zeros(reps, dtype=torch.int64))
    counts = np.bincount(outs[:, 1].numpy(), minlength=16) / reps
    assert np.abs(counts - 1 / 16).max() < 0.02
    # and the Glauber move of an edgeless motif is uniform too
    B = np.zeros((3, 3), int)
    moved = tm.glauber_update(gen(10), B, parents, g, outs)
    changed = (moved != outs).any(1)
    assert changed.float().mean() > 0.8


def test_single_node_motif_moves_as_the_walk():
    g = tg.graph_from_edgelist([[0, 1], [1, 2], [2, 0], [2, 3]], device="cpu")
    B = tm.path_adj(0, 0)
    x = torch.arange(4).repeat(10)[:, None]
    got = tm.glauber_update(gen(4), B, (), g, x)
    want = tm.rw_update(gen(4), g, x[:, 0])
    assert torch.equal(got[:, 0], want)


def test_isolated_nodes():
    # an isolated pivot: the tree keeps the pivot's image, the walk jumps
    g = tg.graph_from_edgelist([[0, 1], [1, 2]], num_nodes=4, device="cpu")
    emb = tm.tree_sample(gen(0), (0,), g, torch.full((50,), 3))
    assert (emb == 3).all()
    ys = tm.rw_update(gen(1), g, torch.full((4000,), 3))
    assert len(np.unique(ys.numpy())) == 4
    jax_g = jg.graph_from_edgelist([[0, 1], [1, 2]], num_nodes=4)
    assert int(jm.tree_sample(jax.random.key(0), (0,), jax_g,
                              jnp.int32(3))[1]) == 3

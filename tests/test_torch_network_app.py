"""The port's network dictionary learning (apps/network.py) against the JAX
package and the numpy oracle, on the CPU in float64.

- Reconstruction on injected embeddings, W and start iterate (JAX's own,
  replayed): painted values within 1e-9 relative, dense canvas and grouped
  means within 1e-6, counts and edges exactly, including n > 65,536 (the
  JAX two-key grouping path).
- Training on injected patches and draws against
  ``tests/oracle_np.py::train_oracle``, iteration by iteration, with the
  first iteration's code discarded as the JAX ``ndl_train`` does: rtol
  1e-8, the golden tolerance of tests/test_onmf.py.
- Chunked and resumed training equal the uninterrupted run; checkpoints
  cross between the packages both ways.
- The chunked reconstruction on JAX's per-chunk draws (``fold_in(key, c)``)
  against the JAX chunked function: counts exactly, means within 1e-6;
  exact under any split of the same samples (counts equal, sums within
  1e-12: float addition in another order), including n > 65,536; a single
  chunk equals the unchunked function bit for bit.
- End to end at tests/test_network_app.py's configurations.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from onmf_ontf_ndl_tpu.apps import network as jnet
from onmf_ontf_ndl_tpu.data import graphs as jg
from onmf_ontf_ndl_tpu.samplers import motif as jm
from onmf_ontf_ndl_tpu_torch.apps import network as tnet
from onmf_ontf_ndl_tpu_torch.data import graphs as tg
from onmf_ontf_ndl_tpu_torch.models.state import init_state
from oracle_np import train_oracle

torch.set_num_threads(1)

F64 = torch.float64


def torus_adjacency(m):
    A = np.zeros((m * m, m * m), bool)
    for i in range(m):
        for j in range(m):
            u = i * m + j
            for di, dj in ((1, 0), (0, 1)):
                v = ((i + di) % m) * m + (j + dj) % m
                A[u, v] = A[v, u] = True
    return A


def replay_recon(jgraph, W, key, B, recons_iter, num_chains):
    """JAX's reconstruction draws: its embeddings and the coder's H0."""
    parents = jm.tree_parents(B)
    B_bytes = np.asarray(B, np.int8).tobytes()
    embs, vals = jnet._recon_sample_vals(
        jnp.asarray(W), jgraph, key, B_bytes, parents, recons_iter, 0.0, 30,
        False, False, num_chains, "bcd")
    _, hk = jax.random.split(key)
    H0 = jax.random.uniform(hk, (W.shape[1], embs.shape[0]),
                            dtype=jnp.float64)
    return (torch.as_tensor(np.array(embs, np.int64)),
            torch.as_tensor(np.array(H0)), np.asarray(vals), B_bytes,
            parents)


def grouped(ii, jj, mean, cnt):
    ii, jj, mean, cnt = (np.asarray(x) for x in (ii, jj, mean, cnt))
    real = cnt > 0
    return {(int(a), int(b)): (float(m), int(c)) for a, b, m, c in
            zip(ii[real], jj[real], mean[real], cnt[real])}


def assert_groups_equal(got, want):
    assert set(got) == set(want)
    for pair, (m, c) in want.items():
        assert got[pair][1] == c
        np.testing.assert_allclose(got[pair][0], m, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rep", ["dense", "csr"])
def test_reconstruction_equals_jax_on_injected_draws(rep):
    edges = np.argwhere(np.triu(torus_adjacency(6)))
    build_t = tg.graph_from_edgelist if rep == "dense" \
        else tg.csr_graph_from_edges
    build_j = jg.graph_from_edgelist if rep == "dense" \
        else jg.csr_graph_from_edges
    tgraph, jgraph = build_t(edges, device="cpu"), build_j(edges)
    B = jm.path_adj(1, 1)
    W = np.random.default_rng(2).random((9, 5))
    key = jax.random.key(42)
    embs, H0, vals, B_bytes, parents = replay_recon(jgraph, W, key, B, 300,
                                                    4)
    kw = dict(recons_iter=300, num_chains=4, embs=embs, H0=H0)
    tW = torch.as_tensor(W)
    _, tvals = tnet._recon_sample_vals(tW, tgraph, None, B, **kw)
    np.testing.assert_allclose(tvals.numpy(), vals, rtol=1e-9, atol=1e-12)

    jkw = dict(recons_iter=300, use_glauber=False, num_chains=4)
    dense, cnt = jnet.reconstruct_network(jnp.asarray(W), jgraph, key,
                                          B_bytes, parents, **jkw)
    tdense, tcnt = tnet.reconstruct_network(tW, tgraph, None, B, **kw)
    np.testing.assert_allclose(tdense.numpy(), np.asarray(dense), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(cnt))

    for include_self in (True, False):
        want = jnet.reconstruct_network_sparse(
            jnp.asarray(W), jgraph, key, B_bytes, parents,
            include_self=include_self, **jkw)
        got = tnet.reconstruct_network_sparse(tW, tgraph, None, B,
                                              include_self=include_self,
                                              **kw)
        assert_groups_equal(grouped(*got), grouped(*want))
        np.testing.assert_array_equal(
            tnet._edges_from_sparse_result(*got),
            jnet._edges_from_sparse_result(*want, tgraph.num_nodes))


@pytest.mark.parametrize("n", [65_536, 70_000, 3_000_000])
@pytest.mark.parametrize("include_self", [True, False])
def test_grouping_and_edges_equal_jax_beyond_65536_nodes(n, include_self):
    rng = np.random.default_rng(n % 97)
    M, k = 400, 3
    e = rng.integers(0, 40, (M, k))
    e[:3] = n - 1              # the largest index: the fused-key boundary
    e[3:6] = [n - 2, n - 1, 5]
    vals = rng.random((k * k, M)) * 2.0
    want = jnet._group_painted(jnp.asarray(e, jnp.int32), jnp.asarray(vals),
                               n, include_self=include_self)
    got = tnet._group_painted(torch.as_tensor(e), torch.as_tensor(vals), n,
                              include_self=include_self)
    ii, jj, sums, cnt = got
    assert (cnt > 0).all()
    keys = ii * n + jj
    assert (keys[1:] > keys[:-1]).all()          # ascending, distinct
    means = [s / np.maximum(c, 1) for s, c in ((want[2], want[3]),)]
    assert_groups_equal(grouped(ii, jj, sums / cnt, cnt),
                        grouped(want[0], want[1], means[0], want[3]))
    if n <= 70_000:
        np.testing.assert_array_equal(
            tnet._edges_from_sparse_result(ii, jj, sums / cnt, cnt),
            jnet._edges_from_sparse_result(want[0], want[1], means[0],
                                           want[3], n))


@pytest.mark.parametrize("rep", ["dense", "csr"])
@pytest.mark.parametrize("chunks,num_chains", [(2, 1), (3, 4)])
def test_chunked_reconstruction_equals_jax_on_injected_draws(rep, chunks,
                                                             num_chains):
    edges = np.argwhere(np.triu(torus_adjacency(6)))
    build_t = tg.graph_from_edgelist if rep == "dense" \
        else tg.csr_graph_from_edges
    build_j = jg.graph_from_edgelist if rep == "dense" \
        else jg.csr_graph_from_edges
    tgraph, jgraph = build_t(edges, device="cpu"), build_j(edges)
    B = jm.path_adj(1, 1)
    W = np.random.default_rng(4).random((9, 5))
    key = jax.random.key(17)
    total = 250                      # 125 a chunk; 84 -> 84 of 4 chains
    per_chunk = -(-total // chunks)
    embs, H0s = [], []
    for c in range(chunks):
        e, h, _, B_bytes, parents = replay_recon(
            jgraph, W, jax.random.fold_in(key, c), B, per_chunk, num_chains)
        assert e.shape[0] == -(-per_chunk // num_chains) * num_chains
        embs.append(e)
        H0s.append(h)
    want = jnet.reconstruct_network_sparse_chunked(
        jnp.asarray(W), jgraph, key, B_bytes, parents, recons_iter=total,
        chunks=chunks, num_chains=num_chains)
    got = tnet.reconstruct_network_sparse_chunked(
        torch.as_tensor(W), tgraph, None, B, recons_iter=total,
        chunks=chunks, num_chains=num_chains, embs=embs, H0=H0s)
    ii, jj, mean, cnt = got
    assert (cnt > 0).all()
    keys = ii * tgraph.num_nodes + jj
    assert (keys[1:] > keys[:-1]).all()          # ascending, distinct
    assert_groups_equal(grouped(*got), grouped(*want))
    # and the sums, pair by pair
    np.testing.assert_allclose(
        sorted((mean * cnt).tolist()),
        sorted((np.asarray(want[2]) * np.asarray(want[3]))[
            np.asarray(want[3]) > 0].tolist()), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tnet._edges_from_sparse_result(*got),
        jnet._edges_from_sparse_result(*want, tgraph.num_nodes))


def _ring_samples(n, M, k, seed):
    """A ring of n nodes as a CsrGraph and M injected samples on it: node
    tuples around a few sites and around the largest indices (the painted
    values need no homomorphism)."""
    u = np.arange(n)
    g = tg.csr_graph_from_edges(np.stack([u, (u + 1) % n], 1), device="cpu")
    rng = np.random.default_rng(seed)
    e = (rng.integers(0, 30, (M, 1)) + rng.integers(0, 3, (M, k))) % n
    e[:5] = n - 1 - rng.integers(0, 3, (5, k))
    return g, torch.as_tensor(e), torch.as_tensor(rng.random((6, M)))


def _pair_oracle(embs, vals_T):
    """Per directed pair off the diagonal: (sum, count) of its paints, by a
    host loop."""
    M, k = embs.shape
    out = {}
    for m in range(M):
        for q in range(k):
            for r in range(k):
                if q != r:
                    s, c = out.get((int(embs[m, q]), int(embs[m, r])), (0, 0))
                    out[int(embs[m, q]), int(embs[m, r])] = (
                        s + float(vals_T[q * k + r, m]), c + 1)
    return out


@pytest.mark.parametrize("n", [40, 70_000, 3_000_000])
@pytest.mark.parametrize("split", [(300,), (100, 200), (7, 150, 1, 142),
                                   (60,) * 5])
def test_chunk_merge_is_exact_under_any_split(n, split):
    M, k = 300, 3
    g, embs, H0 = _ring_samples(n, M, k, seed=len(split))
    W = torch.as_tensor(np.random.default_rng(1).random((k * k, 6)))
    B = jm.path_adj(0, 2)
    whole = tnet.reconstruct_network_sparse(
        W, g, None, B, recons_iter=M, include_self=False, embs=embs, H0=H0)
    cuts = np.cumsum((0,) + split)
    pieces = [slice(a, b) for a, b in zip(cuts[:-1], cuts[1:])]
    got = tnet.reconstruct_network_sparse_chunked(
        W, g, None, B, recons_iter=M, chunks=len(split), cap=10 * M,
        embs=[embs[p] for p in pieces],
        H0=[H0[:, p].contiguous() for p in pieces])
    for a, b in zip(got[:2] + got[3:], whole[:2] + whole[3:]):
        assert torch.equal(a, b)                  # pairs and counts
    torch.testing.assert_close(got[2], whole[2], rtol=0, atol=1e-12)
    if len(split) == 1:
        assert torch.equal(got[2], whole[2])
    _, vals_T = tnet._recon_sample_vals(W, g, None, B, recons_iter=M,
                                        embs=embs, H0=H0)
    oracle = _pair_oracle(embs.numpy(), vals_T.numpy())
    assert int(got[0].max()) == n - 1
    assert set(zip(got[0].tolist(), got[1].tolist())) == set(oracle)
    for i, j, mean, c in zip(*(x.tolist() for x in got)):
        assert c == oracle[i, j][1]
        assert mean == pytest.approx(oracle[i, j][0] / c, abs=1e-12)


def test_chunked_reconstruction_draws_overflow_and_budget():
    g = tg.csr_graph_from_edges(np.argwhere(np.triu(torus_adjacency(6))),
                                device="cpu")
    W = torch.as_tensor(np.random.default_rng(3).random((9, 4)))
    B = jm.path_adj(0, 2)
    kw = dict(recons_iter=90, num_chains=4)

    def gen():
        return torch.Generator().manual_seed(5)

    # one chunk draws from the generator itself: the unchunked function
    one = tnet.reconstruct_network_sparse_chunked(W, g, gen(), B, chunks=1,
                                                  **kw)
    whole = tnet.reconstruct_network_sparse(W, g, gen(), B,
                                            include_self=False, **kw)
    for a, b in zip(one, whole):
        assert torch.equal(a, b)
    # each chunk rounds its budget up to whole chain steps: 90 / 4 -> 23
    # -> 24 samples of 6 paints; the same seed gives the same result
    a = tnet.reconstruct_network_sparse_chunked(W, g, gen(), B, chunks=4,
                                                **kw)
    b = tnet.reconstruct_network_sparse_chunked(W, g, gen(), B, chunks=4,
                                                **kw)
    assert int(a[3].sum()) == 4 * 24 * 6
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[3], whole[3])        # fresh chains per chunk
    # the default cap is twice a chunk's paints; an accumulator that
    # outgrows a given cap raises and names the chunk
    distinct = len(a[0])
    with pytest.raises(ValueError, match=r"overflowed the 50-slot .*chunk "
                                         r"\d/4 \(\d+ distinct pairs\)"):
        tnet.reconstruct_network_sparse_chunked(W, g, gen(), B, chunks=4,
                                                cap=50, **kw)
    ok = tnet.reconstruct_network_sparse_chunked(W, g, gen(), B, chunks=4,
                                                 cap=distinct, **kw)
    assert len(ok[0]) == distinct
    with pytest.raises(ValueError, match="positive"):
        tnet.reconstruct_network_sparse_chunked(W, g, gen(), B, chunks=0,
                                                **kw)


def test_recons_accuracy_equal_on_both_forms():
    A = torus_adjacency(6)
    trec = tnet.NetworkReconstructor(source=tg.graph_from_adjacency(
                                         A, device="cpu"),
                                     n_components=4, sample_size=10, k1=0,
                                     k2=1, dtype=F64, device="cpu")
    jrec = jnet.NetworkReconstructor(source=jg.graph_from_adjacency(A),
                                     n_components=4, sample_size=10, k1=0,
                                     k2=1, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    R = rng.random((36, 36)) < 0.1
    R = R | R.T | A * (rng.random((36, 36)) < 0.5)
    R = R | R.T
    want = jrec.compute_recons_accuracy(jnp.asarray(R))
    assert trec.compute_recons_accuracy(torch.as_tensor(R)) == want
    edges = np.argwhere(np.triu(R, 1))
    assert trec.compute_recons_accuracy(edges) == \
        jrec.compute_recons_accuracy(edges) == want
    # the CSR and bitset forms score the same (their indices follow the
    # edge list's first appearance: map R into them)
    for build in (tg.csr_graph_from_edges, tg.bitset_graph_from_edges):
        other = tnet.NetworkReconstructor(
            source=build(np.argwhere(np.triu(A)), device="cpu"),
            n_components=4, sample_size=10, k1=0, k2=1, dtype=F64, device="cpu")
        label = np.asarray(other.G.node_ids)
        Ro = R[np.ix_(label, label)]
        assert other.compute_recons_accuracy(
            np.argwhere(np.triu(Ro, 1))) == want
        assert other.compute_recons_accuracy(torch.as_tensor(Ro)) == want


def _ndl_draws(rng, k, r, sample_size, mcmc, inner):
    return [(torch.as_tensor((rng.random((k * k, sample_size)) < 0.4)
                             .astype(np.float64)),
             [(None, torch.as_tensor(rng.random((r, sample_size))))
              for _ in range(inner - 1)])
            for _ in range(mcmc)]


def test_ndl_train_matches_oracle_iteration_by_iteration():
    rng = np.random.default_rng(11)
    k, r, S, mcmc, inner, alpha = 3, 6, 40, 3, 5, 0.1
    W0 = rng.random((k * k, r))
    draws = _ndl_draws(rng, k, r, S, mcmc, inner)
    g = tg.graph_from_adjacency(torus_adjacency(5), device="cpu")
    B = jm.path_adj(0, 2)
    emb0 = torch.tensor([0, 1, 2])
    kw = dict(sample_size=S, inner_iterations=inner, batch_size=S,
              alpha=alpha)

    W, A, Bm, t = W0, None, None, 0.0
    code_want = np.zeros((r, S))
    st = init_state(0, k * k, r, dtype=F64, W=W0, device="cpu")
    for i, (X, inner_draws) in enumerate(draws):
        W, A, Bm, _, code_i, t = train_oracle(
            X.numpy(), W, inner, [np.arange(S)] * (inner - 1),
            [h.numpy() for _, h in inner_draws], A=A, B=Bm, t0=t,
            alpha=alpha, stopping_diff=0.01)
        if i > 0:        # the first iteration's code is discarded
            code_want += code_i
        st, code, emb = tnet.ndl_train(st, g, emb0, B, mcmc_iterations=1,
                                       discard_first=(i == 0),
                                       draws=[draws[i]], **kw)
        np.testing.assert_allclose(st.W.numpy(), W, rtol=1e-8)
        np.testing.assert_allclose(st.A.numpy(), A, rtol=1e-8)
        np.testing.assert_allclose(st.B.numpy(), Bm, rtol=1e-8)
        assert st.t == t == (i + 1) * inner
        assert torch.equal(emb, emb0)
    st2 = init_state(0, k * k, r, dtype=F64, W=W0, device="cpu")
    st2, code, _ = tnet.ndl_train(st2, g, emb0, B, mcmc_iterations=mcmc,
                                  draws=draws, **kw)
    np.testing.assert_allclose(st2.W.numpy(), W, rtol=1e-8)
    np.testing.assert_allclose(code.numpy(), code_want, rtol=1e-8)


def test_ndl_train_chain_ensemble_rounds_the_sample_size():
    edges = np.argwhere(np.triu(torus_adjacency(5)))
    g = tg.csr_graph_from_edges(edges, device="cpu")
    B = jm.path_adj(0, 2)
    emb0 = torch.tensor([[0, 1, 2], [5, 6, 7], [10, 11, 12]])
    st = init_state(1, 9, 4, dtype=F64, device="cpu")
    st, code, emb = tnet.ndl_train(st, g, emb0, B, mcmc_iterations=2,
                                   sample_size=10, inner_iterations=3,
                                   batch_size=5, num_chains=3,
                                   subsample=True, use_stopping=False)
    assert code.shape == (4, 12) and emb.shape == (3, 3)
    assert (code.sum(0) > 0).any() and st.t == 6
    # g's node order
    adj = tg.graph_from_edgelist(edges, device="cpu").adj.numpy()
    assert adj[emb[:, 0], emb[:, 1]].all() and adj[emb[:, 1], emb[:, 2]].all()


def _small_rec(pkg, **kw):
    A = torus_adjacency(6)
    conf = dict(n_components=6, MCMC_iterations=4, sub_iterations=4,
                sample_size=30, batch_size=10, k1=0, k2=2, alpha=0.1, seed=3)
    conf.update(kw)
    if pkg == "jax":
        return jnet.NetworkReconstructor(source=jg.graph_from_adjacency(A),
                                         dtype=jnp.float64, **conf)
    return tnet.NetworkReconstructor(source=tg.graph_from_adjacency(
                                         A, device="cpu"),
                                     dtype=F64, device="cpu", **conf)


@pytest.mark.parametrize("num_chains", [1, 3])
def test_chunked_and_resumed_training_equal_the_fused_run(tmp_path,
                                                          num_chains):
    fused = _small_rec("torch", MCMC_iterations=5, num_chains=num_chains)
    fused.train_dict()
    chunked = _small_rec("torch", MCMC_iterations=5, num_chains=num_chains)
    chunked.train_dict(checkpoint_every=2)
    path = str(tmp_path / "ndl")
    part = _small_rec("torch", MCMC_iterations=2, num_chains=num_chains)
    part.train_dict(checkpoint_path=path, checkpoint_every=2)
    resumed = _small_rec("torch", MCMC_iterations=5, num_chains=num_chains)
    resumed.train_dict(checkpoint_path=path, checkpoint_every=2,
                       resume=True)
    for rec in (chunked, resumed):
        assert torch.equal(rec.W, fused.W)
        assert torch.equal(rec.emb, fused.emb)
        assert rec.state.t == fused.state.t == 20
        np.testing.assert_allclose(rec.code.numpy(), fused.code.numpy(),
                                   rtol=1e-12)
    with pytest.raises(ValueError, match="checkpoint_every"):
        fused.train_dict(resume=True)


@pytest.mark.parametrize("num_chains", [1, 3])
def test_checkpoints_cross_between_jax_and_the_port(tmp_path, num_chains):
    # JAX writes, the port resumes (nothing left to run: the loaded state
    # is the result), then continues; and the reverse
    path = str(tmp_path / "jax_ckpt")
    jrec = _small_rec("jax", MCMC_iterations=2, num_chains=num_chains)
    jrec.train_dict(checkpoint_path=path, checkpoint_every=2)
    trec = _small_rec("torch", MCMC_iterations=2, num_chains=num_chains)
    trec.train_dict(checkpoint_path=path, checkpoint_every=2, resume=True)
    np.testing.assert_array_equal(trec.W.numpy(), np.asarray(jrec.W))
    np.testing.assert_array_equal(trec.emb.numpy(), np.asarray(jrec.emb))
    np.testing.assert_array_equal(trec.code.numpy(), np.asarray(jrec.code))
    assert trec.state.t == float(jrec.state.t) == 8
    trec.MCMC_iterations = 4
    trec.train_dict(checkpoint_path=path, checkpoint_every=2, resume=True)
    assert trec.state.t == 16 and torch.isfinite(trec.W).all()

    path = str(tmp_path / "port_ckpt")
    trec = _small_rec("torch", MCMC_iterations=2, num_chains=num_chains)
    trec.train_dict(checkpoint_path=path, checkpoint_every=2)
    jrec = _small_rec("jax", MCMC_iterations=2, num_chains=num_chains)
    jrec.train_dict(checkpoint_path=path, checkpoint_every=2, resume=True)
    np.testing.assert_array_equal(np.asarray(jrec.W), trec.W.numpy())
    np.testing.assert_array_equal(np.asarray(jrec.emb), trec.emb.numpy())
    np.testing.assert_array_equal(np.asarray(jrec.code), trec.code.numpy())
    jrec.MCMC_iterations = 4
    jrec.train_dict(checkpoint_path=path, checkpoint_every=2, resume=True)
    assert float(jrec.state.t) == 16


def test_ndl_torus_end_to_end():
    # tests/test_network_app.py:22's configuration
    rec = tnet.NetworkReconstructor(
        source=tg.graph_from_adjacency(torus_adjacency(10), device="cpu"),
        n_components=16, MCMC_iterations=10, sub_iterations=10,
        sample_size=100, batch_size=20, k1=0, k2=2, alpha=0.1,
        is_glauber_dict=True, is_glauber_recons=False, dtype=F64, device="cpu")
    W = rec.train_dict()
    assert W.shape == (9, 16) and (W >= 0).all()
    assert rec.state.t == 10 * 10
    recon = rec.reconstruct_network(recons_iter=4000)
    assert recon.shape == (100, 100) and recon.dtype == torch.bool
    acc = rec.compute_recons_accuracy()
    assert 0.5 < acc <= 1.0, acc
    edges = rec.recons_edges()
    assert rec.compute_recons_accuracy(edges) == acc


def test_csr_graph_sparse_end_to_end_fast_ensemble():
    m = 12
    edges = np.argwhere(np.triu(torus_adjacency(m)))
    rec = tnet.NetworkReconstructor(
        source=tg.csr_graph_from_edges(edges, device="cpu"), n_components=16,
        MCMC_iterations=8, sub_iterations=10, sample_size=200, batch_size=50,
        k1=0, k2=2, num_chains=8, fast=True, seed=0, dtype=F64, device="cpu")
    rec.train_dict()
    out = rec.reconstruct_network(recons_iter=8000, num_chains=32)
    assert out.ndim == 2 and out.shape[1] == 2
    assert (out[:, 0] < out[:, 1]).all()
    assert rec.compute_recons_accuracy() > 0.9
    assert rec.has_edge(out[:, 0], out[:, 1]).mean() > 0.9
    dense = rec.reconstruct_network(recons_iter=8000, num_chains=32,
                                    sparse=False)
    assert dense.shape == (m * m, m * m)
    assert rec.compute_recons_accuracy() > 0.9


@pytest.mark.parametrize("weighted", [True, False])
def test_wan_weighted_patches(weighted):
    rng = np.random.default_rng(31)
    n = 40
    Wts = np.triu(rng.random((n, n)) * (rng.random((n, n)) < 0.2), 1)
    rec = tnet.NetworkReconstructor(
        adjacency=Wts + Wts.T, is_WAN=True, n_components=9,
        MCMC_iterations=5, sub_iterations=8, sample_size=64, batch_size=16,
        k1=0, k2=1, weighted_patches=weighted, is_glauber_recons=False,
        dtype=F64, device="cpu")
    assert float(rec.G.weight.max()) == 1.0
    W = rec.train_dict()
    assert torch.isfinite(W).all() and (W >= 0).all()
    rec.reconstruct_network(recons_iter=2000)
    if weighted:
        r = rec.recon_weights.numpy()
        wt = rec.G.weight.numpy()
        mask = (wt > 0) & (r > 0)
        assert mask.sum() > 10
        assert np.corrcoef(r[mask], wt[mask])[0, 1] > 0.2


def test_reconstructor_surface(tmp_path):
    g = tg.graph_from_edgelist([[7, 3], [3, 9], [9, 7]], device="cpu")
    rec = tnet.NetworkReconstructor(source=g, n_components=4,
                                    MCMC_iterations=2, sub_iterations=3,
                                    sample_size=20, batch_size=5, k1=0,
                                    k2=1, dtype=F64, device="cpu")
    assert rec.label_of(0) == 7 and rec.index_of(9) == 2
    with pytest.raises(ValueError, match="no reconstruction"):
        rec.recons_edges()
    rec.train_dict()
    assert rec.code.shape == (4, 20)
    assert rec.show_cov().shape == (4, 4)
    rec.reconstruct_network(recons_iter=200)
    path = rec.write_edgelist(str(tmp_path / "recon.txt"))
    A = rec.compute_A_recons(path)
    np.testing.assert_array_equal(A > 0, rec.G_recons.numpy() & ~np.eye(
        3, dtype=bool))
    # chunks > 1: the sparse path only, pieces merged into one edge array
    with pytest.raises(ValueError, match="sparse path"):
        rec.reconstruct_network(recons_iter=200, chunks=2)
    edges = rec.reconstruct_network(recons_iter=200, chunks=2, sparse=True)
    assert edges.ndim == 2 and edges.shape[1] == 2 and rec.G_recons is None
    assert (edges[:, 0] < edges[:, 1]).all()
    assert rec.compute_recons_accuracy() == rec.compute_recons_accuracy(edges)
    with pytest.raises(ValueError, match="overflowed .* chunk 1/2"):
        rec.reconstruct_network(recons_iter=200, chunks=2, sparse=True, cap=1)
    out = rec.display_dict(title="motifs",
                           save_filename=str(tmp_path / "dict.png"))
    assert out == str(tmp_path / "dict.png") and os.path.getsize(out) > 0
    rec.W = np.ones((4, 4))
    assert rec.state.W.dtype == F64
    with pytest.raises(ValueError, match="source or adjacency"):
        tnet.NetworkReconstructor(device="cpu")

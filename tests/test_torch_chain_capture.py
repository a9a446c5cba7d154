"""The motif chain's move function on static buffers (samplers/motif.py):
run in ``run_chains``' eager loop, it gives what the loop of moves gave
before it, bit for bit (the trail, and the generator's next draw), for
both moves on the three representations at k in {1, 3, 21}; and the pure
functions of the captured route: the route and the chain graph's cache
key. Exact comparisons throughout: the same moves on the same draws.
The captured route itself needs a card (tests/test_torch_cuda.py)."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu_torch.data import graphs as tg
from onmf_ontf_ndl_tpu_torch.samplers import motif as tm

torch.set_num_threads(1)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def random_edges(n=40, p=0.12, seed=3):
    """A random graph whose degrees spread from 1 to ~10: every node is
    joined to its successor, then each other pair with probability p."""
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(n, 1)
    keep = (rng.random(len(i)) < p) | (j == i + 1)
    return np.stack([i[keep], j[keep]], axis=1)


EDGES = random_edges()
GRAPHS = {"dense": tg.graph_from_edgelist(EDGES, device="cpu"),
          "csr": tg.csr_graph_from_edges(EDGES, device="cpu"),
          "bitset": tg.bitset_graph_from_edges(EDGES, device="cpu")}
# k = 1, 3 and 21: a single node, the 3-node path, the reference main()'s
# 21-node path
MOTIFS = {1: tm.path_adj(0, 0), 3: tm.path_adj(0, 2), 21: tm.path_adj(0, 20)}


def loop_of_moves(gen, g, emb0, B, steps, use_glauber):
    """``run_chains`` as it was before the move function: each move's new
    embeddings written into the trail at a Python index."""
    parents = tm.tree_parents(B)
    move = tm.glauber_update if use_glauber else tm.pivot_update
    trail = torch.empty((emb0.shape[0], steps, emb0.shape[1]),
                        dtype=torch.int64, device=emb0.device)
    emb = emb0
    for s in range(steps):
        emb = move(gen, B, parents, g, emb)
        trail[:, s] = emb
    return trail


@pytest.mark.parametrize("k", sorted(MOTIFS))
@pytest.mark.parametrize("rep", sorted(GRAPHS))
@pytest.mark.parametrize("use_glauber", [True, False],
                         ids=["glauber", "pivot"])
def test_move_function_equals_the_loop_of_moves(use_glauber, rep, k):
    g, B = GRAPHS[rep], MOTIFS[k]
    x0 = torch.randint(0, g.num_nodes, (16,), generator=gen(5))
    emb0 = tm.tree_sample(gen(6), tm.tree_parents(B), g, x0)
    before = emb0.clone()
    want_gen = gen(7)
    want = loop_of_moves(want_gen, g, emb0, B, 30, use_glauber)
    for capture in (True, False):     # both eager on the CPU
        got_gen = gen(7)
        got = tm.run_chains(got_gen, g, emb0, B, 30,
                            use_glauber=use_glauber, capture=capture)
        assert got.dtype == torch.int64 and got.shape == (16, 30, k)
        assert torch.equal(got, want)
        assert torch.equal(torch.rand(8, generator=got_gen),
                           torch.rand(8, generator=gen(0).set_state(
                               want_gen.get_state())))
    assert torch.equal(emb0, before)      # the caller's chains are not moved
    # the block function on its buffers, the embeddings kept in place; each
    # block's trail written by its block
    ch = tm._new_chains(emb0, tm._chain_kind(use_glauber, k), 3)
    emb_buf = ch.emb
    mg = gen(7)
    for b in range(2):
        tm._chain_block(ch, mg, B, tm.tree_parents(B), g, use_glauber)
        assert torch.equal(ch.trail, want[:, 3 * b:3 * b + 3])
    assert ch.emb is emb_buf
    assert torch.equal(ch.emb, want[:, 5])
    assert not tm._CHAIN_GRAPHS           # nothing captured on the CPU


def test_zero_moves_and_the_patch_ensemble_take_the_flag():
    g, B = GRAPHS["csr"], MOTIFS[3]
    emb0 = tm.tree_sample(gen(1), tm.tree_parents(B), g,
                          torch.arange(4))
    assert tm.run_chains(gen(2), g, emb0, B, 0).shape == (4, 0, 3)
    X, embs = tm.sample_patches_ensemble(gen(2), g, emb0, B, 6,
                                         capture=False)
    X2, embs2 = tm.sample_patches_ensemble(gen(2), g, emb0, B, 6)
    assert torch.equal(X, X2) and torch.equal(embs, embs2)


@pytest.mark.parametrize("device_type,capture,route", [
    ("cuda", True, "captured"),
    ("cuda", False, "eager"),
    ("cpu", True, "eager"),
    ("cpu", False, "eager"),
])
def test_chain_route(device_type, capture, route):
    assert tm._chain_route(device_type, capture) == route
    if capture:
        assert tm._chain_route(device_type) == route
    # the device and the flag alone: debug_nans checks training steps,
    # and a chain holds no float to check
    assert list(inspect.signature(tm._chain_route).parameters) == [
        "device_type", "capture"]
    from onmf_ontf_ndl_tpu_torch.utils.debug import debug_nans

    with debug_nans():
        assert tm._chain_route(device_type, capture) == route


def _with_tensor(g, field):
    """``g`` with one of its tensors replaced by a copy at a new address."""
    return dataclasses.replace(g, **{field: getattr(g, field).clone()})


def test_chain_key_changes_with_each_baked_argument_only():
    g, B = GRAPHS["csr"], MOTIFS[3]
    emb0 = torch.randint(0, g.num_nodes, (16, 3), generator=gen(1))
    key = tm._chain_key(g, emb0, B, True, 5)
    hash(key)
    # new chain values (of any integer dtype), another generator, the
    # same graph object rebuilt around the same tensors, a motif of
    # another dtype with the same entries: the same key
    assert tm._chain_key(g, torch.randint(0, 9, (16, 3), generator=gen(2)),
                         B, True, 5) == key
    assert tm._chain_key(g, emb0.int(), B, True, 5) == key
    assert tm._chain_key(dataclasses.replace(g), emb0, B, True, 5) == key
    assert tm._chain_key(g, emb0, B.astype(np.int64), True, 5) == key
    # a view of the same address, shape and strides is the same tensor to
    # the graph
    assert tm._chain_key(dataclasses.replace(g, deg=g.deg[:]), emb0, B,
                         True, 5) == key
    variants = [
        (g, emb0[:15], B, True),                                 # C
        (g, torch.zeros((16, 4), dtype=torch.int64),
         tm.path_adj(1, 2), True),                               # k
        (g, emb0, tm.path_adj(1, 1), True),         # the motif, same k
        (g, emb0, B, False),                                     # pivot
        (GRAPHS["dense"], emb0, B, True),                        # dense
        (GRAPHS["bitset"], emb0, B, True),                       # bitset
        (tg.csr_graph_from_edges(np.concatenate(
            [EDGES, [[39, 40]]]), device="cpu"), emb0, B, True),  # nodes
        (dataclasses.replace(g, max_deg=g.max_deg + 1), emb0, B, True),
        (g, emb0.to("meta"), B, True),                           # device
        (g, emb0, B, True, 6),                          # the block's moves
    ]
    # each tensor a move reads, in each representation, at a new address
    for rep, fields in (("csr", ("nbr_flat", "offsets", "deg")),
                        ("bitset", ("bits", "nbr_flat", "offsets", "deg")),
                        ("dense", ("adj", "nbr", "deg"))):
        assert len(fields) == len(tm._graph_tensors(GRAPHS[rep]))
        for field in fields:
            variants.append((_with_tensor(GRAPHS[rep], field), emb0, B,
                             True))
    # the same memory seen with other strides
    variants.append((dataclasses.replace(g, deg=g.deg.as_strided(
        (g.num_nodes // 2,), (2,))), emb0, B, True))
    keys = {key} | {tm._chain_key(*v, 5) if len(v) == 4 else tm._chain_key(*v)
                   for v in variants}
    assert len(keys) == 1 + len(variants)

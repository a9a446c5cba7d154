"""The motif chain's moves split into draws and their use
(samplers/motif.py) and the route to the chain kernel
(ops/kernels/motif_kernel.py), on the CPU.

The moves rebuilt on draws + apply must equal the moves as they were before
the split bit for bit: a frozen copy of those moves is kept below. Exact
comparisons throughout (the trail, the final embeddings and the generator's
next draw): the same arithmetic on the same draws. Covered: dense, CSR and
bitset graphs with isolated nodes and an edgeless graph; path motifs of
k = 1, 3 and 21, a triangle, an edgeless motif and a motif with a
parentless node; chains whose Glauber move meets an empty common
neighbourhood. Also the route and the chain graph's key by device and
backend alone, and a numpy float32 emulation of the kernel's index and
acceptance arithmetic (``csrc/motif_kernels.cu``: ``__fmul_rn`` of the
uniform and the int64 rounded to float, truncated; ``__fdiv_rn``) against
torch's, at uniforms near 1 and degrees up to and past 2^24. The kernel
itself needs a card (tests/test_torch_cuda.py)."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu_torch.data import graphs as tg
from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib
from onmf_ontf_ndl_tpu_torch.ops.kernels import motif_kernel as mk
from onmf_ontf_ndl_tpu_torch.samplers import motif as tm
from test_torch_chain_capture import EDGES, MOTIFS

torch.set_num_threads(1)


# ------------------------------------------ the moves before the split
def _frozen_uniform_neighbor(gen, g, x, u=None):
    d = g.deg[x]
    if u is None:
        u = torch.rand(x.shape, generator=gen, device=x.device)
    d1 = d.clamp_min(1)
    idx = torch.minimum((u * d1).long(), d1 - 1)
    if isinstance(g, (tg.CsrGraph, tg.BitsetGraph)):
        y = tm._csr_at(g, g.offsets[x] + idx)
    else:
        y = g.nbr[x, idx]
    return torch.where(d > 0, y, x)


def frozen_tree_sample(gen, parents, g, x):
    k = len(parents) + 1
    emb = torch.empty(x.shape + (k,), dtype=torch.int64, device=x.device)
    emb[:, 0] = x
    u = torch.rand((k - 1,) + x.shape, generator=gen, device=x.device)
    for i, p in enumerate(parents, start=1):
        if p < 0:
            emb[:, i] = torch.randint(0, g.num_nodes, x.shape, generator=gen,
                                      device=x.device)
        else:
            emb[:, i] = _frozen_uniform_neighbor(gen, g, emb[:, p], u[i - 1])
    return emb


def frozen_rw_update(gen, g, x):
    y = _frozen_uniform_neighbor(gen, g, x)
    dx = g.deg[x]
    accept = (torch.rand(x.shape, generator=gen, device=x.device)
              < dx.float() / g.deg[y].clamp_min(1).float())
    y = torch.where(accept, y, x)
    jump = torch.randint(0, g.num_nodes, x.shape, generator=gen,
                         device=x.device)
    return torch.where(dx > 0, y, jump)


def _frozen_rank_select(gen, cand, ok, n):
    c = ok.long().cumsum(1)
    total = c[:, -1]
    u = torch.rand(total.shape, generator=gen, device=cand.device)
    target = torch.minimum((u * total).long() + 1, total.clamp_min(1))
    idx = (c >= target[:, None]).long().argmax(1)
    y = cand.gather(1, idx[:, None])[:, 0]
    fallback = torch.randint(0, n, total.shape, generator=gen,
                             device=cand.device)
    return torch.where(total > 0, y, fallback)


def frozen_glauber_update(gen, B, parents, g, emb):
    C, k = emb.shape
    emb = emb.clone()
    if k == 1:
        emb[:, 0] = frozen_rw_update(gen, g, emb[:, 0])
        return emb
    tbl = tm._neighbor_table_on(B, emb.device)
    j = torch.randint(0, k, (C,), generator=gen, device=emb.device)
    sel = tbl[j]
    S = sel.shape[1]
    valid = sel >= 0
    imgs = emb.gather(1, sel.clamp_min(0))
    first = valid.long().argmax(1)
    cand, ok = tm._row_slots(g, imgs.gather(1, first[:, None])[:, 0])
    D = cand.shape[1]
    member = tm._has_edges(g, imgs[:, :, None].expand(C, S, D),
                           cand[:, None, :].expand(C, S, D))
    active = valid & (torch.arange(S, device=emb.device) != first[:, None])
    ok &= (member | ~active[:, :, None]).all(1)
    ok &= valid.any(1)[:, None]
    emb[torch.arange(C, device=emb.device), j] = _frozen_rank_select(
        gen, cand, ok, g.num_nodes)
    return emb


def frozen_pivot_update(gen, B, parents, g, emb):
    return frozen_tree_sample(gen, parents, g,
                              frozen_rw_update(gen, g, emb[:, 0]))


FROZEN = {True: frozen_glauber_update, False: frozen_pivot_update}


# ------------------------------------------------------ graphs, motifs
def graphs(edges, device="cpu"):
    return {"dense": tg.graph_from_edgelist(edges, device=device),
            "csr": tg.csr_graph_from_edges(edges, device=device),
            "bitset": tg.bitset_graph_from_edges(edges, device=device)}


# the random graph of test_torch_chain_capture.py (40 nodes, degrees 1 to
# ~10), with two isolated nodes (self-loops intern a label and are dropped)
ISOLATED = (40, 41)
GRAPHS = graphs(np.concatenate([EDGES, [[v, v] for v in ISOLATED]]))


def _motif(n, edges):
    B = np.zeros((n, n), int)
    for a, b in edges:
        B[a, b] = 1
    return B


ALL_MOTIFS = {
    **{f"path{k}": B for k, B in MOTIFS.items()},
    "triangle": _motif(3, [(0, 1), (1, 2), (0, 2)]),   # two constraints
    "edgeless": np.zeros((3, 3), int),       # no constraint, no parent
    "parentless": _motif(4, [(0, 1), (1, 2)]),          # node 3: no parent
}


def start(g, B, C=24, seed=5):
    """C chains from pivots of ``seed``, the first two on the isolated
    nodes, grown by the new tree_sample, which must equal the frozen one
    (the embeddings and the generator's next draw)."""
    x0 = torch.randint(0, g.num_nodes, (C,), generator=gen(seed))
    x0[:2] = torch.tensor(ISOLATED)
    got_gen, want_gen = gen(seed + 1), gen(seed + 1)
    got = tm.tree_sample(got_gen, tm.tree_parents(B), g, x0)
    assert torch.equal(got, frozen_tree_sample(want_gen, tm.tree_parents(B),
                                               g, x0))
    assert_same_state(got_gen, want_gen)
    return got


def gen(seed):
    return torch.Generator().manual_seed(seed)


def assert_same_state(a, b):
    """The two generators give the same next draws."""
    ca, cb = (torch.Generator().set_state(x.get_state()) for x in (a, b))
    assert torch.equal(torch.rand(8, generator=ca), torch.rand(8, generator=cb))


# --------------------------------------------------------------- moves
@pytest.mark.parametrize("motif", sorted(ALL_MOTIFS))
@pytest.mark.parametrize("rep", sorted(GRAPHS))
@pytest.mark.parametrize("use_glauber", [True, False],
                         ids=["glauber", "pivot"])
def test_moves_equal_the_moves_before_the_split(use_glauber, rep, motif):
    g, B = GRAPHS[rep], ALL_MOTIFS[motif]
    parents = tm.tree_parents(B)
    emb0 = start(g, B)
    move = tm.glauber_update if use_glauber else tm.pivot_update
    got_gen, want_gen = gen(7), gen(7)
    got = want = emb0
    for _ in range(12):
        got = move(got_gen, B, parents, g, got)
        want = FROZEN[use_glauber](want_gen, B, parents, g, want)
        assert got.dtype == torch.int64 and torch.equal(got, want)
    assert_same_state(got_gen, want_gen)
    # run_chains (the move function on its buffers) on both backends
    want_gen = gen(8)
    want, trail = emb0, []
    for _ in range(12):
        want = FROZEN[use_glauber](want_gen, B, parents, g, want)
        trail.append(want)
    for backend in ("auto", "torch"):
        got_gen = gen(8)
        got = tm.run_chains(got_gen, g, emb0, B, 12, use_glauber=use_glauber,
                            backend=backend)
        assert torch.equal(got, torch.stack(trail, 1))
        assert_same_state(got_gen, want_gen)


@pytest.mark.parametrize("rep", sorted(GRAPHS))
def test_walk_equals_the_walk_before_the_split(rep):
    g = GRAPHS[rep]
    x0 = torch.arange(g.num_nodes).repeat(3)
    got_gen, want_gen = gen(3), gen(3)
    x = x0
    for _ in range(5):
        got = tm.rw_update(got_gen, g, x)
        want = frozen_rw_update(want_gen, g, x)
        assert torch.equal(got, want)
        x = got
    assert_same_state(got_gen, want_gen)
    # every isolated node jumped to its jump draw
    x = x0
    draws = tm._walk_draws(gen(4), g.num_nodes, x)
    moved = tm._walk_apply(g, x, draws)
    iso = g.deg[x] == 0
    assert bool(iso.any())
    assert torch.equal(moved[iso], draws[2][iso])


def test_glauber_meets_an_empty_common_neighbourhood():
    """The middle node of a 3-node path whose ends have no common
    neighbour takes the uniform fallback draw."""
    for g in GRAPHS.values():
        adj = tm._has_edges(g, torch.arange(40)[:, None],
                            torch.arange(40)[None, :])
        common = (adj.long() @ adj.long()) > 0
        a, b = map(int, (~common).nonzero()[0])
        emb = torch.tensor([[a, 0, b]] * 6)
        B, tbl = ALL_MOTIFS["path3"], tm._neighbor_table_on(
            ALL_MOTIFS["path3"], "cpu")
        j = torch.ones(6, dtype=torch.int64)
        draws = (j, torch.rand(6, generator=gen(1)), torch.arange(6) + 10)
        out = mk.chain_moves_plain("glauber", emb.clone(), tm._one(draws), g,
                                   tbl)
        assert out[:, 1].tolist() == list(range(10, 16))
        assert torch.equal(out[:, [0, 2]], emb[:, [0, 2]])
        got = frozen_glauber_update(gen(2), B, tm.tree_parents(B), g, emb)
        assert torch.equal(tm.glauber_update(gen(2), B, tm.tree_parents(B),
                                             g, emb), got)


@pytest.mark.parametrize("use_glauber", [True, False],
                         ids=["glauber", "pivot"])
@pytest.mark.parametrize("k", [1, 3, 21])
def test_edgeless_graph_moves_and_agrees_across_representations(
        use_glauber, k):
    """A graph with no edge (CSR: an empty ``nbr_flat``): every walk
    jumps, every Glauber move falls back; the three representations give
    the same chains, and the dense one the moves' before the split."""
    gs = graphs(np.array([[v, v] for v in range(5)]))
    assert gs["csr"].nbr_flat.numel() == 0
    B = MOTIFS[k]
    parents = tm.tree_parents(B)
    trails = {}
    for rep, g in gs.items():
        emb0 = tm.tree_sample(gen(1), parents, g, torch.arange(5))
        trails[rep] = tm.run_chains(gen(2), g, emb0, B, 6,
                                    use_glauber=use_glauber)
    assert torch.equal(trails["csr"], trails["dense"])
    assert torch.equal(trails["bitset"], trails["dense"])
    want_gen, want = gen(2), frozen_tree_sample(gen(1), parents, gs["dense"],
                                                torch.arange(5))
    for s in range(6):
        want = FROZEN[use_glauber](want_gen, B, parents, gs["dense"], want)
        assert torch.equal(trails["dense"][:, s], want)


def test_draws_have_the_plain_moves_shapes_and_order():
    x = torch.arange(6)
    u_nb, u_acc, jump = tm._walk_draws(gen(1), 9, x)
    ref = gen(1)
    assert torch.equal(u_nb, torch.rand(6, generator=ref))
    assert torch.equal(u_acc, torch.rand(6, generator=ref))
    assert torch.equal(jump, torch.randint(0, 9, (6,), generator=ref))
    parents = (0, -1, 1, -1)
    u, roots = tm._tree_draws(gen(2), parents, 9, x)
    ref = gen(2)
    assert torch.equal(u, torch.rand((4, 6), generator=ref))
    assert roots.shape == (2, 6) and roots.dtype == torch.int64
    for row in roots:    # one randint call per parentless node, in order
        assert torch.equal(row, torch.randint(0, 9, (6,), generator=ref))
    j, u, fb = tm._glauber_draws(gen(3), 6, 4, 9, "cpu")
    ref = gen(3)
    assert torch.equal(j, torch.randint(0, 4, (6,), generator=ref))
    assert torch.equal(u, torch.rand(6, generator=ref))
    assert torch.equal(fb, torch.randint(0, 9, (6,), generator=ref))


# ------------------------------------------------------ the route, key
@pytest.mark.parametrize("device_type,backend,route", [
    ("cuda", "auto", "kernel"),
    ("cuda", "torch", "plain"),
    ("cpu", "auto", "plain"),
    ("cpu", "torch", "plain"),
])
def test_chain_move_route(device_type, backend, route):
    assert mk.chain_move_route(device_type, backend) == route
    if backend == "auto":
        assert mk.chain_move_route(device_type) == route
    # the device and the backend alone
    assert list(inspect.signature(mk.chain_move_route).parameters) == [
        "device_type", "backend"]


def test_unknown_backend_and_kind_raise():
    with pytest.raises(ValueError, match="backend"):
        mk.chain_move_route("cuda", "cuda")
    g = GRAPHS["csr"]
    with pytest.raises(ValueError, match="backend"):
        tm.run_chains(gen(0), g, torch.zeros((2, 3), dtype=torch.int64),
                      MOTIFS[3], 2, backend="triton")
    with pytest.raises(ValueError, match="unknown move"):
        mk.chain_moves("swap", torch.zeros((2, 3), dtype=torch.int64), (), g)


def test_chain_key_takes_the_route_of_the_backend(monkeypatch):
    g, B = GRAPHS["csr"], MOTIFS[3]
    emb0 = torch.zeros((16, 3), dtype=torch.int64)
    key = tm._chain_key(g, emb0, B, True, 5)
    assert tm._chain_key(g, emb0, B, True, 5, "auto") == key
    # on the CPU both backends run the plain version: the same graph
    assert tm._chain_key(g, emb0, B, True, 5, "torch") == key
    assert "plain" in key and "kernel" not in key
    # where the route differs, so does the key (on a card: "auto" is the
    # kernel, "torch" the plain version)
    monkeypatch.setattr(tm, "chain_move_route",
                        lambda device_type, backend="auto":
                        "kernel" if backend == "auto" else "plain")
    assert tm._chain_key(g, emb0, B, True, 5, "auto") != \
        tm._chain_key(g, emb0, B, True, 5, "torch")
    assert "kernel" in tm._chain_key(g, emb0, B, True, 5)


# ------------------------------------------- the kernel's arithmetic
def _f32_index(u, d):
    """The kernel's min(trunc(__fmul_rn(u, __ll2float_rn(d))), d - 1)."""
    prod = np.float32(u) * np.asarray(d, np.int64).astype(np.float32)
    return np.minimum(np.trunc(prod).astype(np.int64), np.asarray(d) - 1)


def test_float32_emulation_of_the_kernel_index_and_acceptance():
    one_minus = np.nextafter(np.float32(1), np.float32(0))   # 1 - 2^-24
    # 1.0 itself is never drawn (torch.rand is in [0, 1)): there the product
    # is d and only the clamp keeps the index in the row
    us = np.array([0.0, 2.0 ** -24, 0.5, 0.9999, 1 - 2.0 ** -23, one_minus,
                   1.0], np.float32)
    ds = np.array([1, 2, 3, 7, 27, 289, 797, 1000, 4095, 2 ** 20 - 1,
                   2 ** 23 + 1, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1,
                   2 ** 24 + 3, 2 ** 25 + 5], np.int64)
    rng = np.random.default_rng(0)
    us = np.concatenate([us, rng.random(200).astype(np.float32)])
    U, D = (a.reshape(-1) for a in np.meshgrid(us, ds, indexing="ij"))
    u, d = torch.from_numpy(U), torch.from_numpy(D)
    # _neighbor_at's index, and the rank-select's target
    want = _f32_index(U, D)
    assert np.array_equal(
        torch.minimum((u * d).long(), d - 1).numpy(), want)
    target = torch.minimum((u * d).long() + 1, d.clamp_min(1))
    assert np.array_equal(target.numpy(), np.minimum(
        np.trunc(U * D.astype(np.float32)).astype(np.int64) + 1, D))
    assert bool((np.trunc(U * D.astype(np.float32)) >= D).any())
    # the acceptance u < float(dx) / float(dy), correctly rounded
    DY = np.roll(D, 7)
    ratio = D.astype(np.float32) / DY.astype(np.float32)
    assert np.array_equal(
        (u < d.float() / torch.from_numpy(DY).float()).numpy(), U < ratio)
    # the kernel's conversion rounds to nearest, as torch's does
    big = torch.tensor([2 ** 24 + 1, 2 ** 24 + 3, 2 ** 25 + 5])
    assert big.float().tolist() == [2.0 ** 24, 2.0 ** 24 + 4, 2.0 ** 25 + 4]


# ----------------------------------------------- the wrapper on the CPU
def test_chain_move_on_a_cpu_tensor_runs_the_plain_version():
    g, B = GRAPHS["bitset"], ALL_MOTIFS["parentless"]
    parents = tm.tree_parents(B)
    emb0 = start(g, B, C=8)
    x = emb0[:, 0]
    draws = tm._one(tm._walk_draws(gen(1), g.num_nodes, x)
                    + tm._tree_draws(gen(2), parents, g.num_nodes, x))
    _lib.reset_launches()
    a = mk.chain_moves("pivot", emb0.clone(), draws, g, parents=parents)
    b = mk.chain_moves_plain("pivot", emb0.clone(), draws, g,
                             parents=parents)
    assert torch.equal(a, b) and not torch.equal(a, emb0)
    assert _lib.LAUNCHES["chain_move"] == 0        # no kernel ran
    # in place: the buffer it was given
    buf = emb0.clone()
    assert mk.chain_moves("pivot", buf, draws, g, parents=parents) is buf


@pytest.mark.parametrize("rep", sorted(GRAPHS))
def test_graph_arguments_of_the_entry_points(rep):
    g = GRAPHS[rep]
    args = mk._graph_args(g)
    assert len(args) == 10
    assert args[0] == {"dense": 0, "csr": 1, "bitset": 2}[rep]
    assert args[1] == g.num_nodes
    assert args[7] == g.deg.data_ptr()
    if rep == "dense":
        assert args[2] == g.adj.data_ptr() and args[3] == g.nbr.data_ptr()
        assert args[4] == g.nbr.shape[1] and args[5] is None
    else:
        assert args[2] is None and args[5] == g.nbr_flat.data_ptr()
        assert args[6] == g.offsets.data_ptr()
    if rep == "bitset":
        assert args[8] == g.bits.data_ptr() and args[9] == g.words_per_row
    else:
        assert args[8] is None and args[9] == 0
    import dataclasses

    strided = dataclasses.replace(g, deg=g.deg.repeat(2)[::2])
    with pytest.raises(TypeError, match="deg"):
        mk._graph_args(strided)


def test_chain_move_is_counted_and_counts_its_own_runs():
    """``chain_move`` has a launch count and a device run count of its
    own: motif_kernels.cu's two kernels each count one run per launch,
    with a counter of that source's own, read and zeroed by its entries."""
    assert "chain_move" in _lib.LAUNCHES
    assert _lib.RUN_KERNELS[-1] == "chain_move"
    src = (Path(_lib.__file__).parent / "csrc" /
           "motif_kernels.cu").read_text()
    kernels = re.findall(
        r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", src)
    assert kernels == ["chain_glauber_kernel", "chain_pivot_kernel"]
    assert src.count("count_chain_run();") == 2
    for entry in ("onmf_chain_glauber", "onmf_chain_pivot",
                  "onmf_chain_read_runs", "onmf_chain_reset_runs"):
        assert f"int {entry}(" in src
    assert "__fmul_rn" in src and "__fdiv_rn" in src
    assert "use_fast_math" not in " ".join(_lib._NVCC_FLAGS)
    # the parents on a device: one copy per motif and device
    a = mk._device_parents((0, -1, 1), torch.device("cpu"))
    assert a is mk._device_parents((0, -1, 1), torch.device("cpu"))
    assert a.tolist() == [0, -1, 1] and a.dtype == torch.int64

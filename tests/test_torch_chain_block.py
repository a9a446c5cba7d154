"""The motif chain's blocks of moves (samplers/motif.py, the plain block
of ops/kernels/motif_kernel.py) on the CPU.

A block of M moves (their draws into (M, ...) buffers in the plain moves'
order, then ``chain_moves_plain``, which writes the block's trail) must
equal M single moves, each recorded after it, bit for bit: the trail, the
final embeddings and the generator's next draw; on dense, CSR and bitset
graphs, k = 1, 3 and 21, both moves, M = 1, 5 and the whole run, with a
remainder. ``run_chains`` in blocks of a forced small M still equals the
loop of moves of before the blocks. The block's size (M) and the Glauber
kernel's team (warps a chain) come from shapes alone; the cache key holds
M. A numpy float32 emulation of the kernel source (its scaled index, its
rank-select target and its acceptance; the pivot's walks first and its
trees regrown after from their roots; a Glauber row's chunks dealt over a
team of warps, the kept ballots scanned and the chunks past them counted
again) equals the plain block, and its pick the target-th valid
candidate for every team. The kernel itself needs a card
(tests/test_torch_cuda.py)."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib
from onmf_ontf_ndl_tpu_torch.ops.kernels import motif_kernel as mk
from onmf_ontf_ndl_tpu_torch.samplers import motif as tm
from test_torch_chain_capture import GRAPHS, MOTIFS, loop_of_moves

torch.set_num_threads(1)

STEPS = 12


def gen(seed):
    return torch.Generator().manual_seed(seed)


def next_draws(g):
    return torch.rand(8, generator=torch.Generator().set_state(
        g.get_state()))


def start(g, B, C=16, seed=5):
    x0 = torch.randint(0, g.num_nodes, (C,), generator=gen(seed))
    return tm.tree_sample(gen(seed + 1), tm.tree_parents(B), g, x0)


def single_moves(gen_, g, B, emb0, steps, use_glauber):
    """``steps`` single moves, each from its own draws applied as a block
    of one, its state then recorded: the trail and the final chains."""
    parents = tm.tree_parents(B)
    C, k = emb0.shape
    kind = tm._chain_kind(use_glauber, k)
    tbl = tm._neighbor_table_on(B, "cpu") if kind == "glauber" else None
    emb = emb0.clone()
    trail = torch.empty((C, steps, k), dtype=torch.int64)
    for s in range(steps):
        x = emb[:, 0]
        if kind == "glauber":
            draws = tm._glauber_draws(gen_, C, k, g.num_nodes, "cpu")
        else:
            draws = tm._walk_draws(gen_, g.num_nodes, x)
            if kind == "pivot":
                draws += tm._tree_draws(gen_, parents, g.num_nodes, x)
        mk.chain_moves_plain(kind, emb, tm._one(draws), g, tbl, parents)
        trail[:, s] = emb
    return trail, emb


@pytest.mark.parametrize("M", [1, 5, STEPS])
@pytest.mark.parametrize("k", sorted(MOTIFS))
@pytest.mark.parametrize("rep", sorted(GRAPHS))
@pytest.mark.parametrize("use_glauber", [True, False],
                         ids=["glauber", "pivot"])
def test_a_block_equals_its_single_moves(use_glauber, rep, k, M):
    g, B = GRAPHS[rep], MOTIFS[k]
    parents = tm.tree_parents(B)
    emb0 = start(g, B)
    want_gen = gen(7)
    want, want_emb = single_moves(want_gen, g, B, emb0, STEPS, use_glauber)
    # blocks of M moves on their buffers (5: two blocks, then a rest of 2)
    kind = tm._chain_kind(use_glauber, k)
    got_gen = gen(7)
    got = torch.empty_like(want)
    emb, done = emb0, 0
    for moves, times in tm._chain_blocks(STEPS, M):
        ch = tm._new_chains(emb, kind, moves)
        assert ch.trail.shape == (16, moves, k)
        assert all(d.shape[0] == moves for d in ch.draws)
        for _ in range(times):
            tm._chain_block(ch, got_gen, B, parents, g, use_glauber)
            got[:, done:done + moves] = ch.trail
            done += moves
        emb = ch.emb
    assert done == STEPS
    assert torch.equal(got, want)
    assert torch.equal(emb, want_emb) and torch.equal(emb, got[:, -1])
    assert torch.equal(next_draws(got_gen), next_draws(want_gen))
    # the wrapper on the CPU: the plain block writes every row of the
    # block's own trail, and its final embeddings in place
    ch = tm._new_chains(emb0, kind, STEPS)
    tm._block_draws(ch, gen(7), parents, g.num_nodes, kind)
    tbl = tm._neighbor_table_on(B, "cpu") if kind == "glauber" else None
    trail = torch.full((16, STEPS, k), -1, dtype=torch.int64)
    out = mk.chain_moves(kind, ch.emb, ch.draws, g, tbl, parents, trail)
    assert out is ch.emb and torch.equal(out, want_emb)
    assert torch.equal(trail, want)


@pytest.mark.parametrize("k", sorted(MOTIFS))
@pytest.mark.parametrize("rep", sorted(GRAPHS))
@pytest.mark.parametrize("use_glauber", [True, False],
                         ids=["glauber", "pivot"])
def test_run_chains_in_small_blocks_equals_the_loop_of_moves(
        use_glauber, rep, k, monkeypatch):
    g, B = GRAPHS[rep], MOTIFS[k]
    emb0 = start(g, B)
    C = emb0.shape[0]
    kind = tm._chain_kind(use_glauber, k)
    draw = {"glauber": 20, "walk": 16, "pivot": 16 + 4 * (k - 1)}[kind]
    # blocks of 7 moves: 4 of them, then one of 2
    monkeypatch.setattr(tm, "_BLOCK_BYTES", 7 * C * (draw + 8 * k))
    assert tm._chain_block_moves(C, k, kind, 30) == 7
    assert tm._chain_blocks(30, 7) == [(7, 4), (2, 1)]
    want_gen = gen(9)
    want = loop_of_moves(want_gen, g, emb0, B, 30, use_glauber)
    for backend in ("auto", "torch"):
        got_gen = gen(9)
        got = tm.run_chains(got_gen, g, emb0, B, 30, use_glauber=use_glauber,
                            backend=backend)
        assert torch.equal(got, want)
        assert torch.equal(next_draws(got_gen), next_draws(want_gen))
    assert not tm._CHAIN_GRAPHS


def test_block_moves_from_shapes_alone():
    assert list(inspect.signature(tm._chain_block_moves).parameters) == [
        "C", "k", "kind", "steps", "roots"]
    assert tm._BLOCK_BYTES == 16 * 2 ** 20
    # the smoke's chains: (a) training and reconstruction, (b) training
    # and reconstruction (16 MiB over 8,192 x 44 bytes a move)
    assert tm._chain_block_moves(8, 21, "glauber", 63) == 63
    assert tm._chain_block_moves(256, 21, "pivot", 391) == 248
    assert tm._chain_block_moves(16, 3, "glauber", 32) == 32
    assert tm._chain_block_moves(8192, 3, "glauber", 586) == 46
    assert tm._chain_blocks(391, 248) == [(248, 1), (143, 1)]
    assert tm._chain_blocks(586, 46) == [(46, 12), (34, 1)]
    assert tm._chain_blocks(32, 32) == [(32, 1)]
    # a parentless node's draws count; a block is never empty
    assert tm._chain_block_moves(256, 21, "pivot", 10 ** 6, roots=3) < 248
    assert tm._chain_block_moves(10 ** 9, 21, "pivot", 5) == 1
    assert tm._chain_block_moves(0, 3, "walk", 5) == 5
    for C in (1, 8, 300, 8192, 10 ** 5):
        for kind, k in (("glauber", 3), ("walk", 1), ("pivot", 21)):
            M = tm._chain_block_moves(C, k, kind, 10 ** 6)
            draw = {"glauber": 20, "walk": 16, "pivot": 96}[kind]
            assert M == 1 or M * C * (draw + 8 * k) <= tm._BLOCK_BYTES
            assert (M + 1) * C * (draw + 8 * k) > tm._BLOCK_BYTES
            assert tm._chain_block_moves(C, k, kind, 3) == min(3, M)
    assert tm._chain_kind(True, 3) == "glauber"
    assert tm._chain_kind(True, 1) == "walk"
    assert tm._chain_kind(False, 1) == "pivot"


@pytest.mark.parametrize("chains,max_deg,sms,warps", [
    (8, 797, 132, 8),       # (a) training: 8 chains, hubs of 797
    (16, 4, 132, 1),        # (b) training: rows of one chunk
    (8192, 4, 132, 1),      # (b) reconstruction
    (256, 797, 132, 4),     # 256 chains x 4 warps fill 1,024 of 1,056
    (132, 797, 132, 8), (133, 797, 132, 4),
    (8, 40, 132, 2), (8, 64, 132, 2), (8, 65, 132, 2), (8, 129, 132, 4),
    (1, 0, 132, 1), (2000, 797, 132, 1),
    # an H100 PCIe's 114 SMs take 912 team warps: 114 chains x 8, 115 x 4
    (114, 797, 114, 8), (115, 797, 114, 4), (228, 797, 114, 4),
    (229, 797, 114, 2), (256, 797, 114, 2), (8, 797, 1, 1),
])
def test_glauber_team_from_shapes_alone(chains, max_deg, sms, warps):
    assert mk.chain_glauber_warps(chains, max_deg, sms) == warps
    assert warps in mk.GLAUBER_TEAMS
    assert list(inspect.signature(mk.chain_glauber_warps).parameters) == [
        "chains", "max_deg", "sms"]


@pytest.mark.parametrize("chains,sms,per_block", [
    (1, 132, 1), (8, 132, 1), (132, 132, 1), (133, 132, 2), (256, 132, 2),
    (8192, 132, 63), (132 * 128, 132, 128), (10 ** 6, 132, 128),
    # an H100 PCIe's 114 SMs
    (114, 114, 1), (115, 114, 2), (256, 114, 3), (8192, 114, 72),
])
def test_pivot_blocks_from_shapes_alone(chains, sms, per_block):
    assert mk.chain_pivot_chains(chains, sms) == per_block
    assert list(inspect.signature(mk.chain_pivot_chains).parameters) == [
        "chains", "sms"]


def test_staging_from_shapes_alone_and_the_source_agrees():
    assert list(inspect.signature(mk.chain_staged).parameters) == [
        "num_nodes", "rep"]
    assert mk.chain_staged(4039, "dense") and mk.chain_staged(4039, "csr")
    assert mk.chain_staged(24576, "dense") and not mk.chain_staged(24577,
                                                                  "dense")
    assert mk.chain_staged(12288, "bitset") and not mk.chain_staged(12289,
                                                                   "csr")
    assert not mk.chain_staged(129600, "csr")
    src = (Path(_lib.__file__).parent / "csrc" /
           "motif_kernels.cu").read_text()
    stage = re.search(r"STAGE_BYTES = (\d+) \* (\d+);", src)
    assert int(stage[1]) * int(stage[2]) == mk.STAGE_BYTES
    teams = re.search(r"MAX_TEAM = (\d+);", src)
    assert int(teams[1]) == max(mk.GLAUBER_TEAMS)
    threads = re.search(r"PIVOT_THREADS = (\d+);", src)
    assert int(threads[1]) == mk.PIVOT_THREADS
    for warps in mk.GLAUBER_TEAMS:
        assert f"case {warps}:" in src


def test_chain_key_changes_with_the_block_moves():
    g, B = GRAPHS["csr"], MOTIFS[3]
    emb0 = torch.zeros((16, 3), dtype=torch.int64)
    keys = {tm._chain_key(g, emb0, B, True, M) for M in (1, 5, 6, 46)}
    assert len(keys) == 4
    assert tm._chain_key(g, emb0, B, True, 5) == tm._chain_key(
        g, emb0.clone(), B, True, 5)
    assert list(inspect.signature(tm._chain_key).parameters) == [
        "g", "emb0", "B", "use_glauber", "moves", "backend"]


# ------------------------------------- the kernel's arithmetic, emulated
def f32_index(u, d):
    """csrc/motif_kernels.cu's scaled_index: min(trunc(__fmul_rn(u,
    __ll2float_rn(d))), d - 1)."""
    return min(int(np.trunc(np.float32(u) * np.float32(d))), d - 1)


KEPT_CHUNKS = 64        # csrc/motif_kernels.cu's KEPT_CHUNKS


def popc(m):
    return bin(m).count("1")


def emulate_pick(ok, u, team):
    """csrc/motif_kernels.cu's glauber_pick on one candidate row: ``ok``
    the row's validity (bool, row order), ``u`` the move's uniform; the
    index of the picked candidate, or None where none is valid. The row's
    chunks of 32 are dealt over the ``team`` warps (chunk t to warp
    t % team), each warp's ballots counted and the first KEPT_CHUNKS kept,
    the counts summed; then warp 0 scans the kept ballots' counts 32
    chunks a step for the target-th valid candidate, and past the kept
    chunks takes each chunk's ballot again in row order."""
    d0 = len(ok)
    chunks = -(-d0 // 32)

    def ballot(t):
        return sum(1 << lane for lane in range(32)
                   if 32 * t + lane < d0 and ok[32 * t + lane])

    counts, kept = [0] * team, {}
    for rank in range(team):
        for t in range(rank, chunks, team):
            m = ballot(t)
            if t < KEPT_CHUNKS:
                kept[t] = m
            counts[rank] += popc(m)
    total = sum(counts)
    if total == 0:
        return None
    target = min(int(np.trunc(np.float32(u) * np.float32(total))) + 1,
                 total)

    def nth(m, r):              # the r-th set bit of m, r >= 1
        for _ in range(r - 1):
            m &= m - 1
        return (m & -m).bit_length() - 1

    held, before = min(chunks, KEPT_CHUNKS), 0
    for t0 in range(0, held, 32):
        m = [kept[t0 + lane] if t0 + lane < held else 0
             for lane in range(32)]
        incl = np.cumsum([popc(x) for x in m])
        hit = [lane for lane in range(32) if before + incl[lane] >= target]
        if hit:
            at = hit[0]
            below = int(incl[at]) - popc(m[at])
            return 32 * (t0 + at) + nth(m[at], target - before - below)
        before += int(incl[31])
    for t in range(held, chunks):
        m = ballot(t)
        if before + popc(m) >= target:
            return 32 * t + nth(m, target - before)
        before += popc(m)
    raise AssertionError("not reached: target <= total")


def emulate_block(kind, emb, draws, rows, adj, parents, tbl, team):
    """The kernel's block in numpy float32, in the kernel's order: a
    Glauber chain's M moves one after another, each picked as
    :func:`emulate_pick` picks with ``team`` warps; a walking chain's M
    root steps first, each root into the trail, then every move's tree
    regrown from the root its trail row holds (the last one's also into
    the chains). Draws as numpy (M, ...) arrays; returns the chains and
    the (C, M, k) trail."""
    emb = emb.copy()
    C, k = emb.shape
    M = draws[0].shape[0]
    trail = np.empty((C, M, k), np.int64)
    if kind == "glauber":
        for c in range(C):
            e = emb[c]
            for s in range(M):
                j, u, fb = (d[s, c] for d in draws)
                valid = [m for m in tbl[j] if m >= 0]
                y = fb
                if valid:
                    row = rows[e[valid[0]]]
                    pick = emulate_pick(
                        [all(adj[e[m], v] for m in valid[1:]) for v in row],
                        u, team)
                    y = fb if pick is None else row[pick]
                e[j] = y
                trail[c, s] = e
        return emb, trail
    # 1. the walks, a chain at a time
    for c in range(C):
        x = emb[c, 0]
        for s in range(M):
            if kind in ("walk", "pivot"):
                u_nb, u_acc, jump = (d[s, c] for d in draws[:3])
                dx = len(rows[x])
                y = rows[x][f32_index(u_nb, dx)] if dx else x
                ratio = np.float32(dx) / np.float32(max(len(rows[y]), 1))
                if not np.float32(u_acc) < ratio:
                    y = x
                x = y if dx else jump
            trail[c, s, 0] = x
        emb[c, 0] = x
    # 2. the trees, a (chain, move) pair at a time
    for c in range(C):
        for s in range(M):
            e = np.empty(k, np.int64)
            e[0] = trail[c, s, 0]
            q = 0
            for i, p in enumerate(parents, start=1):
                if p < 0:
                    e[i] = draws[-1][s, q, c]
                    q += 1
                else:
                    r = rows[e[p]]
                    e[i] = (r[f32_index(draws[-2][s, i - 1, c], len(r))]
                            if len(r) else e[p])
            grow = len(parents) if kind == "pivot" else 0
            trail[c, s, 1:] = np.where(np.arange(1, k) <= grow, e[1:],
                                       emb[c, 1:])
        emb[c] = trail[c, M - 1]
    return emb, trail


@pytest.mark.parametrize("kind,k", [("glauber", 3), ("glauber", 21),
                                    ("walk", 1), ("pivot", 3),
                                    ("pivot", 21)])
@pytest.mark.parametrize("rep", sorted(GRAPHS))
def test_float32_emulation_of_the_kernel_over_a_block(rep, kind, k):
    g, B = GRAPHS[rep], MOTIFS[k]
    parents = tm.tree_parents(B)
    n = g.num_nodes
    adj = GRAPHS["dense"].adj.numpy()     # the graphs' own node labels
    rows = [np.flatnonzero(adj[v]) for v in range(n)]     # ascending
    emb0 = start(g, B, C=24)
    ch = tm._new_chains(emb0, kind, STEPS)
    tm._block_draws(ch, gen(3), parents, n, kind)
    tbl = tm._neighbor_table_on(B, "cpu") if kind == "glauber" else None
    team = mk.chain_glauber_warps(24, mk._max_deg(g), 132)
    want_emb, want_trail = emulate_block(
        kind, emb0.numpy(), [d.numpy() for d in ch.draws], rows, adj,
        parents, None if tbl is None else tbl.numpy(), team)
    mk.chain_moves_plain(kind, ch.emb, ch.draws, g, tbl, parents, ch.trail)
    np.testing.assert_array_equal(ch.trail.numpy(), want_trail)
    np.testing.assert_array_equal(ch.emb.numpy(), want_emb)


@pytest.mark.parametrize("d0", [1, 31, 32, 33, 100, 2047, 2048, 2049, 2100,
                                4097])
@pytest.mark.parametrize("team", mk.GLAUBER_TEAMS)
def test_float32_emulation_of_the_kernel_pick_over_a_team(team, d0):
    # the kernel's pick, its row dealt over a team of warps and past the
    # kept chunks, is the target-th valid candidate in row order
    rng = np.random.default_rng(8 * d0 + team)
    us = [0.0, 0.5, float(np.nextafter(np.float32(1), np.float32(0))),
          *rng.random(3)]
    for density in (0.0, 0.002, 0.3, 1.0):
        ok = rng.random(d0) < density
        valid = np.flatnonzero(ok)
        for u in us:
            got = emulate_pick(ok.tolist(), u, team)
            if not len(valid):
                assert got is None
                continue
            target = min(int(np.trunc(np.float32(u)
                                      * np.float32(len(valid)))) + 1,
                         len(valid))
            assert got == valid[target - 1], (u, density)


@pytest.mark.parametrize("kind,k", [("glauber", 3), ("glauber", 21),
                                    ("walk", 1), ("pivot", 21)])
@pytest.mark.parametrize("rep", sorted(GRAPHS))
def test_smoke_chain_bound_reads_each_graph_element_once(rep, kind, k):
    # chip_smoke.py's bound of a block: a graph element that several moves
    # read counts once, so the block's graph bytes lie between its largest
    # move's and the sum of its moves', and within the graph's arrays
    import chip_smoke as cs

    g, B = GRAPHS[rep], MOTIFS[k]
    parents = tm.tree_parents(B)
    emb0 = start(g, B, C=24)
    ch = tm._new_chains(emb0, kind, STEPS)
    tm._block_draws(ch, gen(4), parents, g.num_nodes, kind)
    tbl = tm._neighbor_table_on(B, "cpu") if kind == "glauber" else None

    def graph_bytes(emb, draws):
        ms, by = cs.chain_block_bound(g, kind, emb, draws, tbl, parents)
        assert by == "bytes"
        C, M = emb.shape[0], draws[0].shape[0]
        fixed = (16 * C * k + 8 * C * k * M + 8 * len(parents)
                 + sum(t.numel() * t.element_size() for t in draws)
                 + (0 if tbl is None else 8 * tbl.numel()))
        return round(ms * cs.PEAK_BYTES / 1e3) - fixed

    block = graph_bytes(emb0, ch.draws)
    per_move, e = [], emb0.clone()
    for s in range(STEPS):
        draws = tuple(d[s:s + 1] for d in ch.draws)
        per_move.append(graph_bytes(e, draws))
        mk.chain_moves_plain(kind, e, draws, g, tbl, parents)
    arrays = sum(t.numel() * t.element_size() for t in tm._graph_tensors(g))
    assert 0 < max(per_move) <= block <= min(sum(per_move), arrays)
    assert block < sum(per_move)          # the moves share some reads

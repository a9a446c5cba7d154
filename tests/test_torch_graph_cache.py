"""The one graph cache of the port's replayed loops
(``utils/capture.py::GraphCache``) on the CPU, with an eager stand-in for
the CUDA graph (the first run made as ``capture_step`` makes it, a replay
a call of the step on the graph's own generators). For each of its three
instances (the training step's, the app round's, the chain block's): its
name and size, least-recently-used eviction at its size, a hit that
refills and replays without capturing, the reads it holds or checks, the
generators left where the eager loop leaves them, its counts, and a
failed capture that leaves no entry. Then the training step's and the
chain's captured routes on that stand-in against their eager loops, bit
for bit (the rounds': tests/test_torch_rounds.py). The CUDA graphs
themselves need a card (tests/test_torch_cuda.py)."""

import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch
from test_torch_rounds import eager_capture
from torch.profiler import ProfilerActivity, profile

from onmf_ontf_ndl_tpu_torch.data import graphs as tg
from onmf_ontf_ndl_tpu_torch.models import onmf
from onmf_ontf_ndl_tpu_torch.models.state import init_state
from onmf_ontf_ndl_tpu_torch.samplers import motif as tm
from onmf_ontf_ndl_tpu_torch.utils import capture, profiling

torch.set_num_threads(1)

F64 = torch.float64
CACHES = {"step": onmf._GRAPHS, "round": onmf._ROUND_GRAPHS,
          "chain": tm._CHAIN_GRAPHS}
SIZES = {"step": 4, "round": 8, "chain": 16}
SPANS = {"step": None, "round": "train", "chain": None}


@pytest.fixture
def captures(monkeypatch):
    """``capture_step`` replaced by the eager stand-in of
    tests/test_torch_rounds.py (the step run once from the caller's
    generators, nothing recorded or launched), counting the capture as the
    real one does; returns the caches named in its calls."""
    made = []

    def counted(step, gens, device, cache="step"):
        made.append(cache)
        profiling.count(f"graph.{cache}.captures")
        return eager_capture(step, gens, device, cache)

    monkeypatch.setattr(capture, "capture_step", counted)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return made


@pytest.fixture(params=sorted(CACHES))
def cache(request):
    """An empty cache like one of the three instances."""
    c = CACHES[request.param]
    return capture.GraphCache(c.name, c.size, c.spans)


def _gens(cache, seed):
    """The generators a step of ``cache`` draws from: a round may draw
    from two (the steps' and its own), the others from one."""
    return tuple(torch.Generator().manual_seed(seed + i)
                 for i in range(2 if cache.name == "round" else 1))


def _toy(cache, x0, key="k", times=5, gens=None, each=None, **kw):
    """``times`` runs of a step that adds one uniform of each generator
    to the buffer ``x`` and counts its runs, through ``cache``; returns
    the buffers and which of ``new`` and ``fill`` were called."""
    called = []

    def new():
        called.append("new")
        return {"x": x0.clone(), "runs": 0}

    def fill(buf):
        called.append("fill")
        buf["x"].copy_(x0)

    def step(buf, *gs):
        for g in gs:
            buf["x"] += torch.rand(x0.shape, generator=g, dtype=x0.dtype)
        buf["runs"] += 1

    buf = cache.run(key, torch.device("cpu"), gens or _gens(cache, 1),
                    times, new, fill, step, each=each, **kw)
    return buf, called


def _eager(x0, times, gens):
    x = x0.clone()
    for _ in range(times):
        for g in gens:
            x += torch.rand(x0.shape, generator=g, dtype=x0.dtype)
    return x


@pytest.mark.parametrize("name", sorted(CACHES))
def test_the_three_instances_keep_their_names_and_sizes(name):
    c = CACHES[name]
    assert isinstance(c, capture.GraphCache)
    assert (c.name, c.size, c.spans) == (name, SIZES[name], SPANS[name])


def test_a_run_equals_the_eager_loop_and_a_hit_replays_only(cache,
                                                            captures):
    x0 = torch.rand(6, dtype=F64)
    for call, times in enumerate((5, 3, 1)):
        gens, twins = _gens(cache, 10 + call), _gens(cache, 10 + call)
        seen = []
        buf, called = _toy(cache, x0, times=times, gens=gens,
                           each=lambda b, i: seen.append((b["runs"], i)))
        assert torch.equal(buf["x"], _eager(x0, times, twins))
        for g, twin in zip(gens, twins):     # left where the loop leaves it
            assert torch.equal(g.get_state(), twin.get_state())
        # a miss makes the buffers and captures; a hit refills them
        assert called == (["new"] if call == 0 else ["fill"])
        assert captures == [cache.name]
        # each run of the call followed by each(buffers, i), in order
        first = buf["runs"] - times + 1
        assert seen == [(first + i, i) for i in range(times)]
    entry = cache["k"]
    assert entry.buffers is buf and entry.replays == 4 + 3 + 1
    assert len(cache) == 1


def test_the_least_recently_used_goes_first_at_its_size(cache, captures):
    x0 = torch.zeros(2)
    for key in range(cache.size):
        _toy(cache, x0, key=key, times=1)
    _toy(cache, x0, key=0, times=1)             # a hit: now the newest
    assert list(cache) == list(range(1, cache.size)) + [0]
    _toy(cache, x0, key="new", times=1)
    assert len(cache) == cache.size
    assert list(cache) == list(range(2, cache.size)) + [0, "new"]
    assert len(captures) == cache.size + 1


def test_held_reads_live_and_unheld_reads_are_checked(cache, captures):
    x0 = torch.zeros(3)
    t = torch.rand(4)
    held = weakref.ref(t)
    _toy(cache, x0, key="held", reads=(t,))
    assert cache["held"].reads[0] is t
    del t
    gc.collect()
    assert held() is not None           # the entry keeps what it reads
    # not held: the entry keeps the address, not the caller's tensor; a
    # read at the same place is a hit
    X1 = torch.rand(5)
    _toy(cache, x0, key="placed", reads=(X1,), hold=False)
    entry = cache["placed"]
    assert entry.reads == (capture.tensor_at(X1),)
    _, called = _toy(cache, x0, key="placed", reads=(X1,), hold=False)
    assert called == ["fill"] and cache["placed"] is entry
    gone = weakref.ref(X1)
    del X1
    gc.collect()
    assert gone() is None
    # one that has moved is captured anew under the same key, in place of
    # the old entry
    X2 = torch.rand(6)
    _, called = _toy(cache, x0, key="placed", reads=(X2,), hold=False)
    assert called == ["new"] and cache["placed"] is not entry
    assert cache["placed"].reads == (capture.tensor_at(X2),)
    assert len(cache) == 2 and len(captures) == 3


def test_captures_and_replays_are_counted_by_name(cache, captures):
    x0 = torch.zeros(2)
    with profile(activities=[ProfilerActivity.CPU]):
        _toy(cache, x0, times=4)
        _toy(cache, x0, times=3)
        counts = profiling.counters()
    name = cache.name
    assert counts[f"graph.{name}.captures"] == 1
    assert counts[f"graph.{name}.replays"] == 3 + 3
    assert cache["k"].replays == 6
    spans = [s.name for s in profiling.spans()]
    if cache.spans is None:
        assert spans == []
    else:
        assert spans == [f"{cache.spans}.capture", f"{cache.spans}.replay",
                         f"{cache.spans}.replay"]


def test_a_failing_capture_raises_and_leaves_no_entry(cache, captures):
    x0 = torch.zeros(2)
    _toy(cache, x0, key="kept", times=2)

    def failing(buf, *gs):
        raise RuntimeError("refused while capturing")

    with pytest.raises(RuntimeError, match="refused while capturing"):
        cache.run("k", torch.device("cpu"), _gens(cache, 1), 3,
                  lambda: {}, lambda buf: None, failing)
    assert list(cache) == ["kept"]


# ------------------------------------ the captured routes on the stand-in

@pytest.fixture
def captured_routes(monkeypatch, captures):
    """The step's and the chain's captured routes on the CPU, on empty
    caches; ``capture=False`` still asks for the eager loops."""
    monkeypatch.setattr(onmf, "_train_route",
                        lambda *a: "captured" if a[5] else "eager")
    monkeypatch.setattr(tm, "_chain_route",
                        lambda device_type, capture=True:
                        "captured" if capture else "eager")
    for mod, name in ((onmf, "_GRAPHS"), (tm, "_CHAIN_GRAPHS")):
        c = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            capture.GraphCache(c.name, c.size, c.spans))
    return captures


STEP_CASES = {
    "iid_code_metrics": dict(subsample=True, sampling="iid",
                             track_code=True, track_metrics=True),
    "block": dict(subsample=True, sampling="block", track_code=True),
    "full_batch": dict(subsample=False, track_code=False),
    "given_draws": dict(subsample=True, track_code=True, draws=True),
}


def _train(X, seed, capture_, case, iterations=6):
    kw = dict(STEP_CASES[case])
    draws = None
    if kw.pop("draws", False):
        rng = np.random.default_rng(seed)
        draws = [(rng.integers(0, X.shape[1], 8), rng.random((4, 8)))
                 for _ in range(iterations - 1)]
    st = init_state(seed, X.shape[0], 4, device="cpu", dtype=F64)
    code = torch.zeros((4, X.shape[1]), dtype=F64)
    return onmf._train_loop(
        st, X, code, 0.1, 0.9, 0.01, iterations, 8, kw.pop("subsample"), 10,
        kw.pop("track_code"), "stale", backend="torch", draws=draws,
        capture=capture_, **kw)


def _assert_trained_equal(got, want):
    (s1, c1, m1), (s0, c0, m0) = got, want
    for f in "WABC":
        assert torch.equal(getattr(s1, f), getattr(s0, f)), f
    assert s1.t == s0.t
    assert torch.equal(c1, c0) and torch.equal(m1, m0)
    assert torch.equal(s1.gen.get_state(), s0.gen.get_state())


@pytest.mark.parametrize("own", [True, False])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_captured_training_route_equals_the_eager_loop(case, own,
                                                       captured_routes,
                                                       monkeypatch):
    """A capture, a hit and, for an X read in place, an X that has moved
    (captured anew in place of the old entry); the hit's outputs are its
    own copies, not the graph's buffers."""
    if not own:
        monkeypatch.setattr(onmf, "_OWN_X_BYTES", 0)
    X = torch.rand((12, 40), dtype=F64)
    first = _train(X, 1, True, case)
    _assert_trained_equal(first, _train(X, 1, False, case))
    assert len(onmf._GRAPHS) == 1
    entry = next(iter(onmf._GRAPHS.values()))
    assert entry.buffers.owns_x is own
    assert (entry.buffers.X is None) is not own
    assert entry.reads == (() if own else (capture.tensor_at(X),))
    _assert_trained_equal(_train(X, 2, True, case),
                          _train(X, 2, False, case))
    assert next(iter(onmf._GRAPHS.values())) is entry
    assert entry.replays == 2 * 5 - 1
    assert first[0].W.data_ptr() != entry.buffers.W.data_ptr()
    X2 = X.clone()
    _assert_trained_equal(_train(X2, 3, True, case),
                          _train(X2, 3, False, case))
    assert len(onmf._GRAPHS) == 1
    assert (next(iter(onmf._GRAPHS.values())) is entry) is own
    assert captured_routes == ["step"] * (1 if own else 2)


EDGES = np.array([[i, (i + 1) % 30] for i in range(30)]
                 + [[i, (i + 7) % 30] for i in range(0, 30, 3)])


@pytest.mark.parametrize("use_glauber", [True, False],
                         ids=["glauber", "pivot"])
def test_captured_chains_equal_the_eager_loop(use_glauber, captured_routes,
                                              monkeypatch):
    """Blocks of 7 moves and a rest of 2: both captured, replayed for
    every block, each block's trail in its place; a second run hits
    both; the chains and the generator as the eager loop leaves them."""
    g, B, k, C = tg.csr_graph_from_edges(EDGES, device="cpu"), \
        tm.path_adj(0, 2), 3, 16
    kind = tm._chain_kind(use_glauber, k)
    draw = {"glauber": 20, "pivot": 16 + 4 * (k - 1)}[kind]
    monkeypatch.setattr(tm, "_BLOCK_BYTES", 7 * C * (draw + 8 * k))
    assert tm._chain_blocks(30, tm._chain_block_moves(C, k, kind, 30)) \
        == [(7, 4), (2, 1)]
    for seed in (1, 2):
        emb0 = tm.tree_sample(torch.Generator().manual_seed(seed),
                              tm.tree_parents(B), g, torch.arange(C))
        out = {}
        for capture_ in (True, False):
            gen = torch.Generator().manual_seed(seed + 10)
            out[capture_] = (tm.run_chains(gen, g, emb0, B, 30,
                                           use_glauber=use_glauber,
                                           capture=capture_),
                             torch.rand(8, generator=gen))
        assert torch.equal(out[True][0], out[False][0])
        assert torch.equal(out[True][1], out[False][1])
    assert captured_routes == ["chain", "chain"]
    assert [e.replays for e in tm._CHAIN_GRAPHS.values()] == [2 * 4 - 1,
                                                              2 * 1 - 1]

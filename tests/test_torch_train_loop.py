"""The training loop's step function on static buffers (run eagerly on the
CPU in float64) against the JAX ``_train_scan`` through ``draws=``, for
every case that a captured graph's key tells apart; block and iid
sampling from the generator against the one-step loop of ``_step_inner``
on the same stream; and the pure functions of the captured route: the
route, the graph cache key and the launch bookkeeping (the step's
weight table is the one-round case of tests/test_torch_rounds.py's). Tolerance against JAX: rtol 1e-8 (float64, the same
operations up to BLAS sums); FISTA rtol 1e-6 / atol 1e-7, as
tests/test_torch_fista.py holds it (its step 1 / L comes from float32
power steps, which the frameworks sum in another order: one float32 ulp).
The generator runs are compared exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu.models import onmf as jonmf
from onmf_ontf_ndl_tpu_torch.models import onmf as tonmf
from onmf_ontf_ndl_tpu_torch.models.state import init_state
from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib
from test_torch_onmf import assert_state_close, make_states, replay_draws

torch.set_num_threads(1)

RNG = np.random.default_rng(41)
F64 = torch.float64

# one case per value of each argument the key bakes in, from a base of
# iid minibatches, the early stop, bcd, stale, code and metrics tracked
BASE = dict(subsample=True, n=40, batch=12, stop=0.01, coder="bcd",
            dict_from="stale", track_xxt=False, track_code=True,
            metrics=True, alpha=0.3, sub_iter=10)
CASES = {
    "iid_stop": {},
    "full_batch": dict(subsample=False, n=30, batch=0),
    "fixed": dict(stop=None),
    "fista_fixed": dict(coder="fista", stop=None),
    "fista_stop": dict(coder="fista"),
    "fresh": dict(dict_from="fresh"),
    "tracks_xxt": dict(track_xxt=True),
    "no_code": dict(track_code=False),
    "no_metrics": dict(metrics=False),
    "duplicate_indices": dict(n=10, batch=25, stop=None),
    "alpha_zero_sub_iter_5": dict(alpha=0.0, sub_iter=5),
    "full_batch_fixed_xxt_fresh": dict(subsample=False, n=30, batch=0,
                                       stop=None, track_xxt=True,
                                       dict_from="fresh"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_function_matches_jax_train_scan(case):
    c = {**BASE, **CASES[case]}
    d, r, iterations = 30, 6, 6
    warm = dict(C=RNG.random((d, d))) if c["track_xxt"] else {}
    js, ts = make_states(d=d, r=r, seed=11, track_xxt=c["track_xxt"], **warm)
    X = RNG.random((d, c["n"]))
    draws = replay_draws(js.key, c["n"], r, iterations, c["batch"],
                         c["subsample"])
    kw = dict(iterations=iterations, batch_size=c["batch"],
              subsample=c["subsample"], alpha=c["alpha"], beta=0.8,
              sub_iter=c["sub_iter"], stopping_diff=c["stop"],
              dict_from=c["dict_from"], coder=c["coder"],
              track_code=c["track_code"], return_metrics=c["metrics"])
    jout = jonmf.train_dict(js, jnp.asarray(X), **kw)
    code0 = torch.zeros((r, c["n"]), dtype=F64)
    before = [getattr(ts, f).clone() for f in "WABC"]
    ts1, tcode, tmet = tonmf._train_loop(
        ts, torch.from_numpy(X), code0, c["alpha"], 0.8, c["stop"],
        iterations, c["batch"], c["subsample"], c["sub_iter"],
        c["track_code"], c["dict_from"], backend="torch",
        track_metrics=c["metrics"], draws=draws, coder=c["coder"])
    tol = dict(rtol=1e-6, atol=1e-7) if c["coder"] == "fista" \
        else dict(rtol=1e-8, atol=1e-12)
    assert_state_close(ts1, jout[0], **tol)
    np.testing.assert_allclose(tcode.numpy(), np.asarray(jout[1]), **tol)
    if c["metrics"]:
        np.testing.assert_allclose(tmet.numpy(), np.asarray(jout[2]),
                                   rtol=tol["rtol"])
    else:
        assert tmet.shape == (0,)
    # the caller's code and state are not written
    assert (code0 == 0).all()
    assert all(torch.equal(getattr(ts, f), v) for f, v in zip("WABC", before))


def one_step_loop(state, X, iterations, batch, sampling, stop, coder):
    """Training as a loop of ``_step_inner`` single steps, drawing from
    ``state.gen`` in the training loop's order: the pool permutation once
    (block), then per step the batch (randint) and H0 (rand)."""
    gen, n = state.gen, X.shape[1]
    code = torch.zeros((state.r, n), dtype=X.dtype)
    if sampling == "block":
        perm = torch.randperm(n, generator=gen)
    st, t0 = state, state.t
    for i in range(1, iterations):
        if sampling == "block":
            off = torch.randint(0, n, (1,), generator=gen)
            idx = perm[(off + torch.arange(batch)) % n]
        else:
            idx = torch.randint(0, n, (batch,), generator=gen)
        Xb = X.index_select(1, idx)
        H0 = torch.rand((st.r, batch), generator=gen, dtype=X.dtype)
        st, H = tonmf._step_inner(st, Xb, t0 + i, H0, 0.2, 0.9, 10, stop,
                                  "stale", "torch", coder=coder)
        code.index_add_(1, idx, H)
    return dataclasses.replace(st, t=t0 + float(iterations)), code


@pytest.mark.parametrize("sampling", ["iid", "block"])
@pytest.mark.parametrize("coder,stop", [("bcd", None), ("bcd", 0.01),
                                        ("fista", None)])
def test_drawn_steps_match_the_one_step_loop(sampling, coder, stop):
    d, r, n, batch, iterations = 20, 5, 37, 16, 6
    X = torch.from_numpy(RNG.random((d, n)))
    W = RNG.random((d, r))
    want = one_step_loop(init_state(4, d, r, device="cpu", dtype=F64, W=W,
                                    t=2.0), X, iterations, batch, sampling,
                         stop, coder)
    st = init_state(4, d, r, device="cpu", dtype=F64, W=W, t=2.0)
    got = tonmf._train_loop(st, X, torch.zeros((r, n), dtype=F64), 0.2, 0.9,
                            stop, iterations, batch, True, 10, True, "stale",
                            backend="torch", sampling=sampling, coder=coder)
    for f in ("W", "A", "B", "C"):
        torch.testing.assert_close(getattr(got[0], f), getattr(want[0], f),
                                   rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert got[0].t == want[0].t == 8.0
    # the generator stands where the one-step loop leaves it
    torch.testing.assert_close(torch.rand(4, generator=got[0].gen),
                               torch.rand(4, generator=want[0].gen),
                               rtol=0, atol=0)


def test_draws_must_stack():
    _, ts = make_states(d=12, r=3)
    X = torch.from_numpy(RNG.random((12, 9)))
    H0 = torch.from_numpy(RNG.random((3, 4)))
    run = dict(alpha=0.0, beta=1.0, stopping_diff=None, iterations=3,
               batch_size=4, subsample=True, sub_iter=5, track_code=False,
               dict_from="stale")
    with pytest.raises(ValueError, match="every step's indices"):
        tonmf._train_loop(ts, X, None, *run.values(), draws=[
            (torch.arange(4), H0), (None, H0)])
    with pytest.raises(ValueError, match="1 given for 2 steps"):
        tonmf._train_loop(ts, X, None, *run.values(),
                          draws=[(torch.arange(4), H0)])


@pytest.mark.parametrize("args,route", [
    (("cuda", "cuda", None, 25, False), "captured"),
    (("cuda", "cuda", "nccl", 25, False), "captured"),
    (("cuda", "cuda", None, 1248, False), "captured"),
    (("cpu", "torch", None, 25, False), "eager"),
    (("cpu", "torch", "gloo", 25, False), "eager"),
    (("cuda", "cuda", "gloo", 25, False), "eager"),
    (("cuda", "cuda", None, 25, True), "eager"),     # debug_nans
    (("cuda", "torch", None, 25, False), "eager"),   # plain maths on card
    (("cuda", "cuda", None, 1249, False), "eager"),  # past MAX_RANK
])
def test_train_route(args, route):
    assert tonmf._train_route(*args) == route
    assert tonmf._train_route(*args, capture=False) == "eager"
    # past MAX_RANK the coder wrappers run the plain maths, whose early
    # stop reads its test on the host: no capture can hold that
    from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck

    assert ck.kernel_route("coder_sweeps_earlystop", args[3]) == (
        "unfused" if args[3] > ck.MAX_RANK else
        "shared" if args[3] <= ck.SMEM_MAX_RANK["coder_sweeps_earlystop"]
        else "workspace")


SPEC = tonmf._StepSpec(batch=16, steps=8, alpha=0.1, sub_iter=10,
                       stopping_diff=0.01, dict_from="stale", backend="cuda",
                       coder="bcd", draws=None, subsample=True,
                       sampling="iid", track_code=True, track_metrics=False)
# another value for each field of the spec
BAKED = dict(batch=17, steps=9, alpha=0.2, sub_iter=11,
             stopping_diff=None,
             dict_from="fresh", backend="torch", coder="fista", draws="idx",
             subsample=False, sampling="block", track_code=False,
             track_metrics=True, group=object(), tp=object(), cols=(0, 128))


def test_graph_key_changes_with_each_baked_argument_only():
    X = torch.rand((30, 40), dtype=F64)
    st = init_state(0, 30, 6, device="cpu", dtype=F64)
    key = tonmf._graph_key(X, st, SPEC)
    # new values of X and of the state, and another beta or t: same key
    other = init_state(1, 30, 6, device="cpu", dtype=F64, t=7.0)
    assert tonmf._graph_key(torch.rand((30, 40), dtype=F64), other,
                            SPEC) == key
    hash(key)
    assert set(BAKED) == {f.name for f in dataclasses.fields(SPEC)}
    keys = {key}
    for name, value in BAKED.items():
        keys.add(tonmf._graph_key(X, st, dataclasses.replace(
            SPEC, **{name: value})))
    for X2, st2 in (
            (torch.rand((30, 40), dtype=torch.float32), st),      # dtype
            (torch.rand((30, 41), dtype=F64), st),                # n
            (torch.rand((40, 30), dtype=F64).T, st),              # strides
            (torch.rand((30, 40), dtype=F64, device="meta"), st),  # device
            (X, init_state(0, 30, 7, device="cpu", dtype=F64)),   # r
            (X, init_state(0, 30, 6, device="cpu", dtype=F64,
                           track_xxt=True)),
            (X, init_state(0, 30, 6, device="cpu",
                           dtype=torch.float32))):                # W dtype
        keys.add(tonmf._graph_key(X2, st2, SPEC))
    assert len(keys) == 1 + len(BAKED) + 7


def test_launch_bookkeeping(monkeypatch):
    monkeypatch.setattr(_lib, "LAUNCHES", {"a": 3, "b": 0, "c": 1})
    before = _lib.launch_counts()
    _lib.LAUNCHES["a"] += 2               # a capture's wrapper calls
    _lib.LAUNCHES["b"] += 1
    per_replay = _lib.captured_launches(before)
    assert per_replay == {"a": 2, "b": 1, "c": 0}
    assert _lib.LAUNCHES == {"a": 3, "b": 0, "c": 1}   # it launched none
    _lib.add_launches(per_replay, 4)
    assert _lib.LAUNCHES == {"a": 11, "b": 4, "c": 1}
    _lib.add_launches(per_replay, 0)
    assert _lib.LAUNCHES == {"a": 11, "b": 4, "c": 1}
    before["a"] = 0
    assert _lib.launch_counts()["a"] == 11      # a copy, not the counts


def test_device_run_counts_follow_the_kernel_source():
    """The kinds of the kernels' own counts (``count_run``, then the early
    stop's ``count_sweeps`` and ``count_columns``, then the early-stop
    coder's cluster form's ``count_cluster_columns``, then the dictionary
    update's ``count_dict``, then FISTA's ``count_sweeps`` and
    ``count_columns`` into slots of its own) are ``_lib.DEVICE_COUNTS`` in
    order, the runs ``_lib.RUN_KERNELS``, each with a launch count; with
    no library loaded, a reset touches no device."""
    import re
    from pathlib import Path

    src = (Path(_lib.__file__).parent / "csrc" / "onmf_kernels.cu").read_text()
    kinds = [k.strip() for k in re.search(r"enum \{([^}]*)\}", src)[1]
             .split(",")]
    assert kinds == ["RUN_CODER", "RUN_CODER_ES", "RUN_FISTA", "RUN_DICT",
                     "ES_COLUMN_SWEEPS", "ES_COLUMNS", "ES_CLUSTER_COLUMNS",
                     "DICT_COLUMNS", "DICT_PANEL_UPDATES",
                     "FISTA_COLUMN_ITERS", "FISTA_COLUMNS", "RUN_KINDS"]
    assert _lib.RUN_KERNELS == ("coder_sweeps", "coder_sweeps_earlystop",
                                "fista_sweeps", "dict_update_sweep",
                                "chain_move")
    assert _lib.DEVICE_COUNTS == _lib.RUN_KERNELS[:4] + (
        "coder_es.column_sweeps", "coder_es.columns",
        "coder_es.cluster_columns", "dict.columns", "dict.panel_updates",
        "fista.column_iters", "fista.columns", "chain_move")
    assert set(_lib.RUN_KERNELS) <= set(_lib.LAUNCHES)
    # every main kernel counts one kind; no other kernel counts
    counted = re.findall(r"count_run\(([^)]*)\);", src)
    assert sorted(counted) == sorted([
        "RUN_CODER_ES", "RUN_CODER", "RUN_FISTA", "RUN_FISTA",
        "kStop ? RUN_CODER_ES : RUN_CODER", "RUN_DICT", "RUN_DICT"])
    # the two Gauss-Seidel kernels that stop early (shared and wide, with
    # the stop) count their columns once a launch and each tile's sweeps as
    # it leaves its sweep loop: the shared coder in each of its forms (a
    # CTA a tile; a cluster, whose rank 0 also counts the tile's columns as
    # the cluster form's); FISTA's two kernels count the same in both
    # modes into slots of their own
    assert len(re.findall(r"count_columns\(ES_COLUMNS, n\);", src)) == 2
    assert len(re.findall(r"count_sweeps\(ES_COLUMN_SWEEPS, swept, ",
                          src)) == 3
    assert re.findall(r"(if[^;]*)?count_columns\(FISTA_COLUMNS, n\);",
                      src) == ["", ""]
    assert re.findall(r"(if[^;]*)?count_sweeps\(FISTA_COLUMN_ITERS, swept, ",
                      src) == ["", ""]
    assert len(re.findall(r"count_cluster_columns\(tile0, n\);", src)) == 1
    # both dictionary kernels count their columns, the panel form also its
    # rank-k updates of G, once a launch
    assert sorted(re.findall(r"count_dict\((r, [^;]*)\);", src)) == [
        "r, (r - 1) / K", "r, 0"]
    # the chain's move: its source's own counter, in both of its kernels
    chain = (Path(_lib.__file__).parent / "csrc" /
             "motif_kernels.cu").read_text()
    assert "count_run(" not in chain
    assert chain.count("count_chain_run();") == 2
    if not _lib.build.cache_info().currsize:
        _lib.reset_launches()
        assert not torch.cuda.is_initialized()


def test_debug_nans_runs_eager_and_names_the_step():
    from onmf_ontf_ndl_tpu_torch.utils.debug import debug_nans

    st = init_state(0, 10, 3, device="cpu", dtype=F64)
    X = torch.rand((10, 8), dtype=F64)
    X[0, 0] = float("nan")
    with debug_nans():
        with pytest.raises(FloatingPointError, match="t=1"):
            tonmf._train_loop(st, X, None, 0.0, 1.0, None, 4, 8, False, 5,
                              False, "stale", backend="torch")
    assert tonmf._train_route("cuda", "cuda", None, 3, tonmf._DEBUG_NANS) \
        == "captured"


def _sharded(st, tp: int, j: int):
    """Rank j's shard of ``st`` over a tp axis of ``tp`` ranks (W's
    columns, B's rows), as parallel/auto.py::shard_state keeps it."""
    r_l = st.r // tp
    return dataclasses.replace(st, W=st.W[:, j * r_l:(j + 1) * r_l],
                               B=st.B[j * r_l:(j + 1) * r_l])


def test_graph_key_tells_tp_groups_and_shards_apart():
    X = torch.rand((30, 40), dtype=F64)
    st = init_state(0, 30, 6, device="cpu", dtype=F64)
    g1, g2 = object(), object()
    spec = dataclasses.replace(SPEC, group=g1, tp=g2, cols=(0, 128))
    key = tonmf._graph_key(X, _sharded(st, 2, 0), spec)
    # the other shard, and new values: the same key
    other = init_state(1, 30, 6, device="cpu", dtype=F64, t=3.0)
    assert tonmf._graph_key(X, _sharded(other, 2, 1), spec) == key
    keys = {key,
            # the tp group, the dp group, this rank's columns of the batch
            tonmf._graph_key(X, _sharded(st, 2, 0),
                             dataclasses.replace(spec, tp=object())),
            tonmf._graph_key(X, _sharded(st, 2, 0),
                             dataclasses.replace(spec, group=object())),
            tonmf._graph_key(X, _sharded(st, 2, 0),
                             dataclasses.replace(spec, cols=(128, 200))),
            # the shard's shape: 3 of 6 columns, 2 of 6, 3 of 3, 6 of 6
            tonmf._graph_key(X, _sharded(st, 3, 0), spec),
            tonmf._graph_key(X, init_state(0, 30, 3, device="cpu",
                                           dtype=F64), spec),
            tonmf._graph_key(X, st, spec)}
    assert len(keys) == 7


@pytest.mark.parametrize("batch", [1, 127, 128, 129, 16384])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_batch_cols_deal_whole_tiles(batch, world):
    cols = tonmf.batch_cols(batch, world)
    assert len(cols) == world
    assert cols[0][0] == 0 and cols[-1][1] == batch
    assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    tn = _lib.TN
    assert all(lo % tn == 0 and lo <= hi for lo, hi in cols)
    # every rank but the last holds whole tiles, the last takes the rest
    assert all((hi - lo) % tn == 0 for lo, hi in cols[:-1])
    tiles = [-(-(hi - lo) // tn) for lo, hi in cols]
    assert sum(tiles) == -(-batch // tn)
    assert max(tiles) - min(tiles) <= 1
    if world == 1:
        assert cols == [(0, batch)]


@pytest.fixture
def one_rank_gloo(tmp_path):
    """A one-rank gloo process group in this process."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("stop", [None, 0.01])
@pytest.mark.parametrize("subsample", [True, False])
def test_one_rank_tp_and_dp_groups_route_eager_and_run_train_dict(
        one_rank_gloo, monkeypatch, stop, subsample):
    # a gloo group among the step's groups routes eager; with one rank in
    # each the step makes the one-process step's products on its shapes:
    # equal to train_dict bit for bit, the code and objectives too
    routes = []
    route = tonmf._train_route

    def spy(*args, **kw):
        routes.append(args)
        return route(*args, **kw)

    monkeypatch.setattr(tonmf, "_train_route", spy)
    d, r, n = 20, 4, 37
    X = torch.from_numpy(RNG.random((d, n)))
    kw = dict(iterations=5, batch_size=16, subsample=subsample,
              stopping_diff=stop, alpha=0.2, beta=0.9, return_metrics=True)
    want = tonmf.train_dict(init_state(5, d, r, device="cpu", dtype=F64), X,
                            **kw)
    st = init_state(5, d, r, device="cpu", dtype=F64)
    got = tonmf._train_loop(
        st, X, torch.zeros((r, n), dtype=F64), 0.2, 0.9, stop, 5, 16,
        subsample, 10, True, "stale", backend="torch", track_metrics=True,
        group=one_rank_gloo, tp=one_rank_gloo, global_batch=True)
    assert [a[2] for a in routes] == [None, "gloo"]
    assert routes[1][3] == r
    for f in "WABC":
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[0].t == want[0].t == 5.0

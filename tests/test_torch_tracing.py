"""The port's own trace record (``utils/profiling.py``) on the CPU: nothing
is recorded without a profiler session; under one, the training call's
and the reconstruction job's spans nest under their call with its id, a
span holds the profiler's own event of the work inside it (one clock),
a new session starts a fresh record, and ``trace`` writes the spans into
its Chrome trace. Also the host counts of graph captures and replays,
which ``utils/capture.py`` keeps by cache."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from onmf_ontf_ndl_tpu_torch.apps.image import ImageReconstructor
from onmf_ontf_ndl_tpu_torch.apps.ising import IsingReconstructor
from onmf_ontf_ndl_tpu_torch.apps.network import NetworkReconstructor
from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import LAUNCHES
from onmf_ontf_ndl_tpu_torch.utils import capture, profiling

torch.set_num_threads(1)


def _image_app():
    img = torch.rand((24, 20, 3), generator=torch.Generator().manual_seed(3))
    rec = ImageReconstructor(
        data=img, n_components=4, iterations=3, sub_iterations=3,
        num_patches=30, batch_size=30, patch_size=4, is_color=True,
        device="cpu")
    return rec, img


def _network_app():
    rng = np.random.default_rng(5)
    A = rng.random((30, 30)) < 0.15
    A = np.triu(A, 1)
    A = (A | A.T).astype(np.float64)
    for i in range(30):            # a ring, so that every node has a walk
        A[i, (i + 1) % 30] = A[(i + 1) % 30, i] = 1.0
    return NetworkReconstructor(
        adjacency=A, n_components=3, MCMC_iterations=2, sub_iterations=3,
        sample_size=12, batch_size=12, k1=0, k2=2, num_chains=2,
        device="cpu")


def _empty_record(tmp_path):
    """A session with no span in it: the record is fresh and empty."""
    with profiling.trace(str(tmp_path / "empty")):
        pass
    assert profiling.spans() == [] and profiling.counters() == {}


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_records_nothing(tmp_path):
    _empty_record(tmp_path)
    rec, img = _image_app()
    rec.train_dict()
    rec.reconstruct_image_color(data=img, recons_resolution=2)
    net = _network_app()
    net.train_dict()
    net.reconstruct_network(recons_iter=40, sparse=False)
    assert profiling.spans() == [] and profiling.counters() == {}


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def _check_nesting(spans):
    """Each span lies inside its parent and carries its call's id."""
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is None:
            continue
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert s.call == p.call


def test_training_spans_nest_under_their_call():
    rec, _ = _image_app()
    with _profiled():
        rec.train_dict()
        rec.train_dict()
    spans = profiling.spans()
    _check_nesting(spans)
    calls = [i for i, s in enumerate(spans) if s.name == "train.call"]
    assert len(calls) == 2
    assert [spans[i].call for i in calls] == [1, 2]
    for i in calls:
        assert spans[i].parent is None
        # the CPU takes the per-round route: a fill, a span a round, the
        # state out
        assert _children(spans, i) == ["train.fill", "train.round",
                                       "train.round", "train.round",
                                       "train.copy_out"]
    # every span belongs to a call; the CPU has no device time to take
    assert all(s.call in (1, 2) for s in spans)
    assert all(s.device_ms is None for s in spans)


def test_reconstruction_spans_nest_under_their_job():
    rec, img = _image_app()
    net = _network_app()
    with _profiled():
        rec.reconstruct_image_color(data=img, recons_resolution=2)
        net.reconstruct_network(recons_iter=40, sparse=False)
    spans = profiling.spans()
    _check_nesting(spans)
    jobs = [i for i, s in enumerate(spans) if s.name == "recon.job"]
    assert [spans[i].call for i in jobs] == [1, 2]
    assert _children(spans, jobs[0]) == ["recon.extract", "recon.code",
                                         "recon.paint"]
    assert _children(spans, jobs[1]) == ["recon.chains", "recon.patches",
                                         "recon.code", "recon.paint",
                                         "recon.group"]
    # a call's counts on the CPU: the host's launch counts alone
    counts = spans[jobs[0]].counts
    assert set(counts) == {f"launches.{k}" for k in LAUNCHES}
    assert set(counts.values()) == {0}


def test_network_training_call_holds_its_rounds():
    net = _network_app()
    with _profiled():
        net.train_dict()
    spans = profiling.spans()
    _check_nesting(spans)
    assert [s.name for s in spans if s.parent is None] == ["train.call"]
    assert _children(spans, 0) == ["train.fill", "train.round",
                                   "train.round", "train.copy_out"]


def _ising_app():
    # 12 x 12 lattice, 288 steps: two sweeps a round
    return IsingReconstructor(
        n_components=3, lattice_size=12, ising_iterations=2,
        temperature=2.0, ising_subsampling_steps=288, sub_iterations=3,
        num_patches=10, batch_size=10, patch_size=3, seed=4, device="cpu")


def test_ising_call_records_its_initial_round_and_site_updates(tmp_path):
    _empty_record(tmp_path)
    rec = _ising_app()
    rec.ising_mcmc_learning()                   # outside a session
    assert profiling.spans() == [] and profiling.counters() == {}
    with _profiled():
        rec.ising_mcmc_learning()
    spans = profiling.spans()
    _check_nesting(spans)
    initial = [s for s in spans if s.name == "ising.initial"]
    assert len(initial) == 1 and initial[0].call == 1
    assert spans[initial[0].parent].name == "train.call"
    # the initial round on the per-round route, inside its span
    inside = [s.name for s in spans if s.parent == spans.index(initial[0])]
    assert inside == ["train.fill", "train.round", "train.copy_out"]
    # 2 rounds x 2 sweeps x 12^2 sites; the initial round advances nothing
    assert profiling.counters()["ising.site_updates"] == 2 * 2 * 144


def test_span_holds_the_profilers_event_of_its_work():
    """One clock: the span around a matmul starts before the profiler's
    ``aten::mm`` host event and ends after it, every time."""
    a = torch.rand((400, 400))
    with _profiled() as prof:
        for _ in range(5):
            with profiling.span("probe"):
                a @ a
    mms = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    probes = [s for s in profiling.spans() if s.name == "probe"]
    assert len(mms) == len(probes) == 5
    for (s, e), p in zip(mms, probes):
        assert p.start_ns <= s and e <= p.end_ns, (p, s, e)


def test_new_session_starts_a_fresh_record():
    rec, img = _image_app()
    with _profiled():
        rec.train_dict()
    assert {s.name for s in profiling.spans()} >= {"train.call"}
    rec.reconstruct_image_color(data=img, recons_resolution=2)   # off
    with _profiled():
        rec.reconstruct_image_color(data=img, recons_resolution=2)
    spans = profiling.spans()
    assert spans[0].name == "recon.job" and spans[0].call == 1
    assert "train.call" not in {s.name for s in spans}


def test_open_span_is_read_unfinished():
    with _profiled():
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
            inside = profiling.spans()
    assert [s.name for s in inside] == ["outer", "inner"]
    assert inside[0].end_ns is None and inside[1].end_ns is not None
    assert profiling.spans()[0].end_ns is not None


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    a = torch.rand((300, 300))
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("recon.job"):
            with profiling.span("probe"):
                a @ a
        profiling.count("graph.round.replays", 3)
    doc = json.loads(next((tmp_path / "tr").glob("trace_*.json"))
                     .read_text())
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "program"]
    by = {e["name"]: e for e in ours}
    assert set(by) == {"recon.job", "probe", "program.counters"}
    assert by["recon.job"]["args"]["call"] == by["probe"]["args"]["call"] \
        == 1
    assert by["program.counters"]["args"]["graph.round.replays"] == 3
    # the spans are on the trace's timebase: the matmul's own event lies
    # inside the probe
    mm = next(e for e in doc["traceEvents"] if e.get("name") == "aten::mm")
    probe = by["probe"]
    assert probe["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= probe["ts"] + probe["dur"] + 1e-3


def test_captures_and_replays_are_counted_by_cache():
    class Graph:
        def replay(self):
            pass

    with _profiled():
        capture.replay(Graph(), (), (), 4, {}, cache="round")
        capture.replay(Graph(), (), (), 2, {})
    assert profiling.counters() == {"graph.round.replays": 4,
                                    "graph.step.replays": 2}
    capture.replay(Graph(), (), (), 5, {}, cache="chain")       # off
    assert "graph.chain.replays" not in profiling.counters()


@pytest.mark.parametrize("on", [None, "cpu", torch.device("cpu")])
def test_span_off_is_the_shared_no_op(on):
    first = profiling.span("x", on=on)
    assert first is profiling.span("y") is profiling._OFF
    with first as s:
        assert s is None

"""The readers of the port's own trace record, on made-up traces: each
returns the value worked out by hand from device intervals and spans,
and None where it has nothing to read (no trace, another kind of cell, a
program without the record, the CPU's toy run)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from toy_root import BENCH, SPEC  # also puts the repository on the path

from benchport import harness, peaks
from benchport import spans as record

MS = 1_000_000           # ns


def span(name, start, end, call=None, device_ms=None):
    return SimpleNamespace(name=name, start_ns=start * MS, end_ns=end * MS,
                           call=call, device_ms=device_ms)


def ctx(unit, device, counts=None):
    trace = SimpleNamespace(device=[(n, s * MS, e * MS)
                                    for n, s, e in device],
                            units=4, calls=2, host={})
    return SimpleNamespace(unit=unit, trace=trace,
                           counts=counts or dict(d=441, r=25, n=504,
                                                 sub_iter=10, fixed=False))


# device busy over [0, 20], [30, 40], [60, 70] (the first two operations
# overlap); calls over [0, 50] and [55, 80]: idle 50 - 30 = 20 and
# 25 - 10 = 15, so 17.5 ms a call
DEVICE = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 60, 70)]


def calls(name):
    return [span(name, 0, 50, call=1), span("inner", 1, 49, call=1),
            span(name, 55, 80, call=2)]


def fake(monkeypatch, spans, counters=None):
    monkeypatch.setattr(record, "record", lambda: (spans, counters or {}))


def metric(name):
    return harness.load_metric(BENCH, name)


@pytest.mark.parametrize("name, unit, call", [
    ("rounds.idle_ms_per_call", "round", "train.call"),
    ("recon.idle_ms_per_job", "job", "recon.job")])
def test_idle_inside_calls(monkeypatch, name, unit, call):
    fake(monkeypatch, calls(call))
    assert metric(name).read(ctx(unit, DEVICE)) == pytest.approx(17.5)
    other = "job" if unit == "round" else "round"
    assert metric(name).read(ctx(other, DEVICE)) is None
    fake(monkeypatch, calls("other.call"))
    assert metric(name).read(ctx(unit, DEVICE)) is None


def test_grouping_span_time_per_job(monkeypatch):
    spans = [span("recon.job", 0, 50, call=1),
             span("recon.group", 10, 20, call=1, device_ms=3.0),
             span("recon.job", 55, 80, call=2),
             span("recon.group", 60, 70, call=2, device_ms=5.0),
             span("recon.group", 90, 95, device_ms=100.0)]   # no job's
    fake(monkeypatch, spans)
    m = metric("grouping.span_ms_per_job")
    assert m.read(ctx("job", DEVICE)) == pytest.approx(4.0)
    assert m.read(ctx("round", DEVICE)) is None
    fake(monkeypatch, [span("recon.job", 0, 50, call=1),
                       span("recon.group", 10, 20, call=1)])   # CPU: no time
    assert m.read(ctx("job", DEVICE)) is None


COUNTS = {"coder_es.column_sweeps": 3000, "coder_es.columns": 1000}


def test_sweeps_per_column(monkeypatch):
    fake(monkeypatch, calls("train.call"), COUNTS)
    m = metric("coder_es.sweeps_per_column.train")
    assert m.read(ctx("round", DEVICE)) == 3.0
    assert m.read(ctx("job", DEVICE)) is None
    fake(monkeypatch, calls("train.call"), {"coder_es.columns": 0,
                                            "coder_es.column_sweeps": 0})
    assert m.read(ctx("round", DEVICE)) is None


def test_early_stop_roofline(monkeypatch):
    """1000 columns of 3 sweeps at r = 25: 4 (r^2 + 3 r n) = 302,500
    bytes against 2 r^2 n s = 3.75e6 operations, so bytes bound it at
    302,500 / 3.35e12 s; the kernels ran 2 us in all."""
    fake(monkeypatch, calls("train.call"), COUNTS)
    device = DEVICE + [("void coder_es_lanes_kernel<2, 16>", 100, 100.0015),
                       ("void coder_es_lanes_kernel<2, 16>", 101, 101.0005)]
    m = metric("coder_es_roofline.train")
    want = 100.0 * (4 * (625 + 75_000) / 3.35e12) / 2e-6
    assert m.read(ctx("round", device)) == pytest.approx(want, rel=1e-6)
    assert peaks.coder_fixed_bound(25, 1000, 3)[1] == "bytes"
    assert m.read(ctx("round", DEVICE)) is None          # no kernel traced
    assert m.read(ctx("job", device)) is None


NEW = ["coder_es_roofline.train", "coder_es.sweeps_per_column.train",
       "rounds.idle_ms_per_call", "recon.idle_ms_per_job",
       "grouping.span_ms_per_job"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read(monkeypatch, name):
    m = metric(name)
    unit = "job" if "recon" in name or "job" in name else "round"
    c = ctx(unit, DEVICE)
    c.trace = None
    assert m.read(c) is None
    # a program without the record
    monkeypatch.setattr(record, "record", lambda: None)
    assert m.read(ctx(unit, DEVICE)) is None


def test_program_without_the_record_reads_none(monkeypatch):
    from onmf_ontf_ndl_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert record.record() is None


def test_union_and_idle():
    u = record.busy([("a", 0, 10), ("b", 5, 20), ("c", 30, 40)])
    assert u.tolist() == [[0, 20], [30, 40]]
    assert record.idle_ns(u, 0, 50) == 20
    assert record.idle_ns(u, 25, 28) == 3
    assert record.idle_ns(record.busy([]), 0, 5) == 5


@pytest.mark.parametrize("workload",
                         [w["name"] for w in harness.load_json(SPEC)["workloads"]])
def test_toy_traced_run_reads_none_of_them(toy, workload):
    """On the CPU the record has spans but no device: every new metric is
    left out of the line."""
    spec, root = toy
    out = harness.run(spec=spec, workload=workload, seed=2**41 + 19,
                      seconds=0.3, trace=True, device="cpu", root=root,
                      log=lambda *a, **k: None)
    assert out["correct"]
    assert not set(out["metrics"]) & set(NEW)
    assert {m["name"] for m in spec["per_layer"]} >= set(NEW)

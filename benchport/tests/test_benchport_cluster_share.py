"""The reader of the early-stop coder's cluster share, on made-up
records: the cluster form's columns over all columns, in %, and None
where there is nothing to read (no trace, a reconstruction, no columns,
a program that keeps no count of the cluster form)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from toy_root import BENCH  # also puts the repository on the path

from benchport import harness
from benchport import spans as record

NAME = "coder_es.cluster_share.train"


def ctx(unit):
    trace = SimpleNamespace(device=[("a", 0, 10)], units=4, calls=2,
                            host={})
    return SimpleNamespace(unit=unit, trace=trace,
                           counts=dict(d=400, r=100, n=1000, sub_iter=10,
                                       fixed=False))


def fake(monkeypatch, counters):
    spans = [SimpleNamespace(name="train.call", start_ns=0, end_ns=1,
                             call=1, device_ms=None)]
    monkeypatch.setattr(record, "record", lambda: (spans, counters))


@pytest.mark.parametrize("cluster, want", [(1000, 100.0), (250, 25.0),
                                           (0, 0.0)])
def test_cluster_share(monkeypatch, cluster, want):
    fake(monkeypatch, {"coder_es.columns": 1000,
                       "coder_es.column_sweeps": 10000,
                       "coder_es.cluster_columns": cluster})
    m = harness.load_metric(BENCH, NAME)
    assert m.read(ctx("round")) == pytest.approx(want)
    assert m.read(ctx("job")) is None


def test_nothing_to_read(monkeypatch):
    m = harness.load_metric(BENCH, NAME)
    # a program from before the cluster form keeps no such count
    fake(monkeypatch, {"coder_es.columns": 1000,
                       "coder_es.column_sweeps": 10000})
    assert m.read(ctx("round")) is None
    fake(monkeypatch, {"coder_es.columns": 0,
                       "coder_es.cluster_columns": 0})
    assert m.read(ctx("round")) is None
    c = ctx("round")
    c.trace = None
    assert m.read(c) is None
    monkeypatch.setattr(record, "record", lambda: None)
    assert m.read(ctx("round")) is None

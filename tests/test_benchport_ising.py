"""The benchmark's Ising cell (``benchport/``) on the CPU: its plain
reference's checkerboard sweeps equal the port's plain sweeps site for
site (Philox4x32-10 written anew from the stream's rule), the sampler's
roofline counts are pinned, and a toy ``ising-train`` run through the
harness is correct, and not correct with its lattice frozen. The toy
runs go through a fresh interpreter: the harness refuses to run where
JAX is loaded, as it is in this test process. The cell's two new
metrics' readers return what made-up traces give by hand, and None where
there is nothing to read.

On the card (``-m cuda``; this file imports no JAX, so it runs there
with ``--noconftest``): the checkerboard kernel against the reference's
sweeps at the cell's lattice.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchport import harness, peaks_ising, spans
from benchport.reference import ising as ref
from onmf_ontf_ndl_tpu_torch.ops.kernels import ising_kernel as ik

REPO = Path(__file__).resolve().parents[1]


def _lattice(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([1, -1], np.int8), size=(n, n))


@pytest.mark.parametrize("T", [1.0, 2.27, 5.0])
@pytest.mark.parametrize("nsweeps", [1, 2, 3])
@pytest.mark.parametrize("n", [8, 10, 16, 200])
def test_reference_sweeps_equal_the_ports_plain_sweeps(n, nsweeps, T):
    for seed in (7, 2**31 - 2, 93_417):
        lat = _lattice(n, seed + n)
        want = ik.checkerboard_sweeps_plain(seed, torch.from_numpy(lat),
                                            nsweeps, 1.0, 0.0, T).numpy()
        got = ref.sweeps(seed, lat, nsweeps, 1.0, 0.0, T)
        assert got.dtype == np.int8
        assert np.array_equal(got, want), int((got != want).sum())
        assert not np.array_equal(got, lat)


def test_reference_thresholds_equal_the_ports():
    for J, H, T in ((1.0, 0.0, 5.0), (1.0, 0.5, 2.27), (-0.5, 0.25, 0.1)):
        thr = ref.thresholds(J, H, T)
        assert [thr[s, sn] for s in (-1, 1) for sn in (-4, -2, 0, 2, 4)] \
            == ik.acceptance_thresholds(J, H, T)


def test_checkerboard_bound_is_set_by_integer_operations():
    # PERF.md's kernel table: n = 4096, 100 sweeps, 1.204 ms
    seconds, by = peaks_ising.checkerboard_bound(4096, 100)
    assert by == "operations" and round(seconds * 1e3, 3) == 1.204
    # the cell: 10,000 Philox calls (20 multiplies, 20 other operations
    # each) and 40,000 sites (7 operations each) a sweep
    seconds, by = peaks_ising.checkerboard_bound(200, 1)
    assert by == "operations"
    assert seconds == pytest.approx(
        (20 * 10_000 + 7 * 40_000) / (132 * 64 * 1.98e9), rel=1e-12)
    assert seconds > 2 * 200 * 200 / 3.35e12     # over the lattice's bytes


MS = 1_000_000           # ns


def _span(name, start, end, device_ms=None):
    return SimpleNamespace(name=name, start_ns=start * MS, end_ns=end * MS,
                           device_ms=device_ms)


def _ctx(device, counts=None, unit="round"):
    trace = SimpleNamespace(device=[(n, s * MS, e * MS) for n, s, e in device],
                            units=42, calls=2, host={})
    return SimpleNamespace(unit=unit, trace=trace, counts=counts or dict(
        d=400, r=100, n=1000, sub_iter=10, fixed=False, lattice=200,
        sweeps=1))


def _metric(name):
    return harness.load_metric(REPO / "benchport", name)


CALLS = [_span("train.call", 0, 300), _span("train.call", 310, 600)]


def test_checkerboard_roofline_reads_the_counted_sweeps(monkeypatch):
    """Two calls of 20 rounds, one sweep each: 40 sampler calls of
    2.87e-8 s of bound, against 2 launches a call of the device-memory
    kernel of 1 us and 2 us: 100 * 40 * bound / 120 us."""
    sites = 2 * 20 * 200 * 200
    monkeypatch.setattr(spans, "record", lambda: (
        CALLS, {"ising.site_updates": sites}))
    device = [("void (anonymous namespace)::checkerboard_half_kernel<8>",
               10 + i, 10 + i + (0.001 if i % 2 else 0.002))
              for i in range(80)]
    m = _metric("checkerboard_roofline.train")
    least, _ = peaks_ising.checkerboard_bound(200, 1)
    assert m.read(_ctx(device)) == pytest.approx(
        100.0 * 40 * least / 120e-6, rel=1e-9)
    assert m.read(_ctx(device[:1] + [("coder_es_lanes_kernel", 0, 5)])) \
        == pytest.approx(100.0 * 40 * least / 2e-6, rel=1e-9)
    ndl = dict(d=441, r=25, n=504, sub_iter=10, fixed=False)
    assert m.read(_ctx(device, ndl)) is None       # not an Ising cell
    assert m.read(_ctx([("coder_es_lanes_kernel", 0, 5)])) is None
    assert m.read(_ctx(device, unit="job")) is None
    monkeypatch.setattr(spans, "record", lambda: (CALLS, {}))
    assert m.read(_ctx(device)) is None            # a program without it
    monkeypatch.setattr(spans, "record", lambda: None)
    assert m.read(_ctx(device)) is None


def test_initial_round_reads_its_device_time_a_call(monkeypatch):
    timed = CALLS + [_span("ising.initial", 1, 250, device_ms=17.0),
                     _span("ising.initial", 311, 560, device_ms=19.0)]
    monkeypatch.setattr(spans, "record", lambda: (timed, {}))
    m = _metric("ising.initial_ms_per_call")
    assert m.read(_ctx([])) == pytest.approx(18.0)
    assert m.read(_ctx([], unit="job")) is None
    c = _ctx([])
    c.trace = None
    assert m.read(c) is None
    # the CPU's spans carry no device time; the parent's record has none
    monkeypatch.setattr(spans, "record", lambda: (
        CALLS + [_span("ising.initial", 1, 250)], {}))
    assert m.read(_ctx([])) is None
    monkeypatch.setattr(spans, "record", lambda: (CALLS, {}))
    assert m.read(_ctx([])) is None


TOY_RUN = """
import json, sys
from pathlib import Path
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
import pytest
from toy_root import make_toy
from benchport import harness
import faults.ising
tmp = Path({tmp!r})
spec = make_toy(tmp)
with pytest.MonkeyPatch.context() as mp:
    if {fault!r}:
        getattr(faults.ising, {fault!r})(mp)
    out = harness.run(spec=spec, workload="ising-train", seed=2**45 + 11,
                      seconds=0.3, trace=False, device="cpu", root=tmp,
                      log=lambda *a, **k: 0)
print(json.dumps(out))
"""


def _toy_run(tmp_path, fault: str) -> dict:
    code = TOY_RUN.format(tests=str(REPO / "benchport" / "tests"),
                          repo=str(REPO), tmp=str(tmp_path), fault=fault)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_toy_ising_train_is_correct(tmp_path):
    out = _toy_run(tmp_path, "")
    assert out["correct"], out["checks"]
    assert out["attempted"] % 3 == 0        # the toy's 1 + 2 rounds a call
    assert set(out["metrics"]) == {"train_patches_per_s", "setup_s"}
    assert out["checks"]["lattice_differ"]["value"] == 0


def test_toy_ising_train_with_a_frozen_lattice_is_not_correct(tmp_path):
    out = _toy_run(tmp_path, "frozen_lattice")
    assert not out["correct"]
    assert out["checks"]["lattice_differ"]["value"] > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nsweeps", [1, 13])
def test_cuda_kernel_equals_the_reference_sweeps(cuda, nsweeps):
    for seed in (5, 2**31 - 2):
        lat = _lattice(200, seed)
        got = ik.checkerboard_sweeps(seed, torch.from_numpy(lat).to(cuda),
                                     nsweeps, 1.0, 0.0, 5.0)
        want = ref.sweeps(seed, lat, nsweeps, 1.0, 0.0, 5.0)
        assert np.array_equal(got.cpu().numpy(), want)

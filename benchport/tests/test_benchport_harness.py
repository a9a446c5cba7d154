"""The harness on the CPU at toy sizes: a cell, a mix and a metric that
exist only as files are found by name and run; every cell is correct as
the port stands, comes out not correct with the timed path broken in
each way its kind of cell can be, and its control (the reference in TF32)
reads far above the program; the command refuses to run without a card
and prints no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from toy_root import BENCH, REPO

from benchport import harness

SEED = 2**41 + 17
CELLS = ["image-train", "ndl-train", "image-recon", "ndl-recon"]


def run(spec, root, workload, seed=SEED, trace=False, seconds=0.3):
    return harness.run(spec=spec, workload=workload, seed=seed,
                       seconds=seconds, trace=trace, device="cpu",
                       root=root, log=lambda *a, **k: None)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_with_its_metrics(toy, workload):
    spec, root = toy
    out = run(spec, root, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in harness.metrics_of(spec, workload,
                                                   "end_to_end")}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(json.loads(
        (root / "limits" / f"{workload}.json").read_text()))


@pytest.mark.parametrize("workload", ["image-train", "ndl-recon"])
def test_traced_run_reads_per_layer_metrics(toy, workload):
    spec, root = toy
    out = run(spec, root, workload, trace=True, seconds=0.5)
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in harness.metrics_of(spec, workload,
                                                   "per_layer")}
    assert set(out["metrics"]) <= names and out["metrics"]


def test_cell_mix_and_metric_from_files_alone(toy):
    """A new cell on a new mix with a new metric: files and entries only."""
    spec, root = toy
    (root / "traffic" / "train-pairs.json").write_text(json.dumps(
        {"kind": "train", "trace_seconds": 0.2}))
    (root / "metrics" / "extra.rounds_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    shutil.copy(root / "limits" / "image-train.json",
                root / "limits" / "image-pairs.json")
    spec["workloads"].append({"name": "image-pairs", "config": "image-r25",
                              "traffic": "train-pairs", "chips": 1,
                              "why": "toy"})
    spec["end_to_end"].append({"name": "extra.rounds_seen", "unit": "rounds",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["image-pairs"]})
    out = run(spec, root, "image-pairs")
    assert out["correct"]
    assert out["metrics"]["extra.rounds_seen"]["value"] == out["attempted"]
    assert out["attempted"] % 2 == 0        # the toy's rounds_per_call


@pytest.mark.parametrize("checks, ok", [
    ({"a": 1e-5, "b": 0.0}, True), ({"a": 2e-4, "b": 0.0}, False),
    ({"a": float("nan"), "b": 0.0}, False), ({"a": 1e-5}, False),
    ({"a": 1e-5, "b": 0.0, "c": 0.0}, False)])
def test_one_rule_decides_pass_for_runs_and_the_control(checks, ok):
    assert harness.passes(checks, {"a": 1e-4, "b": 0.0}) is ok


def test_sample_keeps_job_zero_and_a_seeded_sample():
    a, b = harness.Sample(3, 5), harness.Sample(3, 5)
    for j in range(200):
        a.offer(j, j)
        b.offer(j, j)
    assert 0 in a.items and len(a.items) == 3
    assert a.items == b.items
    c = harness.Sample(3, 6)
    for j in range(200):
        c.offer(j, j)
    assert len(c.items) == 3


# ------------------------------------------------------------- faults:
# the timed path broken underneath, each way the cell's kind can fail


def _unchanged_state(monkeypatch):
    from onmf_ontf_ndl_tpu_torch.models import onmf

    orig = onmf._step_math

    def step(W, A, B, C, Xb, H0, *a, **k):
        H, _ = orig(W.clone(), A.clone(), B.clone(), C.clone(), Xb, H0,
                    *a, **k)
        return H, W

    monkeypatch.setattr(onmf, "_step_math", step)


def _half_batch(monkeypatch):
    from onmf_ontf_ndl_tpu_torch.models import onmf

    orig = onmf._step_math

    def step(W, A, B, C, Xb, H0, *a, **k):
        n = Xb.shape[1]
        keep = torch.arange(n, device=Xb.device) % max(n // 2, 1)
        return orig(W, A, B, C, Xb[:, keep], H0[:, keep], *a, **k)

    monkeypatch.setattr(onmf, "_step_math", step)


def _altered_image(monkeypatch):
    from onmf_ontf_ndl_tpu_torch.apps import image

    orig = image.overlap_average_grid

    def paint(*a, **k):
        out = orig(*a, **k)
        out[5, 5, 0] += 0.25
        return out

    monkeypatch.setattr(image, "overlap_average_grid", paint)


def _altered_graph(monkeypatch):
    from onmf_ontf_ndl_tpu_torch.apps import network

    orig = network._group_painted

    def group(*a, **k):
        ii, jj, sums, cnt = orig(*a, **k)
        sums = sums.clone()
        sums[len(sums) // 2] += cnt[len(sums) // 2]
        return ii, jj, sums, cnt

    monkeypatch.setattr(network, "_group_painted", group)


def _stale_weights(monkeypatch):
    """The captured route's cached entry replays its rounds with the
    first call's weight table (the step weights 1 / t of the rounds that
    call ran), not the table of the rounds it runs: a fault of the
    window's calls alone (the card's route; the CPU has no cached
    entry)."""
    from onmf_ontf_ndl_tpu_torch.models import onmf

    orig, seen = onmf._fill_round, []

    def fill(rb, state, code, carry, weights=None):
        if seen:
            weights = None
        seen.append(1)
        orig(rb, state, code, carry, weights)

    monkeypatch.setattr(onmf, "_fill_round", fill)


FAULTS = [("image-train", _unchanged_state), ("image-train", _half_batch),
          ("ndl-train", _unchanged_state), ("ndl-train", _half_batch),
          ("image-recon", _altered_image), ("ndl-recon", _altered_graph)]
CARD_FAULTS = FAULTS + [("image-train", _stale_weights),
                        ("ndl-train", _stale_weights)]


@pytest.mark.parametrize("workload, fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_broken_timed_path_is_not_correct(toy, monkeypatch, workload,
                                          fault):
    spec, root = toy
    fault(monkeypatch)
    out = run(spec, root, workload)
    assert not out["correct"], out["checks"]


@pytest.fixture
def fresh_graphs():
    """No captured graph outlives a test: a fault planted in the step
    must be captured anew, not replayed from an earlier test's graph."""
    from onmf_ontf_ndl_tpu_torch.models import onmf
    from onmf_ontf_ndl_tpu_torch.samplers import motif

    def clear():
        onmf._ROUND_GRAPHS.clear()
        onmf._clear_graphs()
        motif._CHAIN_GRAPHS.clear()

    clear()
    yield
    clear()


@pytest.mark.cuda
@pytest.mark.parametrize("workload, fault", CARD_FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in CARD_FAULTS])
def test_cuda_broken_timed_path_is_not_correct(card, fresh_graphs,
                                               monkeypatch, workload, fault):
    """Each fault at the cell's own size on the card, three seeds; the
    readings are printed (``-s``) for the limits' upper ends."""
    spec = harness.load_json(REPO / "BENCHMARK.json")
    fault(monkeypatch)
    for seed in (2**36 + 1, 2**36 + 3, 2**36 + 5):
        out = harness.run(spec=spec, workload=workload, seed=seed,
                          seconds=1.0, trace=False,
                          log=lambda *a, **k: None)
        print(json.dumps({"workload": workload, "fault": fault.__name__,
                          "seed": seed, "checks": out["checks"]}))
        assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_far_above_the_program(toy, workload):
    """The control's widest reading is at least ten times the program's
    on the same seed (at the cells' sizes, on the card, it fails the
    limits: the card test below)."""
    spec, root = toy
    sound = run(spec, root, workload)["checks"]
    low = harness.control(spec=spec, workload=workload, seed=SEED,
                          device="cpu", root=root)["checks"]
    ratio = max(low[k] / max(sound[k]["value"], 1e-12) for k in low
                if sound[k]["value"] > 0 or low[k] > 0)
    assert ratio >= 10, (low, sound)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cuda_control_fails_the_cells_limits(card, workload):
    spec = harness.load_json(REPO / "BENCHMARK.json")
    out = harness.control(spec=spec, workload=workload, seed=2**35 + 1)
    assert out["fails"], out


def test_command_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for d in (REPO, tmp_path):
        if d is tmp_path:
            shutil.copytree(BENCH, d / "benchport")
            shutil.copy(REPO / "BENCHMARK.json", d / "BENCHMARK.json")
        out = subprocess.run(
            [sys.executable, "benchport/run.py", "--workload", "image-train",
             "--seed", str(2**40), "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=d)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout

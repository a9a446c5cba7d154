"""The harness on the CPU at toy sizes: a configuration, a cell, a mix
and a metric that exist only as files and entries are found by name and
run, and the cases below are read from BENCHMARK.json's cells and the
files they name; every cell is correct as the port stands, comes out not
correct with the timed path broken in each way its kind of cell can be
(``faults/``), and its control (the reference in TF32) reads far above
the program; the command refuses to run without a card and prints no
result."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

import faults
from toy_root import BENCH, REPO, SPEC, TOYS, make_toy

from benchport import harness

SEED = 2**41 + 17
# the cases, from BENCHMARK.json's cells: each cell's faults are those
# of its configuration's app for its mix's kind (faults/<app>.py)
CELLS = [w["name"] for w in harness.load_json(SPEC)["workloads"]]
CPU_CASES, CARD_CASES = faults.cases(harness.load_json(SPEC), BENCH)


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


@pytest.mark.parametrize("workload", CELLS)
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


def tree(root):
    """Every file under ``root`` (compiled modules aside) and its bytes."""
    return {p: p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_configuration_from_files_alone(tmp_path):
    """A second configuration of the image app and a cell on it: its
    configuration file, toy sizes and limits are new files, its cell and
    configuration new entries. The toy root and the checkout keep every
    file they had, byte for byte; the cell runs correct, and the fault
    cases built from the spec take its faults (its run and control
    cases are the spec's cell names)."""
    checkout = tree(BENCH)
    checkout[SPEC] = SPEC.read_bytes()
    root, new = tmp_path / "root", tmp_path / "new"
    root.mkdir()
    make_toy(root)
    before = tree(root)

    shutil.copytree(TOYS, new / "toys")
    (new / "configs").mkdir()
    cfg = json.loads((BENCH / "configs" / "image-r25.json").read_text())
    cfg.update(patch_size=8, n_components=16)
    (new / "configs" / "image-r16.json").write_text(json.dumps(cfg))
    spec = harness.load_json(SPEC)
    spec["configs"].append({"name": "image-r16", "source": "toy",
                            "file": str(new / "configs" / "image-r16.json"),
                            "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": "image16-train", "config": "image-r16",
                              "traffic": "train", "chips": 1, "why": "toy"})
    toy = new / "toys" / "image-r16.json"
    with pytest.raises(FileNotFoundError, match=re.escape(str(toy))):
        make_toy(root, spec, toys=new / "toys")
    toy.write_text(json.dumps(dict(
        height=36, width=40, patch_size=3, n_components=4, num_patches=64,
        sub_iterations=3, rounds_per_call=2, setup_rounds=2,
        recons_stride=3)))
    shutil.copy(root / "limits" / "image-train.json",
                root / "limits" / "image16-train.json")
    spec = make_toy(root, spec, toys=new / "toys")

    out = run(spec, root, "image16-train")
    assert out["correct"], out["checks"]
    cpu, card = faults.cases(spec, root)
    image = faults.of("image")
    assert [f for w, f in cpu if w == "image16-train"] \
        == image.CPU["train"]
    assert [f for w, f in card if w == "image16-train"] \
        == image.CPU["train"] + image.CARD["train"]
    after = tree(root)
    assert {p: after.get(p) for p in before} == before
    assert {p: p.read_bytes() for p in checkout} == checkout


def test_every_configuration_has_its_toy_and_every_kind_a_fault():
    """Each configuration of BENCHMARK.json has its toy sizes, and each
    (app, kind) that a cell runs at least one fault on the CPU; a failure
    names the file to add."""
    spec = harness.load_json(SPEC)
    missing = [f"add {TOYS / c['name']}.json" for c in spec["configs"]
               if not (TOYS / f"{c['name']}.json").exists()]
    for w in spec["workloads"]:
        app, kind = faults.app_and_kind(spec, w["name"], BENCH)
        mod = faults.of(app)
        if mod is None or not mod.CPU.get(kind):
            missing.append(f"add a {kind!r} fault to CPU in "
                           f"{faults.HERE / app}.py (cell {w['name']})")
    assert not missing, "\n".join(missing)


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


def ids(cases):
    return [f"{w}-{f.__name__}" for w, f in cases]


@pytest.mark.parametrize("workload, fault", CPU_CASES, ids=ids(CPU_CASES))
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
@pytest.mark.parametrize("workload, fault", CARD_CASES,
                         ids=ids(CARD_CASES))
def test_cuda_broken_timed_path_is_not_correct(card, fresh_graphs,
                                               monkeypatch, workload, fault):
    """Each fault at the cell's own size on the card, three seeds; the
    readings are printed (``-s``) for the limits' upper ends."""
    spec = harness.load_json(SPEC)
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
    spec = harness.load_json(SPEC)
    out = harness.control(spec=spec, workload=workload, seed=2**35 + 1)
    assert out["fails"], out


def test_command_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for d in (REPO, tmp_path):
        if d is tmp_path:
            shutil.copytree(BENCH, d / "benchport")
            shutil.copy(SPEC, d / "BENCHMARK.json")
        out = subprocess.run(
            [sys.executable, "benchport/run.py", "--workload", "image-train",
             "--seed", str(2**40), "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=d)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout

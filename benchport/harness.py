"""The benchmark's driver: one run of one cell.

Everything that belongs to one configuration, traffic mix, cell or
metric sits in files of its own, found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the entry's ``file``): the sizes, with
  ``app``, the module of ``apps/`` that drives the port for it;
- ``traffic/<traffic>.json``: the mix, with ``kind`` (``train`` or
  ``recon``: the class of the app module that runs it) and its loop's
  parameters;
- ``limits/<cell>.json``: each number the run compares with the
  reference, and its limit;
- ``metrics/<metric>.py``: a reader ``read(ctx)`` that returns the
  metric's value, or None where it finds nothing to read.

A run: set-up (inputs from the seed, the program built and warmed up,
every shape the window uses run once), then ``seconds`` of calls in a
closed loop (the next call starts when the last returns; a job ends at a
synchronise), then, with the program's state freed, the comparison with
the plain reference. With ``trace`` the first ``trace_seconds`` of the
window run under ``torch.profiler`` and the per-layer metrics are read
from that trace; otherwise the end-to-end metrics from the host clock.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "onmf_ontf_ndl_tpu")


class Sample:
    """The jobs kept for the comparison: job 0, and a uniform sample of
    ``size - 1`` of the later jobs drawn from the seed (reservoir
    sampling, so the window's length need not be known)."""

    def __init__(self, size: int, seed: int):
        from benchport.inputs import sub_seed

        self.size = size
        self.rng = np.random.default_rng(sub_seed(seed, "sample"))
        self.items = {}
        self.seen = 0

    def offer(self, j: int, value) -> None:
        if j == 0:
            self.items[0] = value
            return
        if self.size <= 1:
            return
        self.seen += 1
        later = sorted(i for i in self.items if i != 0)
        if len(later) < self.size - 1:
            self.items[j] = value
            return
        slot = int(self.rng.integers(0, self.seen))
        if slot < self.size - 1:
            del self.items[later[slot]]
            self.items[j] = value

    def first_jobs(self) -> None:
        """Keep jobs 0 .. size - 1 (with no outputs): the control's
        sample."""
        self.items = {j: None for j in range(self.size)}


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's (names compared whole)."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def refuse_forbidden() -> None:
    """Exit without a result where a module of JAX or the JAX package is
    loaded, naming what was found."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: "
                         f"{found}")


def passes(checks: dict, limits: dict) -> bool:
    """Whether the readings pass: every limit read, each reading finite
    and at most its limit."""
    return (set(checks) == set(limits)
            and all(math.isfinite(v) and v <= limits[k]
                    for k, v in checks.items()))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(root: Path, name: str):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchport_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(spec: dict, workload: str, repo: Path, root: Path):
    """The cell's entry, configuration, mix and limits."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(repo / cfg_entry["file"])
    mix = load_json(root / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "limits" / f"{workload}.json")
    return cell, cfg, mix, limits


def driver(cfg: dict, mix: dict, seed: int, device):
    app = importlib.import_module(f"benchport.apps.{cfg['app']}")
    return getattr(app, mix["kind"].capitalize())(cfg, mix, seed, device)


def metrics_of(spec: dict, workload: str, kind: str) -> list:
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(drv, seconds: float, device, trace_seconds: float | None):
    """The measured window: calls until ``seconds`` have passed. Returns
    the host-clock record and, with ``trace_seconds``, the trace of the
    calls made in the window's first ``trace_seconds``."""
    import torch

    per_job = drv.unit == "job"
    units, calls, lat = 0, 0, []
    traced = None
    prof = None
    if trace_seconds is not None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        mark = torch.profiler.record_function("benchport.traced_window")
        mark.__enter__()
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        units += drv.call()
        calls += 1
        if per_job:
            sync(device)
            lat.append(time.perf_counter() - c0)
        now = time.perf_counter() - t0
        if prof is not None and (now >= trace_seconds or now >= seconds):
            sync(device)
            mark.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            traced = dict(units=units, calls=calls, prof=prof)
            prof = None
        if now >= seconds:
            break
    sync(device)
    return dict(units=units, calls=calls, latencies=lat,
                window_s=time.perf_counter() - t0), traced


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def run(*, spec: dict, workload: str, seed: int, seconds: float,
        trace: bool, device="cuda", repo: Path | None = None,
        root: Path = ROOT, t_start: float | None = None,
        log=print) -> dict:
    """One run of ``workload``; returns the result line's object (not
    printed). ``device="cpu"`` (tests) runs the port's plain versions."""
    import torch

    from benchport import tracing
    from benchport.reference import onmf

    t_start = time.perf_counter() if t_start is None else t_start
    repo = root.parent if repo is None else repo
    cell, cfg, mix, limits = cell_parts(spec, workload, repo, root)
    cuda = torch.device(device).type == "cuda"
    chips = int(cell.get("chips", 1))
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < chips):
        raise SystemExit(f"{workload} needs {chips} CUDA device(s); "
                         f"found {torch.cuda.device_count()}")
    onmf.fixed_float32()
    drv = driver(cfg, mix, seed, device)
    drv.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rec, traced = window(drv, seconds, device,
                         mix["trace_seconds"] if trace else None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    refuse_forbidden()
    trace_data = tracing.reduce(traced["prof"], traced["units"],
                                traced["calls"]) if traced else None
    if traced:
        del traced["prof"]
    log(f"card: {power_limit() if cuda else 'cpu'}", file=sys.stderr)
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = drv.check()
    log(f"reference and comparison: {time.perf_counter() - t_check:.2f} s",
        file=sys.stderr)
    correct = passes(checks, limits)
    ctx = SimpleNamespace(
        cell=workload, cfg=cfg, mix=mix, unit=drv.unit,
        patches_per_unit=drv.patches_per_unit(), counts=drv.counts(),
        units=rec["units"], window_s=rec["window_s"],
        latencies=rec["latencies"], setup_s=setup_s, trace=trace_data)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(spec, workload, kind):
        value = load_metric(root, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": rec["units"], "failed": 0,
           "metrics": metrics, "device": dev}
    if trace_data is not None:
        dev["busy_s"] = trace_data.busy_s
        dev["window_s"] = trace_data.window_s
        out["breakdown"] = trace_data.breakdown
    out["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in checks.items()}
    for k, v in checks.items():
        log(f"check {k} {v!r} limit {limits.get(k)!r}", file=sys.stderr)
    # again after the reference and the metric readers, which ran after
    # the first look
    refuse_forbidden()
    return out


def control(*, spec: dict, workload: str, seed: int, device="cuda",
            repo: Path | None = None, root: Path = ROOT) -> dict:
    """The control's readings: the reference in TF32 in the program's
    place, at the cell's sizes, against the float32 reference. The
    program is not run."""
    from benchport.reference import onmf

    repo = root.parent if repo is None else repo
    _, cfg, mix, limits = cell_parts(spec, workload, repo, root)
    onmf.fixed_float32()
    drv = driver(cfg, mix, seed, device)
    drv.setup_inputs()
    checks = drv.control()
    return {"workload": workload, "seed": seed, "checks": checks,
            "limits": limits,
            "fails": not passes(checks, limits)}

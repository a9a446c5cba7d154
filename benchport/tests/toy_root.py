"""A benchmark root in a temporary directory whose configurations are toy
sizes of the real ones, so that a whole run of a cell (set-up, window,
comparison) takes seconds on the CPU with the port's plain versions.

A configuration's toy sizes are ``toys/<config>.json``: the keys of its
file that the toy overrides. ndl-fb21's is one tile of 128 columns: the
port's plain coder stops on the whole batch, the card's kernel per tile,
and a single tile is both."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchport"
SPEC = REPO / "BENCHMARK.json"
TOYS = BENCH / "tests" / "toys"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchport import harness  # noqa: E402  (needs the path above)


def make_toy(tmp: Path, spec: dict | None = None, toys: Path = TOYS) -> dict:
    """A benchmark root under ``tmp`` with the cells of ``spec`` (default:
    BENCHMARK.json's) on toy configurations, each configuration's file
    updated with ``toys/<config>.json``; returns the spec that points at
    it."""
    spec = copy.deepcopy(harness.load_json(SPEC) if spec is None else spec)
    for d in ("traffic", "metrics", "limits"):
        shutil.copytree(BENCH / d, tmp / d, dirs_exist_ok=True)
    (tmp / "configs").mkdir(exist_ok=True)
    for c in spec["configs"]:
        toy = toys / f"{c['name']}.json"
        if not toy.exists():
            raise FileNotFoundError(
                f"no toy sizes for configuration {c['name']!r}: add {toy}")
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(json.loads(toy.read_text()))
        c["file"] = str(tmp / "configs" / f"{c['name']}.json")
        Path(c["file"]).write_text(json.dumps(cfg))
    return spec

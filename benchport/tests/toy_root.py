"""A benchmark root in a temporary directory whose configurations are toy
sizes of the real ones, so that a whole run of a cell (set-up, window,
comparison) takes seconds on the CPU with the port's plain versions."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchport"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TOY = {
    "image-r25": dict(height=40, width=36, patch_size=4, n_components=5,
                      num_patches=96, sub_iterations=4, rounds_per_call=2,
                      setup_rounds=3, recons_stride=3),
    # one tile of 128 columns: the port's plain coder stops on the whole
    # batch, the card's kernel per tile, and a single tile is both
    "ndl-fb21": dict(nodes=60, ba_m=3, k2=4, n_components=5, sample_size=40,
                     num_chains=4, sub_iterations=4, rounds_per_call=2,
                     setup_rounds=3, recons_iter=200, recons_chains=16),
}


def make_toy(tmp: Path) -> dict:
    """A benchmark root under ``tmp`` with BENCHMARK.json's cells on toy
    configurations; returns the spec that points at it."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for d in ("traffic", "metrics", "limits"):
        shutil.copytree(BENCH / d, tmp / d, dirs_exist_ok=True)
    (tmp / "configs").mkdir(exist_ok=True)
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TOY[c["name"]])
        c["file"] = str(tmp / "configs" / f"{c['name']}.json")
        Path(c["file"]).write_text(json.dumps(cfg))
    return spec


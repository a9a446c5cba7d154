"""Planted faults: the timed path broken underneath, each way a cell's
kind can fail, found by name.

``faults/<app>.py`` holds the faults of the app that a configuration's
``app`` names. It exports two mappings from a traffic kind (a mix's
``kind``: ``train``, ``recon``) to a list of faults, each a function of
pytest's ``monkeypatch``: ``CPU``, planted in the toy runs on the CPU and
on the card, and ``CARD``, planted on the card alone (a fault of a route
only the card takes). Faults that several apps share sit in modules of
their own here (``step.py``: the training step's)."""

from __future__ import annotations

import importlib
from pathlib import Path

from toy_root import REPO  # noqa: F401  (puts the repository on the path)

from benchport import harness

HERE = Path(__file__).resolve().parent


def of(app: str):
    """The fault module of ``app``, or None where ``faults/<app>.py`` is
    missing."""
    if not (HERE / f"{app}.py").exists():
        return None
    return importlib.import_module(f"{__name__}.{app}")


def app_and_kind(spec: dict, workload: str, root: Path) -> tuple:
    """The app of a cell's configuration and the kind of its mix, from
    the files the harness reads for the cell in the benchmark root
    ``root``."""
    _, cfg, mix, _ = harness.cell_parts(spec, workload, root.parent, root)
    return cfg["app"], mix["kind"]


def cases(spec: dict, root: Path) -> tuple:
    """The (cell, fault) pairs of the cells of ``spec`` in the benchmark
    root ``root``, for the CPU and for the card: each cell's ``CPU``
    faults, and on the card those with its ``CARD`` ones."""
    cpu, card = [], []
    for w in spec["workloads"]:
        name = w["name"]
        app, kind = app_and_kind(spec, name, root)
        mod = of(app)
        both = mod.CPU.get(kind, []) if mod else []
        alone = mod.CARD.get(kind, []) if mod else []
        cpu += [(name, f) for f in both]
        card += [(name, f) for f in both + alone]
    return cpu, card

"""Faults of the Ising app's cell."""

from __future__ import annotations

from .step import half_batch, stale_weights, unchanged_state


def frozen_lattice(monkeypatch):
    """The sweeps skipped in the round: the lattice stays as it was (the
    sweeps' seed is still drawn)."""
    from onmf_ontf_ndl_tpu_torch.apps import ising

    monkeypatch.setattr(ising, "checkerboard_sweeps",
                        lambda seed, lattice, *a, **k: lattice.clone())


def wrong_temperature(monkeypatch):
    """The sweeps at twice the configuration's temperature (the
    thresholds of 2T)."""
    from onmf_ontf_ndl_tpu_torch.apps import ising

    orig = ising.checkerboard_sweeps

    def sweeps(seed, lattice, nsweeps, J=1.0, H=0.0, T=0.5):
        return orig(seed, lattice, nsweeps, J, H, 2.0 * T)

    monkeypatch.setattr(ising, "checkerboard_sweeps", sweeps)


def stale_c(monkeypatch):
    """The aggregate C of X X^T never accumulated: each step blends into
    a copy."""
    from onmf_ontf_ndl_tpu_torch.models import onmf

    orig = onmf._step_math

    def step(W, A, B, C, *a, **k):
        return orig(W, A, B, C.clone(), *a, **k)

    monkeypatch.setattr(onmf, "_step_math", step)


CPU = {"train": [frozen_lattice, wrong_temperature, stale_c,
                 unchanged_state, half_batch]}
CARD = {"train": [stale_weights]}

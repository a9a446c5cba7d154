"""Faults of the training step that every training app shares."""

from __future__ import annotations

import torch


def unchanged_state(monkeypatch):
    """A step that returns its state unchanged."""
    from onmf_ontf_ndl_tpu_torch.models import onmf

    orig = onmf._step_math

    def step(W, A, B, C, Xb, H0, *a, **k):
        H, _ = orig(W.clone(), A.clone(), B.clone(), C.clone(), Xb, H0,
                    *a, **k)
        return H, W

    monkeypatch.setattr(onmf, "_step_math", step)


def half_batch(monkeypatch):
    """Half of the batch left out: the step sees the first half twice."""
    from onmf_ontf_ndl_tpu_torch.models import onmf

    orig = onmf._step_math

    def step(W, A, B, C, Xb, H0, *a, **k):
        n = Xb.shape[1]
        keep = torch.arange(n, device=Xb.device) % max(n // 2, 1)
        return orig(W, A, B, C, Xb[:, keep], H0[:, keep], *a, **k)

    monkeypatch.setattr(onmf, "_step_math", step)


def stale_weights(monkeypatch):
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

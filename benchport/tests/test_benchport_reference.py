"""The plain reference's step: on the card each step is replayed as a CUDA
graph of the same operations; its results equal the operations run one by
one (the CPU's path) on the card."""

from __future__ import annotations

import json

import pytest
import torch

from toy_root import REPO  # noqa: F401  (puts the repository on the path)

from benchport.reference import onmf


def _steps(dev, d, n, stop, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = onmf.State.fresh(torch.rand((d, 25), generator=gen, device=dev))
    X = torch.rand((d, n), generator=gen, device=dev)
    for t in range(1, 4):
        H0 = torch.rand((25, n), generator=gen, device=dev)
        onmf.step(st, X, H0, float(t), alpha=0.1, sweeps=10, stop=stop,
                  tile=128, prec=onmf.Prec())
    return st


def test_graphed_is_the_function_itself_off_the_card():
    x = torch.arange(4.0)
    assert onmf.graphed("k", lambda a: (a * 2,), x)[0].tolist() == \
        [0.0, 2.0, 4.0, 6.0]


@pytest.mark.cuda
@pytest.mark.parametrize("d, n, stop", [(300, 16384, None), (441, 504, 0.01)],
                         ids=["image-fixed", "ndl-tile-stop"])
def test_cuda_graphed_steps_equal_the_eager_steps(card, monkeypatch, d, n,
                                                  stop):
    onmf.fixed_float32()
    a = _steps(card, d, n, stop)
    monkeypatch.setattr(onmf, "graphed", lambda key, fn, *args: fn(*args))
    b = _steps(card, d, n, stop)
    gaps = {k: onmf.gap(getattr(a, k), getattr(b, k)) for k in "WAB"}
    print(json.dumps({"d": d, "n": n, "stop": stop, "gaps": gaps}))
    assert max(gaps.values()) <= 1e-6, gaps

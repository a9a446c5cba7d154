"""The Ising configuration's traffic kind, driven through the port's
``IsingReconstructor``: dictionary learning along the lattice's
trajectory (``ising_mcmc_learning``)."""

from __future__ import annotations

import numpy as np
import torch

from benchport import inputs
from benchport.reference import ising as ref
from benchport.reference import onmf


def _learner_seed(seed: int) -> int:
    return inputs.sub_seed(seed, "learner")


def _learner(cfg: dict, seed: int, device):
    from onmf_ontf_ndl_tpu_torch.apps.ising import IsingReconstructor

    return IsingReconstructor(
        n_components=cfg["n_components"], lattice_size=cfg["lattice_size"],
        ising_iterations=cfg["rounds_per_call"],
        temperature=cfg["temperature"],
        ising_subsampling_steps=cfg["ising_subsampling_steps"],
        sub_iterations=cfg["sub_iterations"],
        num_patches=cfg["num_patches"], batch_size=cfg["batch_size"],
        patch_size=cfg["patch_size"], beta=cfg["beta"], J=cfg["J"],
        field=cfg["field"], alpha=cfg["alpha"], sampler=cfg["sampler"],
        update_lattice=cfg["update_lattice"], fast=cfg["fast"],
        seed=_learner_seed(seed), device=device)


def _differ(a, b) -> float:
    """Sites at which two lattices differ."""
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return float(np.sum(a != np.asarray(b)))


class Train:
    """Closed-loop training: each call is one ``ising_mcmc_learning``
    call on the one learner, whose state and lattice carry on from call
    to call: the initial round on the lattice as it stands (the per-round
    route), then ``rounds_per_call`` trajectory rounds (one captured
    graph, replayed: the checkerboard sweeps, the patches, the inner
    steps and the surrogate error). Each of the call's rounds runs
    ``sub_iterations - 1`` steps on all ``num_patches`` patches. Set-up
    builds the learner from the seed and makes the first call, which
    captures the round graph.

    The comparison is in two parts, as :class:`benchport.apps.network.
    Train`'s, since the early stop's threshold can stop a tile a sweep
    apart on the two sides: the set-up call from the seed (``start_*``,
    held to limits that such a split clears and the faults do not), and
    the window's first call (``w_gap``, ``a_gap``, ``b_gap``, ``c_gap``
    and its rounds' surrogate errors ``err_gap``: the reference's rounds
    from the program's W, A, B and C before that call). The lattice, which
    nothing of the learner touches, must agree exactly after both."""

    unit = "round"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.rounds = cfg["rounds_per_call"]
        self.kept = None

    def setup_inputs(self) -> None:
        """Nothing: the learner draws its lattice from the seed."""

    def _state(self):
        st = self.rec.state
        return (st.W.clone(), st.A.clone(), st.B.clone(), st.C.clone(),
                self.rec.lattice.clone())

    def setup(self) -> None:
        self.rec = _learner(self.cfg, self.seed, self.device)
        self.rec.ising_mcmc_learning()
        self.start = self._state()

    def call(self) -> int:
        self.rec.ising_mcmc_learning()
        if self.kept is None:
            self.kept = self._state() + (self.rec.errors.clone(),)
        return self.rounds + 1

    def patches_per_unit(self) -> int:
        return self.cfg["num_patches"] * (self.cfg["sub_iterations"] - 1)

    def counts(self) -> dict:
        cfg = self.cfg
        n = cfg["lattice_size"]
        return dict(d=cfg["patch_size"] ** 2, r=cfg["n_components"],
                    n=cfg["num_patches"], sub_iter=cfg["sub_iter"],
                    fixed=bool(cfg["fast"]), lattice=n,
                    sweeps=max(1, -(-cfg["ising_subsampling_steps"]
                                    // (n * n))))

    def release(self) -> None:
        del self.rec

    def reference(self, prec: onmf.Prec, start=None) -> dict:
        """The set-up call from the seed, then the window call from
        ``start`` (the program's W, A, B, C before it; the reference's
        own where None)."""
        lr = ref.Learner(_learner_seed(self.seed), self.cfg, self.device)
        lr.call(self.rounds, prec)
        first = (lr.st.W, lr.st.A, lr.st.B, lr.C, lr.lattice.copy())
        if start is not None:
            lr.st = onmf.State(W=start[0], A=start[1], B=start[2])
            lr.C = start[3]
        errors = lr.call(self.rounds, prec)
        return dict(first=first, W=lr.st.W, A=lr.st.A, B=lr.st.B, C=lr.C,
                    lattice=lr.lattice, errors=errors)

    def check(self, prec: onmf.Prec = onmf.Prec(), got=None) -> dict:
        start, end = (self.start, self.kept) if got is None else got
        want = self.reference(prec, start)
        first = want["first"]
        return {"start_w_gap": onmf.gap(start[0], first[0]),
                "start_a_gap": onmf.gap(start[1], first[1]),
                "start_b_gap": onmf.gap(start[2], first[2]),
                "w_gap": onmf.gap(end[0], want["W"]),
                "a_gap": onmf.gap(end[1], want["A"]),
                "b_gap": onmf.gap(end[2], want["B"]),
                "c_gap": onmf.gap(end[3], want["C"]),
                "err_gap": onmf.gap(end[5], want["errors"]),
                "lattice_differ": _differ(start[4], first[4])
                + _differ(end[4], want["lattice"])}

    def control(self) -> dict:
        """The reference in TF32 in the program's place: its set-up call
        from the seed, then its window call from its own state."""
        low = self.reference(onmf.Prec(tf32=True))
        return self.check(got=(low["first"], (
            low["W"], low["A"], low["B"], low["C"], low["lattice"],
            low["errors"])))

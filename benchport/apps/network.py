"""The network configuration's two traffic kinds, driven through the
port's ``NetworkReconstructor``: MCMC training rounds (``train_dict``)
and dense reconstructions (``reconstruct_network``)."""

from __future__ import annotations

import numpy as np
import torch

from benchport import inputs
from benchport.harness import Sample
from benchport.reference import network as ref
from benchport.reference import onmf


def _learner_seed(seed: int) -> int:
    return inputs.sub_seed(seed, "learner")


def _graph(cfg: dict, seed: int) -> np.ndarray:
    edges = inputs.ba_edges(cfg["nodes"], cfg["ba_m"], seed)
    return inputs.adjacency(edges, cfg["nodes"])


def _reconstructor(cfg: dict, adj: np.ndarray, seed: int, rounds: int,
                   device):
    from onmf_ontf_ndl_tpu_torch.apps.network import NetworkReconstructor

    return NetworkReconstructor(
        adjacency=adj, n_components=cfg["n_components"],
        MCMC_iterations=rounds, sub_iterations=cfg["sub_iterations"],
        sample_size=cfg["sample_size"], batch_size=cfg["batch_size"],
        k1=cfg["k1"], k2=cfg["k2"], alpha=cfg["alpha"],
        is_glauber_dict=True, is_glauber_recons=False, fast=cfg["fast"],
        num_chains=cfg["num_chains"], seed=_learner_seed(seed),
        device=device)


def _samples(cfg: dict) -> int:
    """A round's patches: ``sample_size`` rounded up to whole chains."""
    C = cfg["num_chains"]
    return -(-cfg["sample_size"] // C) * C


class Train:
    """Closed-loop training: each call is one ``train_dict`` call of the
    configuration's ``rounds_per_call`` MCMC rounds (the source's run:
    the chains' Glauber moves, their motif patches and
    ``sub_iterations - 1`` inner steps a round) on the one learner, whose
    state and chains carry on from call to call. Set-up makes the graph,
    builds the learner and makes the first call, which captures the round
    graph and replays it for the rest of its rounds.

    The early stop is a threshold: where a tile's change lies within
    float32 rounding of it, the program and the reference stop that tile
    a sweep apart, and the two runs go on from states that differ by up to
    ~2e-3 (one seed in 15 on the card). So the comparison is in two parts:
    the set-up call from the fresh state (``start_*``: the reference from
    the seed, held to limits that such a split clears and the faults do
    not), and the window's first call (``w_gap``, ``a_gap``, ``b_gap``:
    the reference's rounds from the program's W, A and B before that
    call; its chains and draws are the reference's own from the seed).
    The chains, which no stop touches, must agree exactly after both."""

    unit = "round"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.per_call = cfg["rounds_per_call"]
        self.kept = None

    def setup_inputs(self) -> None:
        self.adj = _graph(self.cfg, self.seed)

    def _state(self):
        st = self.rec.state
        return (st.W.clone(), st.A.clone(), st.B.clone(),
                self.rec.emb.clone())

    def setup(self) -> None:
        self.setup_inputs()
        self.rec = _reconstructor(self.cfg, self.adj, self.seed,
                                  self.per_call, self.device)
        self.rec.train_dict()
        self.start = self._state()

    def call(self) -> int:
        self.rec.train_dict()
        if self.kept is None:
            self.kept = self._state()
        return self.per_call

    def patches_per_unit(self) -> int:
        return _samples(self.cfg) * (self.cfg["sub_iterations"] - 1)

    def counts(self) -> dict:
        cfg = self.cfg
        k = cfg["k1"] + cfg["k2"] + 1
        return dict(d=k * k, r=cfg["n_components"], n=_samples(cfg),
                    sub_iter=cfg["sub_iter"], fixed=bool(cfg["fast"]))

    def release(self) -> None:
        del self.rec

    def reference(self, prec: onmf.Prec, start=None) -> dict:
        """The set-up call's rounds from the seed, then the window call's
        rounds from ``start`` (the program's W, A, B before it; the
        reference's own where None)."""
        lr = ref.Learner(ref.HostGraph(self.adj), _learner_seed(self.seed),
                         self.cfg, self.device)
        lr.rounds(self.per_call, prec)
        first = (lr.st.W, lr.st.A, lr.st.B, lr.emb.copy())
        if start is not None:
            lr.st = onmf.State(W=start[0], A=start[1], B=start[2])
        lr.rounds(self.per_call, prec)
        return dict(first=first, W=lr.st.W, A=lr.st.A, B=lr.st.B,
                    emb=lr.emb)

    def check(self, prec: onmf.Prec = onmf.Prec(), got=None) -> dict:
        start, end = (self.start, self.kept) if got is None else got
        want = self.reference(prec, start)
        first = want["first"]

        def chains(emb, ref_emb):
            emb = np.asarray(emb.cpu() if torch.is_tensor(emb) else emb)
            return float(np.sum(emb != ref_emb))

        return {"start_w_gap": onmf.gap(start[0], first[0]),
                "start_a_gap": onmf.gap(start[1], first[1]),
                "start_b_gap": onmf.gap(start[2], first[2]),
                "w_gap": onmf.gap(end[0], want["W"]),
                "a_gap": onmf.gap(end[1], want["A"]),
                "b_gap": onmf.gap(end[2], want["B"]),
                "chains_differ": chains(start[3], first[3])
                + chains(end[3], want["emb"])}

    def control(self) -> dict:
        """The reference in TF32 in the program's place: its set-up call
        from the seed, then its window call from its own state."""
        low = self.reference(onmf.Prec(tf32=True))
        f = low["first"]
        return self.check(got=(f, (low["W"], low["A"], low["B"],
                                   low["emb"])))


class Recon:
    """Closed-loop reconstruction: each job is one dense reconstruction
    of the graph from ``recons_iter`` pivot samples over
    ``recons_chains`` fresh chains, from the dictionary that set-up
    trained with ``setup_rounds`` MCMC rounds. A job ends at a
    synchronise. The first job of the window and a sample drawn from the
    seed are kept (their per-pair mean paints) and compared with the
    reference's jobs, made with the same draws from the dictionary the
    program trained in set-up: that training ends in the early stop, whose
    threshold splits the two runs' dictionaries on some seeds (see
    :class:`Train`), and ndl-train compares it."""

    unit = "job"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.kept = Sample(mix["kept_jobs"], seed)
        self.jobs = 0

    def setup_inputs(self) -> None:
        self.adj = _graph(self.cfg, self.seed)

    def setup(self) -> None:
        self.setup_inputs()
        self.rec = _reconstructor(self.cfg, self.adj, self.seed,
                                  self.cfg["setup_rounds"], self.device)
        self.rec.train_dict()
        self.W = self.rec.W.clone()
        for _ in range(self.mix["warm_jobs"]):
            self._job()

    def _job(self):
        self.rec.reconstruct_network(
            recons_iter=self.cfg["recons_iter"],
            num_chains=self.cfg["recons_chains"], sparse=False)
        return self.rec.recon_weights

    def call(self) -> int:
        self.kept.offer(self.jobs, self._job())
        self.jobs += 1
        return 1

    def patches_per_unit(self) -> int:
        C = self.cfg["recons_chains"]
        return -(-self.cfg["recons_iter"] // C) * C

    def counts(self) -> dict:
        cfg = self.cfg
        k = cfg["k1"] + cfg["k2"] + 1
        return dict(d=k * k, r=cfg["n_components"],
                    n=self.patches_per_unit(),
                    sub_iter=cfg["recons_sub_iter"], fixed=True)

    def release(self) -> None:
        del self.rec

    def reference(self, prec: onmf.Prec, W) -> dict:
        """The kept jobs from the dictionary W, on the reconstructor's
        draws from the seed (its learner is built, not trained: the
        rounds draw from the learner's own generator)."""
        g = ref.HostGraph(self.adj)
        lr = ref.Learner(g, _learner_seed(self.seed), self.cfg, self.device)
        at = _JobDraws(lr.gen, g.n, self.cfg, self.device)
        warm = self.mix["warm_jobs"]
        return {j: ref.reconstruct(g, W, at.job(warm + j), self.cfg, prec)
                for j in sorted(self.kept.items)}

    def check(self, prec: onmf.Prec = onmf.Prec(), got=None) -> dict:
        W, outs = (self.W, self.kept.items) if got is None else got
        want = self.reference(prec, W)
        return {"paint_gap": max(onmf.gap(outs[j], want[j]) for j in want)}

    def control(self) -> dict:
        """The reference in TF32 in the program's place: its dictionary
        from its own set-up rounds, then its jobs."""
        self.kept.first_jobs()
        prec = onmf.Prec(tf32=True)
        lr = ref.Learner(ref.HostGraph(self.adj), _learner_seed(self.seed),
                         self.cfg, self.device)
        lr.rounds(self.cfg["setup_rounds"], prec)
        return self.check(got=(lr.st.W, self.reference(prec, lr.st.W)))


class _JobDraws:
    """The draws of the reconstructions that follow on a generator from
    where it stands now, jobs numbered from 0: every job draws alike, so
    on the card job j's start is the offset one job advances it times j;
    on the CPU the draws of the jobs before it are made again."""

    def __init__(self, gen, n: int, cfg: dict, dev):
        self.gen, self.args = gen, (n, cfg, dev)
        cuda = gen.device.type == "cuda"
        self.start = gen.get_offset() if cuda else gen.get_state()
        self.stride = None
        if cuda:
            ref.job_draws(gen, *self.args)
            self.stride = gen.get_offset() - self.start

    def job(self, j: int):
        if self.stride is not None:
            self.gen.set_offset(self.start + j * self.stride)
        else:
            self.gen.set_state(self.start)
            for _ in range(j):
                ref.job_draws(self.gen, *self.args)
        return ref.job_draws(self.gen, *self.args)

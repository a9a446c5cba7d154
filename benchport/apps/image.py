"""The image configuration's two traffic kinds, driven through the port's
``ImageReconstructor``: training rounds (``train_dict``) and colour
reconstructions (``reconstruct_image_color``)."""

from __future__ import annotations

from benchport import inputs, peaks
from benchport.harness import Sample
from benchport.reference import image as ref
from benchport.reference import onmf


def _learner_seed(seed: int) -> int:
    return inputs.sub_seed(seed, "learner")


def _reconstructor(cfg: dict, img, seed: int, rounds: int, device):
    from onmf_ontf_ndl_tpu_torch.apps.image import ImageReconstructor

    return ImageReconstructor(
        data=img, n_components=cfg["n_components"], iterations=rounds,
        sub_iterations=cfg["sub_iterations"],
        num_patches=cfg["num_patches"], batch_size=cfg["num_patches"],
        patch_size=cfg["patch_size"], is_color=True, alpha=cfg["alpha"],
        fast=cfg["fast"], seed=_learner_seed(seed), device=device)


class Train:
    """Closed-loop training: each call is one ``train_dict`` call of the
    configuration's ``rounds_per_call`` rounds (the source's run), each
    round ``num_patches`` random patches and ``sub_iterations - 1`` inner
    steps, on the one learner, whose state carries on from call to call.
    Set-up makes the image, builds the learner and makes the first call,
    which captures the round graph and replays it for the rest of its
    rounds: every kernel the window runs has run. The state after the
    window's first call (a replay from the cached entry) is kept; the
    reference follows every round up to it."""

    unit = "round"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.per_call = cfg["rounds_per_call"]
        self.compared_rounds = 2 * self.per_call
        self.kept = None

    def setup_inputs(self) -> None:
        cfg = self.cfg
        self.img = inputs.images(self.seed, 1, cfg["height"], cfg["width"],
                                 self.device)[0]

    def setup(self) -> None:
        self.setup_inputs()
        self.rec = _reconstructor(self.cfg, self.img, self.seed,
                                  self.per_call, self.device)
        self.rec.train_dict()

    def call(self) -> int:
        self.rec.train_dict()
        if self.kept is None:
            st = self.rec.state
            self.kept = (st.W.clone(), st.A.clone(), st.B.clone())
        return self.per_call

    def patches_per_unit(self) -> int:
        return self.cfg["num_patches"] * (self.cfg["sub_iterations"] - 1)

    def counts(self) -> dict:
        cfg = self.cfg
        return dict(d=3 * cfg["patch_size"] ** 2, r=cfg["n_components"],
                    n=cfg["num_patches"], sub_iter=cfg["sub_iter"],
                    fixed=bool(cfg["fast"]))

    def release(self) -> None:
        del self.rec

    def reference(self, prec: onmf.Prec) -> dict:
        st = ref.train(self.img, _learner_seed(self.seed), self.cfg,
                       self.compared_rounds, prec)
        return dict(W=st.W, A=st.A, B=st.B)

    def check(self, prec: onmf.Prec = onmf.Prec(), got=None) -> dict:
        want = self.reference(prec)
        W, A, B = self.kept if got is None else got
        return {"w_gap": onmf.gap(W, want["W"]),
                "a_gap": onmf.gap(A, want["A"]),
                "b_gap": onmf.gap(B, want["B"])}

    def control(self) -> dict:
        """The reference in TF32 put in the program's place."""
        low = self.reference(onmf.Prec(tf32=True))
        return self.check(got=(low["W"], low["A"], low["B"]))


class Recon:
    """Closed-loop reconstruction: each job reconstructs one of ``inputs``
    images, in turn, at the configuration's stride, from the dictionary
    that set-up trained with ``setup_rounds`` rounds. A job ends at a
    synchronise. The first job of the window and a sample drawn from the
    seed are kept and compared with the reference."""

    unit = "job"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.kept = Sample(mix["kept_jobs"], seed)
        self.jobs = 0

    def setup_inputs(self) -> None:
        cfg = self.cfg
        self.imgs = inputs.images(self.seed, self.mix["inputs"],
                                  cfg["height"], cfg["width"], self.device)

    def setup(self) -> None:
        cfg = self.cfg
        self.setup_inputs()
        self.rec = _reconstructor(cfg, self.imgs[0], self.seed,
                                  cfg["setup_rounds"], self.device)
        self.rec.train_dict()
        self.W = self.rec.W.clone()
        for j in range(self.mix["warm_jobs"]):
            self._job(j)

    def _job(self, j: int):
        return self.rec.reconstruct_image_color(
            data=self.imgs[j % len(self.imgs)],
            recons_resolution=self.cfg["recons_stride"],
            alpha=self.cfg["recons_alpha"])

    def call(self) -> int:
        self.kept.offer(self.jobs, self._job(self.jobs))
        self.jobs += 1
        return 1

    def patches_per_unit(self) -> int:
        cfg = self.cfg
        return peaks.image_grid_patches(cfg["height"], cfg["width"],
                                        cfg["patch_size"],
                                        cfg["recons_stride"])

    def counts(self) -> dict:
        cfg = self.cfg
        return dict(d=3 * cfg["patch_size"] ** 2, r=cfg["n_components"],
                    n=self.patches_per_unit(), sub_iter=cfg["sub_iter"],
                    fixed=True)

    def release(self) -> None:
        del self.rec

    def reference(self, prec: onmf.Prec) -> dict:
        st = ref.train(self.imgs[0], _learner_seed(self.seed), self.cfg,
                       self.cfg["setup_rounds"], prec)
        outs = {j: ref.reconstruct(self.imgs[j % len(self.imgs)], st.W,
                                   self.cfg, prec) for j in self.kept.items}
        return dict(W=st.W, outs=outs)

    def check(self, prec: onmf.Prec = onmf.Prec(), got=None) -> dict:
        want = self.reference(prec)
        W, outs = (self.W, self.kept.items) if got is None else got
        return {"w_gap": onmf.gap(W, want["W"]),
                "image_gap": max(onmf.gap(outs[j], want["outs"][j])
                                 for j in want["outs"])}

    def control(self) -> dict:
        self.kept.first_jobs()
        low = self.reference(onmf.Prec(tf32=True))
        return self.check(got=(low["W"], low["outs"]))

"""The colour tensor configuration's reconstruction traffic, driven
through the port's ``ImageReconstructorTensor``: colour reconstructions
(``reconstruct_image_color``) from a joint dictionary that set-up learns
on the mode-2 unfolding of patch tensors (``train_dict(mode=2,
learn_joint_dict=True)``, FISTA with the configuration's stop unless
``fast``)."""

from __future__ import annotations

from benchport import inputs, peaks
from benchport.harness import Sample
from benchport.reference import onmf
from benchport.reference import tensor as ref


def _learner_seed(seed: int) -> int:
    return inputs.sub_seed(seed, "learner")


def _reconstructor(cfg: dict, img, seed: int, device):
    from onmf_ontf_ndl_tpu_torch.apps.image_tensor import (
        ImageReconstructorTensor)

    return ImageReconstructorTensor(
        data=img, n_components=cfg["n_components"],
        iterations=cfg["rounds_per_call"],
        sub_iterations=cfg["sub_iterations"], batch_size=cfg["batch_size"],
        block_iterations=cfg["block_iterations"],
        num_patches=cfg["num_patches"], patch_size=cfg["patch_size"],
        learn_joint_dict=cfg["learn_joint_dict"], alpha=cfg["alpha"],
        fast=cfg["fast"], coder=cfg["coder"], seed=_learner_seed(seed),
        device=device)


def _train(rec, cfg: dict):
    return rec.train_dict(mode=cfg["mode"],
                          learn_joint_dict=cfg["learn_joint_dict"])


class Recon:
    """Closed-loop reconstruction: each job reconstructs one of ``inputs``
    images, in turn, at the configuration's stride, by FISTA with
    ``sub_iter`` fixed iterations from the joint dictionary that set-up
    trained with one ``train_dict`` call. A job ends at a synchronise. The
    first job of the window and a sample drawn from the seed are kept and
    compared with the reference."""

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
        self.setup_inputs()
        self.rec = _reconstructor(self.cfg, self.imgs[0], self.seed,
                                  self.device)
        _train(self.rec, self.cfg)
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
                       self.cfg["rounds_per_call"], prec)
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

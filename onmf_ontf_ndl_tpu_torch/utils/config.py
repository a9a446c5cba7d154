"""Frozen dataclass configs for every workload.

Counterpart of ``onmf_ontf_ndl_tpu/utils/config.py``: the same five
dataclasses with the same fields, types and defaults, each with one more
field, ``device`` (the card by default; a CPU run passes ``"cpu"``).
``build()`` returns the port's app on that device. The CLI
(``onmf_ontf_ndl_tpu_torch.cli``) maps its flags onto these fields.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ImageConfig", "TensorConfig", "IsingConfig", "NetworkConfig",
           "VideoConfig"]


@dataclasses.dataclass(frozen=True)
class ImageConfig:
    path: str
    n_components: int = 25
    iterations: int = 200
    sub_iterations: int = 10
    num_patches: int = 10
    batch_size: int = 10
    downscale_factor: int = 10
    patch_size: int = 10
    is_matrix: bool = False
    is_color: bool = True
    alpha: float | None = None
    beta: float | None = None
    recons_resolution: int = 1
    coder: str = "bcd"
    seed: int = 0
    device: str = "cuda"

    def build(self):
        from onmf_ontf_ndl_tpu_torch.apps.image import ImageReconstructor

        return ImageReconstructor(
            path=self.path, n_components=self.n_components,
            iterations=self.iterations, sub_iterations=self.sub_iterations,
            num_patches=self.num_patches, batch_size=self.batch_size,
            downscale_factor=self.downscale_factor,
            patch_size=self.patch_size, is_matrix=self.is_matrix,
            is_color=self.is_color, alpha=self.alpha, beta=self.beta,
            seed=self.seed, coder=self.coder, device=self.device,
        )


@dataclasses.dataclass(frozen=True)
class TensorConfig:
    path: str
    n_components: int = 100
    iterations: int = 20
    sub_iterations: int = 2
    batch_size: int = 100
    block_iterations: int = 4
    num_patches: int = 100
    sub_num_patches: int = 5000
    downscale_factor: int = 2
    patch_size: int = 20
    mode: int = 2
    learn_joint_dict: bool = True
    is_color: bool = True
    alpha: float | None = None
    # the tensor pipeline's reference coder is an exact sklearn LARS
    # solve, so its default is the converged coder (PARITY.md C4)
    coder: str = "exact"
    seed: int = 0
    device: str = "cuda"

    def build(self):
        from onmf_ontf_ndl_tpu_torch.apps.image_tensor import (
            ImageReconstructorTensor)

        return ImageReconstructorTensor(
            path=self.path, n_components=self.n_components,
            iterations=self.iterations, sub_iterations=self.sub_iterations,
            batch_size=self.batch_size,
            block_iterations=self.block_iterations,
            num_patches=self.num_patches,
            sub_num_patches=self.sub_num_patches,
            downscale_factor=self.downscale_factor,
            patch_size=self.patch_size,
            learn_joint_dict=self.learn_joint_dict,
            is_color=self.is_color, alpha=self.alpha, seed=self.seed,
            coder=self.coder, device=self.device,
        )


@dataclasses.dataclass(frozen=True)
class IsingConfig:
    n_components: int = 100
    lattice_size: int = 200
    ising_iterations: int = 1
    temperature: float = 5.0
    ising_subsampling_steps: int = 500000
    sub_iterations: int = 20
    num_patches: int = 1000
    batch_size: int = 50
    patch_size: int = 20
    beta: float = 1.0
    sampler: str = "checkerboard"
    coder: str = "bcd"
    seed: int = 0
    device: str = "cuda"

    def build(self):
        from onmf_ontf_ndl_tpu_torch.apps.ising import IsingReconstructor

        return IsingReconstructor(
            n_components=self.n_components, lattice_size=self.lattice_size,
            ising_iterations=self.ising_iterations,
            temperature=self.temperature,
            ising_subsampling_steps=self.ising_subsampling_steps,
            sub_iterations=self.sub_iterations,
            num_patches=self.num_patches, batch_size=self.batch_size,
            patch_size=self.patch_size, beta=self.beta,
            sampler=self.sampler, seed=self.seed, coder=self.coder,
            device=self.device,
        )


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    source: str
    n_components: int = 25
    MCMC_iterations: int = 200
    sub_iterations: int = 100
    sample_size: int = 1000
    batch_size: int = 20
    k1: int = 0
    k2: int = 20
    # inert in the reference too ("keep it at 1"); ctor-surface parity
    loc_avg_depth: int = 1
    alpha: float | None = 1.0
    is_WAN: bool = False
    is_glauber_dict: bool = True
    is_glauber_recons: bool = False
    weighted_patches: bool = False
    recons_iter: int = 10000
    # scale knobs: fixed-sweep kernels, chain ensembles, bit-packed
    # adjacency, the O(samples)-memory sparse reconstruction
    fast: bool = False
    num_chains: int = 1
    recons_chains: int = 1
    use_bitset: bool = False
    # graph representation: "auto" honors use_bitset; "dense" | "bitset" |
    # "csr" select explicitly. graph_cache_dir is kept for the flag set:
    # the port builds a CSR graph on the host each time (the native loader
    # where it builds) and keeps no built-CSR cache, so it is not read.
    representation: str = "auto"
    graph_cache_dir: str | None = None
    coder: str = "bcd"
    seed: int = 0
    device: str = "cuda"

    def build(self):
        import numpy as np

        from onmf_ontf_ndl_tpu_torch.apps.network import NetworkReconstructor

        rep = self.representation
        if rep == "auto":
            rep = "bitset" if self.use_bitset else "dense"
        if rep not in ("dense", "bitset", "csr"):
            raise ValueError(
                f"representation must be 'auto', 'dense', 'bitset' or "
                f"'csr', got {self.representation!r}")
        common = dict(
            n_components=self.n_components,
            MCMC_iterations=self.MCMC_iterations,
            sub_iterations=self.sub_iterations,
            sample_size=self.sample_size, batch_size=self.batch_size,
            k1=self.k1, k2=self.k2, loc_avg_depth=self.loc_avg_depth,
            alpha=self.alpha, weighted_patches=self.weighted_patches,
            is_glauber_dict=self.is_glauber_dict,
            is_glauber_recons=self.is_glauber_recons,
            fast=self.fast, num_chains=self.num_chains, seed=self.seed,
            coder=self.coder, device=self.device)
        if self.is_WAN:
            if rep != "dense":
                raise ValueError(
                    "bitset/csr are for large edge-list graphs; WAN "
                    "weighted matrices use the dense representation")
            # WAN files are whitespace-delimited weighted matrices, not
            # edge lists
            return NetworkReconstructor(
                adjacency=np.genfromtxt(self.source), is_WAN=True, **common)
        if rep == "bitset":
            from onmf_ontf_ndl_tpu_torch.data.graphs import (
                load_edgelist_bitset)

            source = load_edgelist_bitset(self.source, device=self.device)
        elif rep == "csr":
            from onmf_ontf_ndl_tpu_torch.data.graphs import load_edgelist_csr

            source = load_edgelist_csr(self.source, device=self.device)
        else:
            source = self.source
        return NetworkReconstructor(source=source, **common)


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    path: str
    n_components: int = 100
    sub_iterations: int = 10
    num_patches: int = 200
    batch_size: int = 20
    patch_size: int = 7
    epochs: int = 1
    is_color: bool = True
    max_frames: int | None = None
    alpha: float | None = None
    coder: str = "bcd"
    seed: int = 0
    device: str = "cuda"

    def build(self):
        from onmf_ontf_ndl_tpu_torch.apps.video import VideoDictionaryLearner

        return VideoDictionaryLearner(
            path=self.path, n_components=self.n_components,
            sub_iterations=self.sub_iterations,
            num_patches=self.num_patches, batch_size=self.batch_size,
            patch_size=self.patch_size, is_color=self.is_color,
            alpha=self.alpha, max_frames=self.max_frames, seed=self.seed,
            coder=self.coder, device=self.device,
        )

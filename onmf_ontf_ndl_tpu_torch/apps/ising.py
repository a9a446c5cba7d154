"""Dictionary learning along an Ising MCMC trajectory, in PyTorch.

Counterpart of ``onmf_ontf_ndl_tpu/apps/ising.py`` (the reference's
``Ising_Reconstructor``): an initial learning round on random patches of
the lattice, then per trajectory step a lattice update and another round,
with the full ``C = agg X X^T`` statistic so that the surrogate error
``tr(W A W^T) - 2 tr(W B) + tr(C)`` is tracked after every round. The JAX
``lax.scan`` over rounds becomes one round function (the lattice update,
the corners, the patches, the inner steps, the snapshot of W and the
error, written at the round counter), captured once as a CUDA graph on the
card and replayed a round at a time (``models/onmf.py::_run_rounds``);
the checkerboard kernel reads the round's seed on the device. The initial
round runs before them, as the JAX learner runs it outside its scan.

Semantics kept from the JAX module: patches come from the raw +-1 lattice;
``errors`` and ``dict_stack`` have ``ising_iterations + 1`` entries;
``update_lattice=False`` reproduces the reference's released driver (the
in-loop lattice update commented out). Samplers: ``"exact"`` runs the
sequential Metropolis chain; ``"checkerboard"`` runs red/black sweeps
covering at least as many single-site updates, through the CUDA kernel on a
CUDA lattice; ``"checkerboard_pallas"`` is an alias of ``"checkerboard"``.
The sweeps' seed is drawn per round from the learner's generator
``gen``, into a device tensor; the exact chain, a host loop, keeps the rounds on the
per-round route.

With a process group (``parallel/dp.py::dp_ising_learning``) each rank
advances its own lattice from its own rank generator and the statistics of
every inner step are summed over the group, as the JAX learner's
``psum_axis`` does.

The record (``utils/profiling.py``, under a profiler session only): the
span ``ising.initial`` (with CUDA events) around the initial round, and
the count ``ising.site_updates``, the checkerboard's site updates a call
made (rounds x sweeps x n^2), added at the call's end.
"""

from __future__ import annotations

import functools

import torch

from onmf_ontf_ndl_tpu_torch.models.onmf import (_check_modes, _round_spec,
                                                 _run_rounds, rank_generator)
from onmf_ontf_ndl_tpu_torch.models.state import (
    OnmfState, entry_device, init_state, make_generator)
from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend
from onmf_ontf_ndl_tpu_torch.ops.patches import (extract_patches,
                                                 random_patch_corners)
from onmf_ontf_ndl_tpu_torch.samplers.ising import (checkerboard_sweeps,
                                                    init_lattice,
                                                    metropolis_chain)
from onmf_ontf_ndl_tpu_torch.utils.metrics import surrogate_error
from onmf_ontf_ndl_tpu_torch.utils.profiling import count, span, spanned

__all__ = ["IsingReconstructor", "ising_trajectory_learning",
           "display_errors"]

_SAMPLERS = ("exact", "checkerboard", "checkerboard_pallas")


def ising_trajectory_learning(
    state: OnmfState,
    lattice: torch.Tensor,
    gen: torch.Generator,
    *,
    ising_iterations: int,
    nsteps: int,
    num_patches: int,
    inner_iterations: int,
    batch_size: int,
    patch_size: int,
    J: float = 1.0,
    H_field: float = 0.0,
    T: float = 0.5,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float = 0.01,
    sampler: str = "checkerboard",
    update_lattice: bool = True,
    keep_trajectory: bool = False,
    use_stopping: bool = True,
    backend: str = "auto",
    subsample: bool = False,
    coder: str = "bcd",
    draws=None,
    group=None,
    capture: bool = True,
):
    """Trajectory learner. Returns ``(state, dict_stack, errors, lattice,
    trajectory)``: ``dict_stack`` (ising_iterations+1, d, r), ``errors``
    (ising_iterations+1,), and the per-step lattices (ising_iterations, n, n)
    or an (ising_iterations, 0, 0) placeholder without ``keep_trajectory``.

    ``gen`` (on the lattice's device) draws the patch corners and the
    samplers' randomness; the state's own generator draws the inner loop's.
    ``draws`` (tests): per round (the initial one first) a pair
    ``(corners, inner)`` as in ``apps.image.train_image_dict``.
    ``group``: a process group; ``gen`` becomes this rank's generator
    (:func:`~onmf_ontf_ndl_tpu_torch.models.onmf.rank_generator`) and the
    inner steps sum their statistics over the group. ``capture=False``:
    the rounds in a Python loop, as on the CPU.
    """
    if sampler not in _SAMPLERS:
        raise ValueError(f"sampler must be one of {_SAMPLERS}, got {sampler!r}")
    _check_modes("stale", coder)
    backend = resolve_backend(backend, state.W)
    k, n = patch_size, lattice.shape[0]
    stop = stopping_diff if use_stopping else None
    gen = rank_generator(gen, group)
    nsweeps = max(1, -(-nsteps // (n * n)))

    def train_round(rb, gen, ctx, advance):
        lat = rb.carry["lattice"]
        if advance and update_lattice:
            if sampler == "exact":
                lat.copy_(metropolis_chain(gen, lat, nsteps, J, H_field,
                                           T)[0])
            else:
                # the seed stays on the device: the kernel reads it there
                seed = torch.randint(0, 2**31 - 1, (1,), generator=gen,
                                     device=gen.device)
                lat.copy_(checkerboard_sweeps(seed, lat, nsweeps, J,
                                              H_field, T))
        if ctx.draw is not None:
            corners = tuple(torch.as_tensor(c, device=lat.device)
                            for c in ctx.draw[0])
        else:
            corners = random_patch_corners(gen, lat.shape, k, num_patches,
                                           device=lat.device)
        lp = rb.loop
        ctx.steps(extract_patches(lat.to(lp.W.dtype), corners, k))
        rb.outs["W"].index_copy_(0, rb.rnd, lp.W[None])
        rb.outs["errors"].index_copy_(0, rb.rnd, surrogate_error(
            lp.W, lp.A, lp.B, lp.C).reshape(1))
        if keep_trajectory and advance:
            rb.outs["trajectory"].index_copy_(0, rb.rnd, lat[None])

    if update_lattice:
        lattice = lattice.to(torch.int8)
    spec = _round_spec(num_patches, inner_iterations, batch_size, subsample,
                       alpha, sub_iter, stop, False, "stale", backend, coder,
                       group)
    dtype = state.W.dtype
    outs = {"W": (tuple(state.W.shape), dtype), "errors": ((), dtype)}
    kw = dict(iterations=inner_iterations, beta=beta, gen=gen,
              app=("ising", k, num_patches, n, nsweeps, nsteps, float(J),
                   float(H_field), float(T), sampler, update_lattice,
                   keep_trajectory), capture=capture)
    # the initial round, outside the scan as the JAX learner runs it: on
    # the per-round route (its steps replay the step graph)
    with span("ising.initial", on=lattice):
        state, _, carry, first = _run_rounds(
            state, None, spec, rounds=1, round_fn=functools.partial(
                train_round, advance=False), carry={"lattice": lattice},
            outs=outs, host_read=True,
            draws=None if draws is None else draws[:1], **kw)
    if keep_trajectory:
        outs["trajectory"] = ((n, n), lattice.dtype)
    state, _, carry, rest = _run_rounds(
        state, None, spec, rounds=ising_iterations,
        round_fn=functools.partial(train_round, advance=True), carry=carry,
        outs=outs, host_read=draws is not None or (
            update_lattice and sampler == "exact"),
        draws=None if draws is None else draws[1:], **kw)
    if update_lattice and sampler != "exact":
        # the sweeps' site updates: the initial round makes none
        count("ising.site_updates", ising_iterations * nsweeps * n * n)
    trajectory = rest.get("trajectory", lattice.new_zeros(
        (ising_iterations, 0, 0)))
    return (state, torch.cat([first["W"], rest["W"]]),
            torch.cat([first["errors"], rest["errors"]]), carry["lattice"],
            trajectory)


class IsingReconstructor:
    """Driver shell mirroring the reference's ``Ising_Reconstructor``.
    ``device`` places the lattice and the state; ``seed`` seeds the
    driver's generator, which draws the initial lattice and the state's
    seed."""

    def __init__(
        self,
        n_components: int = 100,
        lattice_size: int = 200,
        ising_iterations: int = 500,
        temperature: float = 0.5,
        ising_subsampling_steps: int = 100,
        sub_iterations: int = 20,
        num_patches: int = 1000,
        batch_size: int = 20,
        patch_size: int = 20,
        beta: float = 0.5,
        J: float = 1.0,
        field: float = 0.0,
        alpha: float = 0.0,
        sampler: str = "checkerboard",
        update_lattice: bool = True,
        fast: bool = False,
        coder: str = "bcd",
        subsample: bool = False,
        seed: int = 0,
        device="cuda",
        dtype=torch.float32,
    ):
        if sampler not in _SAMPLERS:
            raise ValueError(
                f"sampler must be one of {_SAMPLERS}, got {sampler!r}")
        _check_modes("stale", coder)
        self.n_components = n_components
        self.lattice_size = lattice_size
        self.ising_iterations = ising_iterations
        self.temperature = temperature
        self.ising_subsampling_steps = ising_subsampling_steps
        self.sub_iterations = sub_iterations
        self.num_patches = num_patches
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.beta = beta
        self.J = J
        self.field = field
        self.alpha = alpha
        self.sampler = sampler
        self.update_lattice = update_lattice
        self.fast = fast
        self.coder = coder
        self.subsample = subsample
        self.device = entry_device(device)
        self.dtype = dtype
        self.gen = make_generator(seed, self.device)
        self.lattice = init_lattice(self.gen, lattice_size)
        # the state draws from its own stream, seeded from the driver's
        state_seed = int(torch.randint(0, 2**62, (1,), generator=self.gen,
                                       device=self.device))
        # C = agg X X^T is tracked for the surrogate error
        self.state = init_state(state_seed, patch_size**2, n_components,
                                device=self.device, dtype=dtype,
                                track_xxt=True)
        self.W = self.state.W
        self.errors = None
        self.dict_stack = None

    @spanned("train.call")
    def ising_mcmc_learning(self, initial_lattice=None, keep_trajectory=False,
                            draws=None):
        """Learn along the trajectory; returns ``(trajectory, dict_stack,
        errors)``. ``initial_lattice`` (any +-1 array, floats included)
        replaces the lattice; ``draws`` as in
        :func:`ising_trajectory_learning`."""
        if initial_lattice is not None:
            self.lattice = torch.as_tensor(
                initial_lattice, device=self.device).to(torch.int8)
        (self.state, self.dict_stack, self.errors, self.lattice, traj
         ) = ising_trajectory_learning(
            self.state, self.lattice, self.gen,
            ising_iterations=self.ising_iterations,
            nsteps=self.ising_subsampling_steps,
            num_patches=self.num_patches,
            inner_iterations=self.sub_iterations,
            batch_size=self.batch_size,
            patch_size=self.patch_size,
            J=self.J, H_field=self.field, T=self.temperature,
            alpha=self.alpha, beta=self.beta,
            sampler=self.sampler, update_lattice=self.update_lattice,
            keep_trajectory=keep_trajectory,
            use_stopping=not self.fast,
            coder=self.coder,
            subsample=self.subsample,
            draws=draws,
        )
        self.W = self.dict_stack[-1]
        return traj, self.dict_stack, self.errors

    def reconstruct_config(self, config, patch_size: int | None = None):
        """Reconstruct a spin configuration from the learned dictionary:
        every patch of the (x+1)/2 rescaled configuration, overlap-averaged."""
        from onmf_ontf_ndl_tpu_torch.apps.image import reconstruct

        k = patch_size or self.patch_size
        data = (torch.as_tensor(config, device=self.device).to(self.dtype)
                + 1.0) / 2.0
        return reconstruct(data, self.W, make_generator(23, self.device),
                           patch_size=k, alpha=self.alpha, full_grid=True,
                           method=self.coder)


def display_errors(error_files: dict, *, lattice_sites: float = 40000.0,
                   total_updates: float = 500.0,
                   save_path: str | None = None, show: bool = False):
    """Errors-over-subsampling comparison plot: one surrogate error trace
    per subsampling epoch, x rescaled to a common span of
    ``total_updates``, y normalized by the lattice site count.

    ``error_files`` maps a label (e.g. "subsampling epoch of 1000") to a
    saved ``errors`` .npy path, an array or a tensor.
    """
    import numpy as np

    from onmf_ontf_ndl_tpu_torch.utils.viz import display_errors_comparison

    traces = {label: np.load(src) if isinstance(src, str) else src
              for label, src in error_files.items()}
    return display_errors_comparison(
        traces, total_updates=total_updates, normalize=lattice_sites,
        xlabel="effective epoch", ylabel="surrogate error / site",
        save_path=save_path, show=show)

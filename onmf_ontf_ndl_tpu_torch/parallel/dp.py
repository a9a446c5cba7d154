"""Data-parallel online NMF over a ``torch.distributed`` process group.

Counterpart of ``onmf_ontf_ndl_tpu/parallel/dp.py``. The online-NMF
aggregates are linear in the samples (``A`` accumulates ``H Hᵀ``, ``B``
accumulates ``H Xᵀ``), so the algorithm is exactly data-parallel: each
rank codes its own columns, the statistics are summed over the group, and
every rank runs the same dictionary update. The JAX package shards a batch
over a named mesh axis and ``psum``s; here a process group of one rank per
device takes the mesh's place (``group=None`` is the world group) and the
step ``all_reduce``s. Every entry point runs the same step and loop as the
one-process path (``models/onmf.py::_step_inner`` and ``_train_loop`` with
``group`` set): no forked maths.

Conventions:

- inputs that the JAX functions take sharded (a batch ``X``, its ``H0``,
  the Ising ensemble, the chains' embeddings) are given whole to every
  rank, which takes its own block (:func:`shard_batch`); per-sample outputs
  (codes, chain embeddings) come back as this rank's block, replicated
  ones (the state, the merged reconstruction) whole;
- each rank draws from its rank generator (``models/onmf.py::
  rank_generator``); ``draws=`` gives a rank its own draws instead;
- with fixed sweeps (``stopping_diff=None``, the default here) a step
  equals the one-process step on the concatenated batch; with the stop,
  each rank's stop sees only its columns;
- ``device`` (the card by default; a CPU run passes ``"cpu"``) places the
  data; the state must already be there. On the card the group is NCCL's,
  on the CPU gloo's (``parallel/multihost.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from onmf_ontf_ndl_tpu_torch.models.onmf import (_check_modes, _step_inner,
                                                 _train_loop, rank_generator)
from onmf_ontf_ndl_tpu_torch.models.state import OnmfState, entry_device
from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend

__all__ = ["dp_onmf_step", "dp_train_dict", "dp_train_image_dict",
           "dp_ndl_train", "dp_reconstruct_network_sparse",
           "merge_recon_shards", "dp_recons_edges", "shard_batch",
           "dp_ising_learning", "dp_train_tensor_dict"]


def _group(group):
    return group if group is not None else dist.group.WORLD


def _rank_block(x: torch.Tensor, group, dim: int, what: str) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (equal blocks)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[dim]
    if n % world:
        raise ValueError(f"{what} ({n}) must divide evenly over the "
                         f"{world} ranks")
    m = n // world
    return x.narrow(dim, rank * m, m).contiguous()


def _on(state: OnmfState, device) -> torch.device:
    """The state's device, which must be of the type ``device`` names."""
    device = entry_device(device)
    if state.W.device.type != device.type:
        raise ValueError(f"the state lies on {state.W.device}, not on "
                         f"{device}")
    return state.W.device


def shard_batch(X, group=None, *, device="cuda") -> torch.Tensor:
    """This rank's column block of a (d, n) batch, on ``device``; n must
    divide evenly over the group."""
    X = torch.as_tensor(X, device=entry_device(device))
    return _rank_block(X, _group(group), 1, "data columns")


def dp_onmf_step(
    state: OnmfState,
    X,
    t=None,
    *,
    H0=None,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float | None = None,
    dict_from: str = "stale",
    backend: str = "auto",
    coder: str = "bcd",
    group=None,
    device="cuda",
):
    """One data-parallel online-NMF step on the (d, n) batch ``X``, column
    blocks over the group; ``H0`` (r, n) likewise, drawn from the state's
    generator when omitted (the same draw on every rank, so the step equals
    the one-process step). Returns ``(state, H)``, H this rank's (r, n /
    world) block of the code."""
    _check_modes(dict_from, coder)
    group = _group(group)
    dev = _on(state, device)
    X = torch.as_tensor(X, dtype=state.W.dtype, device=dev)
    if t is None:
        t = state.t + 1.0
    if H0 is None:
        H0 = torch.rand((state.r, X.shape[1]), generator=state.gen,
                        dtype=state.W.dtype, device=dev)
    H0 = torch.as_tensor(H0, dtype=state.W.dtype, device=dev)
    Xl = _rank_block(X, group, 1, "data columns")
    return _step_inner(state, Xl, float(t),
                       _rank_block(H0, group, 1, "H0 columns"), alpha, beta,
                       int(sub_iter), stopping_diff, dict_from,
                       resolve_backend(backend, Xl), coder=coder, group=group)


def dp_train_dict(
    state: OnmfState,
    X,
    *,
    iterations: int,
    batch_size_per_device: int,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float | None = None,
    dict_from: str = "stale",
    backend: str = "auto",
    coder: str = "bcd",
    sampling: str = "iid",
    draws=None,
    group=None,
    device="cuda",
) -> OnmfState:
    """Data-parallel ``train_dict``: each rank subsamples
    ``batch_size_per_device`` columns of its block of ``X`` (d, n) each
    step, and the statistics are summed over the group; the global batch
    is ``batch_size_per_device * world``. Returns the final (replicated)
    state.

    ``stopping_diff`` defaults to ``None`` (fixed sweeps, unlike
    ``train_dict``'s 0.01); a value turns on the early stop, shard-local.
    ``sampling="block"`` permutes and block-slices each rank's own block.
    ``draws``: this rank's per-step ``(idx, H0)``, ``idx`` into its block.
    """
    _check_modes(dict_from, coder)
    group = _group(group)
    dev = _on(state, device)
    Xl = _rank_block(torch.as_tensor(X, dtype=state.W.dtype, device=dev),
                     group, 1, "data columns")
    st, _, _ = _train_loop(
        state, Xl, None, alpha, beta, stopping_diff, int(iterations),
        int(batch_size_per_device), True, int(sub_iter), False, dict_from,
        backend=resolve_backend(backend, Xl), sampling=sampling,
        draws=draws, coder=coder, group=group)
    return st


def dp_train_image_dict(
    state: OnmfState,
    img,
    *,
    outer_iterations: int,
    num_patches_per_device: int,
    inner_iterations: int,
    batch_size_per_device: int,
    patch_size: int,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float | None = None,
    dict_from: str = "stale",
    backend: str = "auto",
    coder: str = "bcd",
    draws=None,
    group=None,
    device="cuda",
) -> OnmfState:
    """Data-parallel image trainer: every rank samples its own random
    patches of the (replicated) image and runs the inner steps with the
    statistics summed over the group, the multi-device form of
    :func:`~onmf_ontf_ndl_tpu_torch.apps.image.train_image_dict`.
    ``stopping_diff``: ``None`` (default) runs fixed sweeps, a value the
    shard-local stop. ``draws``: this rank's, as ``train_image_dict``
    takes them."""
    from onmf_ontf_ndl_tpu_torch.apps.image import train_image_dict

    dev = _on(state, device)
    return train_image_dict(
        state, torch.as_tensor(img, dtype=state.W.dtype, device=dev),
        outer_iterations=int(outer_iterations),
        num_patches=int(num_patches_per_device),
        inner_iterations=int(inner_iterations),
        batch_size=int(batch_size_per_device), patch_size=int(patch_size),
        alpha=alpha, beta=beta, sub_iter=int(sub_iter),
        use_stopping=stopping_diff is not None,
        stopping_diff=0.01 if stopping_diff is None else stopping_diff,
        dict_from=dict_from, backend=backend, subsample=True, coder=coder,
        draws=draws, group=_group(group))


def dp_ising_learning(
    state: OnmfState,
    lattices,
    gen: torch.Generator,
    *,
    ising_iterations: int,
    nsteps: int,
    num_patches_per_device: int,
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
    use_stopping: bool = True,
    subsample: bool = False,
    coder: str = "bcd",
    backend: str = "auto",
    draws=None,
    group=None,
    device="cuda",
):
    """Data-parallel Ising trajectory learning: an ensemble of lattices,
    one per rank, each advanced by its own chain (the rank generator of
    ``gen``, which every rank passes alike), with the full statistics,
    ``X Xᵀ`` included, summed over the group every inner step: the
    multi-device form of
    :func:`~onmf_ontf_ndl_tpu_torch.apps.ising.ising_trajectory_learning`.

    ``lattices``: (world, L, L) +-1; rank r takes lattice r. Returns
    ``(state, dict_stack, errors, lattice)``: the first three replicated
    (the surrogate error comes from the summed aggregates), ``lattice``
    this rank's final one. ``draws``: this rank's, as the learner takes
    them.
    """
    from onmf_ontf_ndl_tpu_torch.apps.ising import ising_trajectory_learning

    group = _group(group)
    dev = _on(state, device)
    world = dist.get_world_size(group)
    lattices = torch.as_tensor(lattices, device=dev)
    if lattices.dim() != 3 or lattices.shape[0] != world:
        raise ValueError(
            f"dp_ising_learning: lattices must be (world={world}, L, L), "
            f"got {tuple(lattices.shape)}")
    if not state.tracks_xxt:
        # the surrogate error needs the C = agg X X^T statistic
        raise ValueError(
            "dp_ising_learning needs state.C (the X X^T aggregate) for "
            "the surrogate error: build the state with "
            "init_state(..., track_xxt=True)")
    lattice = lattices[dist.get_rank(group)].to(torch.int8).contiguous()
    st, dict_stack, errors, lattice, _ = ising_trajectory_learning(
        state, lattice, gen, ising_iterations=int(ising_iterations),
        nsteps=int(nsteps), num_patches=int(num_patches_per_device),
        inner_iterations=int(inner_iterations), batch_size=int(batch_size),
        patch_size=int(patch_size), J=J, H_field=H_field, T=T, alpha=alpha,
        beta=beta, sub_iter=int(sub_iter), stopping_diff=stopping_diff,
        sampler=sampler, update_lattice=update_lattice,
        keep_trajectory=False, use_stopping=use_stopping, backend=backend,
        subsample=subsample, coder=coder, draws=draws, group=group)
    return st, dict_stack, errors, lattice


def dp_train_tensor_dict(
    state: OnmfState,
    X,
    *,
    mode: int,
    learn_joint_dict: bool = False,
    iterations: int,
    batch_size_per_device: int,
    alpha: float = 2.0,
    beta: float = 1.0,
    sub_iterations: int = 10,
    coder: str = "exact",
    coder_sub_iter: int | None = None,
    stopping_diff: float | None = 0.01,
    backend: str = "auto",
    draws=None,
    group=None,
    device="cuda",
) -> OnmfState:
    """Data-parallel ONTF: mode-unfold the patch tensor, give each rank a
    block of the unfolded sample columns and run :func:`dp_train_dict`:
    the multi-device form of
    :meth:`~onmf_ontf_ndl_tpu_torch.models.ontf.OnlineNTF.train_dict_single`.
    Defaults follow the ONTF surface: ``alpha=2`` and ``coder="exact"``
    (FISTA with at least 100 iterations). The unfolded sample count must
    divide evenly over the group."""
    from onmf_ontf_ndl_tpu_torch.models.ontf import resolve_tensor_coder
    from onmf_ontf_ndl_tpu_torch.ops.unfold import unfold

    dev = _on(state, device)
    Xu = unfold(torch.as_tensor(X, dtype=state.W.dtype, device=dev), mode)
    if learn_joint_dict:
        Xu = Xu.T
    if Xu.shape[0] != state.W.shape[0]:
        raise ValueError(
            f"dp_train_tensor_dict: unfolded feature dim {Xu.shape[0]} "
            f"!= state dim {state.W.shape[0]} (mode={mode}, "
            f"joint={learn_joint_dict})")
    method, sub_iter = resolve_tensor_coder(coder, sub_iterations,
                                            coder_sub_iter)
    return dp_train_dict(
        state, Xu, iterations=iterations,
        batch_size_per_device=batch_size_per_device, alpha=alpha, beta=beta,
        sub_iter=sub_iter, stopping_diff=stopping_diff, coder=method,
        backend=backend, draws=draws, group=group, device=device)


def dp_ndl_train(
    state: OnmfState,
    g,
    emb0,
    B: np.ndarray,
    *,
    mcmc_iterations: int,
    sample_size_per_device: int,
    inner_iterations: int,
    batch_size: int,
    num_chains_per_device: int = 1,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float = 0.01,
    use_glauber: bool = True,
    weighted: bool = False,
    use_stopping: bool = True,
    subsample: bool = False,
    discard_first: bool = True,
    coder: str = "bcd",
    backend: str = "auto",
    draws=None,
    group=None,
    device="cuda",
):
    """Data-parallel network dictionary learning: every rank runs its own
    chain ensemble (``num_chains_per_device`` chains sampling
    ``sample_size_per_device`` patches a round, from its rank generator)
    and the statistics are summed over the group, so each dictionary
    update sees the whole ``sample_size_per_device * world`` sample.

    ``emb0``: (world * num_chains_per_device, k), rank r's chains in block
    r; the graph ``g`` is replicated. Returns ``(state, code, emb)``: the
    replicated state, this rank's (r, sample_size_per_device) code and its
    chains' final embeddings. ``draws``: this rank's, as ``ndl_train``
    takes them."""
    from onmf_ontf_ndl_tpu_torch.apps.network import ndl_train

    group = _group(group)
    dev = _on(state, device)
    emb0 = _rank_block(torch.as_tensor(emb0, device=dev), group, 0,
                       "chains")
    if num_chains_per_device == 1:
        emb0 = emb0[0]
    return ndl_train(
        state, g, emb0, B, mcmc_iterations=int(mcmc_iterations),
        sample_size=int(sample_size_per_device),
        inner_iterations=int(inner_iterations), batch_size=int(batch_size),
        alpha=alpha, beta=beta, sub_iter=int(sub_iter),
        stopping_diff=stopping_diff, use_glauber=use_glauber,
        weighted=weighted, use_stopping=use_stopping, backend=backend,
        num_chains=int(num_chains_per_device), subsample=subsample,
        discard_first=discard_first, coder=coder, draws=draws, group=group)


def _all_gather_padded(t: torch.Tensor, per: int, group) -> torch.Tensor:
    """Every rank's ``t`` padded with zeros to ``per`` entries, in rank
    order."""
    pad = torch.zeros(per, dtype=t.dtype, device=t.device)
    pad[:len(t)] = t
    out = [torch.empty_like(pad) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, pad, group=group)
    return torch.cat(out)


def dp_reconstruct_network_sparse(
    W: torch.Tensor,
    g,
    gen: torch.Generator,
    B: np.ndarray,
    *,
    recons_iter_per_device: int,
    num_chains_per_device: int = 1,
    alpha: float = 0.0,
    sub_iter: int = 30,
    use_glauber: bool = False,
    weighted: bool = False,
    method: str = "bcd",
    include_self: bool = True,
    embs=None,
    H0=None,
    group=None,
    device="cuda",
):
    """Sparse network reconstruction with the sample budget split over the
    group.

    Every rank runs its own ``num_chains_per_device``-chain ensemble (the
    rank generator of ``gen``, which every rank passes alike), codes and
    paints its ``recons_iter_per_device`` samples and groups them into
    per-pair (sum, count): the multi-device form of
    :func:`~onmf_ontf_ndl_tpu_torch.apps.network.reconstruct_network_sparse`.
    The per-edge mean over all samples is the ratio of the summed sums to
    the summed counts, so merging the ranks is exact
    (:func:`merge_recon_shards`).

    Returns ``(ii, jj, sums, cnt, n_seg)`` on every rank: the ranks'
    groupings gathered in rank order, each padded to the longest, and
    ``n_seg`` (world,) the real entries of each block (a prefix). ``embs``
    and ``H0`` (tests): this rank's, as ``reconstruct_network_sparse``
    takes them."""
    from onmf_ontf_ndl_tpu_torch.apps.network import (_group_painted,
                                                      _recon_sample_vals)

    group = _group(group)
    device = entry_device(device)
    if W.device.type != device.type:
        raise ValueError(f"W lies on {W.device}, not on {device}")
    embs_, vals_T = _recon_sample_vals(
        W, g, rank_generator(gen, group), B,
        recons_iter=int(recons_iter_per_device), alpha=alpha,
        sub_iter=int(sub_iter), use_glauber=use_glauber, weighted=weighted,
        num_chains=int(num_chains_per_device), method=method, embs=embs,
        H0=H0)
    parts = _group_painted(embs_, vals_T, g.num_nodes,
                           include_self=include_self)
    count = torch.tensor([len(parts[0])], dtype=torch.int64, device=W.device)
    n_seg = [torch.empty_like(count)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(n_seg, count, group=group)
    n_seg = torch.cat(n_seg)
    per = int(n_seg.max())
    ii, jj, sums, cnt = (_all_gather_padded(p, per, group) for p in parts)
    return ii, jj, sums, cnt, n_seg


def merge_recon_shards(ii, jj, sums, cnt, n_seg, n: int):
    """Exact merge of per-rank groupings of painted pairs.

    The inputs are ``len(n_seg)`` equal blocks, block d holding its
    ``n_seg[d]`` real entries as a prefix (as
    :func:`dp_reconstruct_network_sparse` returns them; tensors or
    arrays). The blocks' prefixes are folded pairwise by
    ``apps/network.py::_merge_grouped`` (one int64 key sort and a segment
    sum), in int64 and float64. Returns ``(pi, pj, mean, count)`` over the
    distinct pairs in ascending (i, j) order, ``mean = sum / count``:
    the reference's per-edge running average over the union of all ranks'
    samples."""
    from onmf_ontf_ndl_tpu_torch.apps.network import _merge_grouped

    counts = [int(c) for c in torch.as_tensor(n_seg).reshape(-1).tolist()]
    arrays = [torch.as_tensor(a) for a in (ii, jj, sums, cnt)]
    per = arrays[0].shape[0] // len(counts)
    acc = None
    for d, c in enumerate(counts):
        lo = d * per
        ii_d, jj_d, s_d, c_d = (a[lo:lo + c] for a in arrays)
        shard = (ii_d.to(torch.int64), jj_d.to(torch.int64),
                 s_d.to(torch.float64), c_d.to(torch.float64))
        acc = shard if acc is None else _merge_grouped(acc, shard, n)
    pi, pj, gs, gc = acc
    return pi, pj, gs / gc.clamp_min(1.0), gc


def dp_recons_edges(W, g, gen, B, **kwargs) -> np.ndarray:
    """:func:`dp_reconstruct_network_sparse`, merged
    (:func:`merge_recon_shards`), as the undirected simple-graph edge
    array (pairs whose rounded mean is positive, self-loops dropped), the
    semantics of ``NetworkReconstructor.recons_edges``."""
    from onmf_ontf_ndl_tpu_torch.apps.network import _undirected_simple_edges

    # self-pairs only paint self-loops, which the simple graph drops
    kwargs.setdefault("include_self", False)
    ii, jj, sums, cnt, n_seg = dp_reconstruct_network_sparse(
        W, g, gen, B, **kwargs)
    pi, pj, mean, _ = merge_recon_shards(ii, jj, sums, cnt, n_seg,
                                         g.num_nodes)
    keep = torch.round(mean) > 0
    return _undirected_simple_edges(pi[keep].cpu().numpy(),
                                    pj[keep].cpu().numpy())

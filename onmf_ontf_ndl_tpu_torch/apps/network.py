"""Network dictionary learning (NDL) and network reconstruction in PyTorch.

Counterpart of ``onmf_ontf_ndl_tpu/apps/network.py`` (the reference's
``Network_Reconstructor``):

- training (``train_dict``): per MCMC iteration a chain ensemble emits
  ``sample_size`` k x k motif patches, then ``sub_iterations`` online-NMF
  steps run on them (code tracked, ``dict_from="stale"``), the state
  threading across iterations, one round of ``models/onmf.py::
  _run_rounds`` an iteration; the code of the first iteration is
  discarded, as the reference does;
- reconstruction: fresh chains from uniform pivots emit patches, every
  patch is coded against W with fixed sweeps (``stopping_diff=None``) and
  its ``W @ H`` values are painted onto the node pairs of its embedding;
  the per-pair mean of the paints, rounded, is the reconstructed simple
  graph. The dense form returns (N, N) canvases, the sparse form the
  painted pairs only;
- accuracy: ``|E(G_recons & G)| / |E(G)|``.

On a CUDA graph and state, the coder and dictionary kernels of
``ops/kernels`` run every coding step: the early stop in training by
default, fixed sweeps with ``fast=True`` and in reconstruction, FISTA
with ``coder="fista"``. The chains and the patches are plain PyTorch on
the same device, apart from the chains' moves: on the card each block of
a reconstruction's chain moves is a replay of one captured CUDA graph
that launches the chain kernel once (``samplers/motif.py::run_chains``),
and each training round (its chains' blocks, patches and steps) a replay
of another.

The grouping of the paints by pair is
``ops/kernels/group_kernel.py::group_pairs`` (on the card a narrow key, a
stable radix sort and a run sum in an order the tiling fixes, with no
atomics; on the CPU the torch sort and segment sum), so the rounding
``round(mean) > 0`` is the same on every run. Randomness: the chains
of training draw from the state's generator (so a checkpoint carries
them), the reconstructor's generator draws the initial chains and the
reconstruction.

Sample budgets past the card's memory run in chunks
(:func:`reconstruct_network_sparse_chunked`): each chunk is a sparse
reconstruction of its own, and the per-pair (sum, count) of the chunks
merge exactly.

Data parallelism (``parallel/dp.py``): ``ndl_train(group=...)`` samples
each rank's chains from its rank generator and sums the statistics over
the group (the JAX ``psum_axis``); the sharded reconstruction merges the
ranks' per-pair (sum, count) with :func:`_merge_grouped`. The TPU
host-link fetch forms of the edge decode (uint32 packing, the CSR-slot bit
mask, power-of-two compaction) are not carried over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from onmf_ontf_ndl_tpu_torch.data.graphs import (
    BitsetGraph, CsrGraph, Graph, graph_from_adjacency, host_csr,
    load_edgelist)
from onmf_ontf_ndl_tpu_torch.models.onmf import (_check_modes, _round_spec,
                                                 _run_rounds, rank_generator)
from onmf_ontf_ndl_tpu_torch.models.state import (
    OnmfState, entry_device, init_state, make_generator)
from onmf_ontf_ndl_tpu_torch.ops.coder import nonneg_code
from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend
from onmf_ontf_ndl_tpu_torch.ops.kernels.group_kernel import group_pairs
from onmf_ontf_ndl_tpu_torch.samplers.motif import (
    _chain_baked, _chain_block_moves, _chain_blocks, _chain_kind,
    _chain_reads, _has_edges, _pair_tables, pair_matrices_T, path_adj,
    run_chains, tree_parents, tree_sample)
from onmf_ontf_ndl_tpu_torch.utils.profiling import span, spanned

__all__ = ["NetworkReconstructor", "ndl_train", "reconstruct_network",
           "reconstruct_network_sparse", "reconstruct_network_sparse_chunked"]


def ndl_train(
    state: OnmfState,
    g,
    emb0: torch.Tensor,
    B: np.ndarray,
    *,
    mcmc_iterations: int,
    sample_size: int,
    inner_iterations: int,
    batch_size: int,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float = 0.01,
    use_glauber: bool = True,
    weighted: bool = False,
    use_stopping: bool = True,
    backend: str = "auto",
    num_chains: int = 1,
    subsample: bool = False,
    discard_first: bool = True,
    coder: str = "bcd",
    draws=None,
    group=None,
    capture: bool = True,
):
    """NDL training. Returns ``(state, code, emb)``; ``code`` is the
    (r, sample_size) sum of the codes of every iteration but the first
    (with ``discard_first=False``, of every iteration: a continuation of
    an interrupted run discards nothing again).

    ``emb0`` is the (k,) embedding of one chain, or (num_chains, k); with
    ``num_chains > 1`` each iteration's patches come from the ensemble,
    ``ceil(sample_size / num_chains)`` moves per chain, and
    ``sample_size`` rounds up to a multiple of ``num_chains``.
    One iteration is a round of ``models/onmf.py::_run_rounds``: the
    chains' blocks (``run_chains``), their patches, the inner steps with
    the code tracked and, at round 0 with ``discard_first``, the code
    reset on the device (the JAX scan's ``where(i == 0, code,
    code_new)``); on the card it is captured once as a CUDA graph, the
    chains' blocks unrolled in it, and replayed a round at a time.
    ``draws`` (tests): per iteration ``(X, inner)``, the (k^2,
    sample_size) patch matrix in place of the chains' and the inner
    steps' ``(idx, H0)`` draws for ``_train_loop`` (None: drawn).
    ``group``: a process group; each rank runs its own chains, drawn from
    its rank generator, and the statistics are summed over the group.
    ``capture=False`` (tests and the card's comparisons) runs the rounds,
    the chains and the training steps in Python loops where on the card
    they would replay captured graphs; both routes draw the same
    numbers."""
    _check_modes("stale", coder)
    backend = resolve_backend(backend, state.W)
    k = B.shape[0]
    chains = emb0.reshape(-1, k)
    per = sample_size
    if num_chains > 1:
        per = -(-sample_size // num_chains)
        sample_size = per * num_chains
    dtype = state.W.dtype
    code = torch.zeros((state.r, sample_size), dtype=dtype,
                       device=state.W.device)
    stop = stopping_diff if use_stopping else None
    chain_gen = rank_generator(state.gen, group) if draws is None \
        else state.gen
    if mcmc_iterations <= 0:
        return state, code, emb0

    def round_fn(rb, gen, ctx):
        if ctx.draw is not None:
            X = ctx.draw[0]
        else:
            emb = rb.carry["chains"]
            trail = run_chains(gen, g, emb, B, per, use_glauber=use_glauber,
                               capture=ctx.graphs)
            X = pair_matrices_T(g, trail.reshape(-1, k), weighted=weighted)
            emb.copy_(trail[:, -1])
        ctx.steps(X.to(dtype))
        if discard_first:
            rb.loop.code.copy_(torch.where(rb.rnd == 0, 0.0, rb.loop.code))

    kind = _chain_kind(use_glauber, k)
    roots = sum(p < 0 for p in tree_parents(B))
    blocks = sum(times for _, times in _chain_blocks(
        per, _chain_block_moves(chains.shape[0], k, kind, per, roots)))
    reads = _chain_reads(g, B, kind, state.W.device)
    if weighted and getattr(g, "weight", None) is not None:
        reads += (g.weight,)
    elif not weighted:          # pair_matrices_T's index tables
        reads += _pair_tables(k, state.W.device)
    spec = _round_spec(sample_size, inner_iterations, batch_size, subsample,
                       alpha, sub_iter, stop, True, "stale", backend, coder,
                       group)
    state, code, carry, _ = _run_rounds(
        state, code, spec, rounds=mcmc_iterations,
        iterations=inner_iterations, beta=beta, round_fn=round_fn,
        gen=chain_gen, app=("network", per, weighted, discard_first,
                            *_chain_baked(g, B, use_glauber,
                                          state.W.device.type)),
        reads=reads, carry={"chains": chains.to(torch.int64)},
        blocks=blocks, host_read=draws is not None, draws=draws,
        capture=capture)
    return state, code, carry["chains"].reshape(emb0.shape)


def _recon_sample_vals(W, g, gen, B, *, recons_iter: int, alpha=0.0,
                       sub_iter=30, use_glauber=False, weighted=False,
                       num_chains=1, method="bcd", embs=None, H0=None):
    """The reconstruction's front half: chain-sample the embeddings, code
    their patches with fixed sweeps, return ``(embs (M, k), vals_T
    (k*k, M))``, ``vals_T[q*k + r, m]`` the painted value of pair (q, r)
    in sample m. ``recons_iter`` rounds up to a multiple of the chain
    count; sample m belongs to chain ``m // per``.

    ``embs`` and ``H0`` (tests) replace the chains' embeddings and the
    coder's start iterate."""
    k = B.shape[0]
    if embs is None:
        with span("recon.chains", on=W):
            chains = max(1, num_chains)
            per = -(-recons_iter // chains)
            pivots = torch.randint(0, g.num_nodes, (chains,), generator=gen,
                                   device=W.device)
            emb0 = tree_sample(gen, tree_parents(B), g, pivots)
            embs = run_chains(gen, g, emb0, B, per,
                              use_glauber=use_glauber).reshape(-1, k)
    if weighted and getattr(g, "weight", None) is None:
        raise ValueError("weighted reconstruction needs a weighted Graph")
    with span("recon.patches", on=W):
        X = pair_matrices_T(g, embs, weighted=weighted).to(W.dtype)
    with span("recon.code", on=W):
        H = nonneg_code(X, W, H0, generator=gen, alpha=alpha,
                        sub_iter=sub_iter, stopping_diff=None, method=method)
        return embs, W @ H


# the grouping of the paints by pair (its one description: ``group_pairs``);
# the name is the JAX package's, for ``parallel/dp.py`` and the equality tests
_group_painted = group_pairs


def reconstruct_network(W, g, gen, B, *, recons_iter: int, alpha=0.0,
                        sub_iter=30, use_glauber=False, weighted=False,
                        num_chains=1, method="bcd", embs=None, H0=None):
    """Dense reconstruction: ``(recon_weights, overlap_count)``, (N, N),
    the mean paint and the paint count of every pair (0 where unpainted).
    The rounded simple graph is ``(recon.round() > 0) & (count > 0)``.
    Spans: those of :func:`_recon_sample_vals` (``recon.chains``,
    ``recon.patches``, ``recon.code``: the coder and W H), ``recon.paint``
    (the two matrices, zeroed) and ``recon.group`` (the grouping, which
    writes the painted pairs into them)."""
    embs, vals_T = _recon_sample_vals(
        W, g, gen, B, recons_iter=recons_iter, alpha=alpha,
        sub_iter=sub_iter, use_glauber=use_glauber, weighted=weighted,
        num_chains=num_chains, method=method, embs=embs, H0=H0)
    n = g.num_nodes
    with span("recon.paint", on=W):
        canvas = [torch.zeros((n, n), dtype=W.dtype, device=W.device)
                  for _ in range(2)]
    with span("recon.group", on=W):
        return _group_painted(embs, vals_T, n, canvas=canvas)


def reconstruct_network_sparse(W, g, gen, B, *, recons_iter: int, alpha=0.0,
                               sub_iter=30, use_glauber=False,
                               weighted=False, num_chains=1, method="bcd",
                               include_self=True, embs=None, H0=None):
    """Sparse reconstruction: O(samples) memory, no (N, N) canvas. Returns
    ``(ii, jj, mean, cnt)`` over the distinct painted directed pairs
    (``include_self`` as in :func:`_group_painted`); the rounded simple
    graph is the pairs with ``round(mean) > 0``."""
    embs, vals_T = _recon_sample_vals(
        W, g, gen, B, recons_iter=recons_iter, alpha=alpha,
        sub_iter=sub_iter, use_glauber=use_glauber, weighted=weighted,
        num_chains=num_chains, method=method, embs=embs, H0=H0)
    with span("recon.group", on=W):
        ii, jj, sums, cnt = _group_painted(embs, vals_T, g.num_nodes,
                                           include_self=include_self)
    return ii, jj, sums / cnt, cnt


def _merge_grouped(acc, chunk, n: int):
    """Merge two groupings ``(ii, jj, sums, cnt)`` of distinct pairs into
    one, ascending in (i, j): a pair in both adds its sums and counts. One
    int64 key ``i * n + j`` (no wrap at any n), sorted, then a segment
    sum."""
    key = torch.cat([acc[0] * n + acc[1], chunk[0] * n + chunk[1]])
    skey, order = torch.sort(key, stable=True)
    keys, lengths = torch.unique_consecutive(skey, return_counts=True)
    sums = torch.segment_reduce(torch.cat([acc[2], chunk[2]])[order], "sum",
                                lengths=lengths)
    cnt = torch.segment_reduce(torch.cat([acc[3], chunk[3]])[order], "sum",
                               lengths=lengths)
    return keys // n, keys % n, sums, cnt


def reconstruct_network_sparse_chunked(W, g, gen, B, *, recons_iter: int,
                                       chunks: int, cap: int | None = None,
                                       alpha=0.0, sub_iter=30,
                                       use_glauber=False, weighted=False,
                                       num_chains=1, method="bcd", embs=None,
                                       H0=None):
    """Sample budgets past the card's memory: the sparse reconstruction in
    ``chunks`` independent pieces, each piece's per-pair (sum, count)
    merged into an accumulator of the distinct pairs painted so far.

    Each piece runs ``ceil(recons_iter / chunks)`` samples, rounded up to
    a multiple of ``num_chains``, on fresh chains from fresh uniform pivots
    (``chunks`` repetitions of the reference's fresh-chain reconstruction,
    painted into one pool). Its working set (code iterate, painted values,
    sort keys) is that of the smaller budget; the accumulator holds the
    distinct pairs only. A mean merges exactly from (sum, count) pieces:
    the counts are exact, the sums add in float. Piece c draws from a
    generator seeded with the c-th of ``chunks`` seeds drawn from ``gen``
    up front; a single piece draws from ``gen`` itself and equals
    :func:`reconstruct_network_sparse` with ``include_self=False``.

    Raises ``ValueError``, naming the piece, when the distinct pairs
    outgrow ``cap`` (default: twice a piece's paints,
    ``2 m k max(k - 1, 1)``); the check is exact, nothing is truncated.
    Returns ``(ii, jj, mean, cnt)`` under the contract of
    :func:`reconstruct_network_sparse` with ``include_self=False``, every
    slot real (``cnt > 0``), ascending in (i, j).

    ``embs`` and ``H0`` (tests): one entry per piece, as in
    :func:`_recon_sample_vals`.

    The JAX function's bitonic merge in power-of-two buckets, its
    partitioned fold (``fold_parts``), the ``ONMF_FOLD_*`` and
    ``ONMF_CHUNK_PROGRESS`` environment knobs and the uint32 edge packing
    are left behind: they bound recompiles and memory on the TPU and carry
    no meaning of their own.
    """
    if chunks < 1:
        raise ValueError(f"chunks must be positive, got {chunks}")
    k = B.shape[0]
    chains = max(1, num_chains)
    per_chunk = -(-recons_iter // chunks)
    m_chunk = -(-per_chunk // chains) * chains
    if cap is None:
        cap = 2 * m_chunk * k * max(k - 1, 1)
    gens = [gen] * chunks
    if chunks > 1 and gen is not None:
        seeds = torch.randint(0, 2**62, (chunks,), generator=gen,
                              device=gen.device).tolist()
        gens = [make_generator(seed, gen.device) for seed in seeds]
    acc = None
    for c in range(chunks):
        e, vals_T = _recon_sample_vals(
            W, g, gens[c], B, recons_iter=per_chunk, alpha=alpha,
            sub_iter=sub_iter, use_glauber=use_glauber, weighted=weighted,
            num_chains=num_chains, method=method,
            embs=None if embs is None else embs[c],
            H0=None if H0 is None else H0[c])
        chunk = _group_painted(e, vals_T, g.num_nodes, include_self=False)
        acc = chunk if acc is None else _merge_grouped(acc, chunk,
                                                       g.num_nodes)
        if len(acc[0]) > cap:
            raise ValueError(
                f"chunked reconstruction overflowed the {cap}-slot "
                f"accumulator at chunk {c + 1}/{chunks} ({len(acc[0])} "
                "distinct pairs); raise cap")
    ii, jj, sums, cnt = acc
    return ii, jj, sums / cnt, cnt


def _edges_from_sparse_result(ii, jj, mean, cnt) -> np.ndarray:
    """The simple-graph edges of a sparse reconstruction: the directed
    pairs whose rounded mean is positive, folded to sorted unique
    undirected (lo, hi) host pairs without self-loops."""
    keep = (cnt > 0) & (torch.round(mean) > 0)
    return _undirected_simple_edges(ii[keep].cpu().numpy(),
                                    jj[keep].cpu().numpy())


def _undirected_simple_edges(pi, pj) -> np.ndarray:
    """Directed pairs -> sorted unique undirected (lo, hi) edges, self
    loops dropped (the reference's rounding to a simple graph)."""
    lo, hi = np.minimum(pi, pj), np.maximum(pi, pj)
    off_diag = lo != hi
    key = np.unique((lo[off_diag].astype(np.int64) << 32)
                    | hi[off_diag].astype(np.int64))
    return np.stack([key >> 32, key & 0xFFFFFFFF], axis=1)


class NetworkReconstructor:
    """The reference's ``Network_Reconstructor``, as the JAX package has it.

    ``source`` is a graph (:class:`Graph`, :class:`CsrGraph`,
    :class:`BitsetGraph`) or an edge-list path; else ``adjacency`` (WAN
    matrices with ``is_WAN=True``). ``device`` places the graph, the chains
    and the state; ``seed`` seeds the reconstructor's generator, which
    draws the initial chains, the state's seed and the reconstructions."""

    def __init__(
        self,
        source=None,
        adjacency=None,
        n_components: int = 100,
        MCMC_iterations: int = 500,
        sub_iterations: int = 100,
        sample_size: int = 1000,
        batch_size: int = 10,
        k1: int = 1,
        k2: int = 2,
        loc_avg_depth: int = 1,
        alpha: float | None = None,
        is_WAN: bool = False,
        is_glauber_dict: bool = True,
        is_glauber_recons: bool = True,
        weighted_patches: bool = False,
        fast: bool = False,
        coder: str = "bcd",
        num_chains: int = 1,
        subsample: bool = False,
        seed: int = 0,
        device="cuda",
        dtype=torch.float32,
    ):
        _check_modes("stale", coder)
        self.device = entry_device(device)
        if isinstance(source, (Graph, BitsetGraph, CsrGraph)):
            self.G = source.to(self.device)
        elif source is not None:
            self.G = load_edgelist(source, device=self.device)
        elif adjacency is not None:
            self.G = graph_from_adjacency(adjacency, normalize=is_WAN,
                                          device=self.device)
        else:
            raise ValueError("NetworkReconstructor: provide source or "
                             "adjacency")
        self.n_components = n_components
        self.MCMC_iterations = MCMC_iterations
        self.sub_iterations = sub_iterations
        self.sample_size = sample_size
        self.batch_size = batch_size
        self.k1, self.k2 = k1, k2
        self.loc_avg_depth = loc_avg_depth   # inert, as in the reference
        self.alpha = 0.0 if alpha is None else float(alpha)
        self.is_glauber_dict = is_glauber_dict
        self.is_glauber_recons = is_glauber_recons
        self.weighted_patches = weighted_patches
        self.fast = fast                     # fixed sweeps, no early stop
        self.coder = coder
        self.subsample = subsample
        self.dtype = dtype
        self.num_chains = max(1, int(num_chains))
        self.B = path_adj(k1, k2)
        k = k1 + k2 + 1
        self.gen = make_generator(seed, self.device)
        x0 = torch.randint(0, self.G.num_nodes, (self.num_chains,),
                           generator=self.gen, device=self.device)
        emb = tree_sample(self.gen, tree_parents(self.B), self.G, x0)
        # one chain: a (k,) embedding, as the JAX class keeps it
        self.emb = emb if self.num_chains > 1 else emb[0]
        state_seed = int(torch.randint(0, 2**62, (1,), generator=self.gen,
                                       device=self.device))
        self.state = init_state(state_seed, k * k, n_components,
                                device=self.device, dtype=dtype)
        self.code = torch.zeros((n_components, sample_size), dtype=dtype,
                                device=self.device)
        self.G_recons = None
        self.G_recons_edges = None
        self.recon_weights = None

    @property
    def W(self):
        return self.state.W

    @W.setter
    def W(self, value):
        self.state = dataclasses.replace(self.state, W=torch.as_tensor(
            value, dtype=self.dtype, device=self.device))

    def _run(self, mcmc: int, discard_first: bool):
        self.state, code_new, self.emb = ndl_train(
            self.state, self.G, self.emb, self.B,
            mcmc_iterations=mcmc, sample_size=self.sample_size,
            inner_iterations=self.sub_iterations,
            batch_size=self.batch_size, alpha=self.alpha,
            use_glauber=self.is_glauber_dict,
            weighted=self.weighted_patches, use_stopping=not self.fast,
            coder=self.coder, num_chains=self.num_chains,
            subsample=self.subsample, discard_first=discard_first)
        return code_new

    @spanned("train.call")
    def train_dict(self, checkpoint_path: str | None = None,
                   checkpoint_every: int = 0, resume: bool = False):
        """Run NDL training; returns the (k^2, r) dictionary.

        ``checkpoint_every=N`` runs the MCMC loop in chunks of N
        iterations, equal to the uninterrupted run; with
        ``checkpoint_path`` each chunk ends in a checkpoint of the state,
        the chains (``extra_emb``) and the code (``extra_code``), in the
        layout of ``utils/checkpoint.py`` that the JAX package reads and
        writes too. ``resume=True`` continues from that checkpoint: the
        completed iterations are ``t // sub_iterations``. Without chunks,
        codes accumulate across calls as in the reference (each call
        discarding its own first iteration)."""
        if (checkpoint_path or resume) and checkpoint_every <= 0:
            raise ValueError(
                "checkpoint_path/resume require checkpoint_every > 0 "
                "(otherwise the request would be silently ignored and "
                "training restarted from scratch)")
        if checkpoint_every > 0 and not checkpoint_path:
            total = None
            done = 0
            while done < self.MCMC_iterations:
                chunk = min(checkpoint_every, self.MCMC_iterations - done)
                code_new = self._run(chunk, discard_first=(done == 0))
                total = code_new if total is None else total + code_new
                done += chunk
            self.code = (self.code + total
                         if self.code.shape == total.shape else total)
        elif checkpoint_path:
            from onmf_ontf_ndl_tpu_torch.utils.checkpoint import (
                checkpoint_exists, load_state, save_state)

            if self.sub_iterations <= 1:
                raise ValueError(
                    "checkpointed training needs sub_iterations > 1 (the "
                    "resume count is recovered from the schedule counter, "
                    "which sub_iterations <= 1 does not advance)")
            if self.state.t != 0.0 and not resume:
                raise ValueError(
                    "checkpointed training starts from a fresh state "
                    "(t = 0); for a warm-started state the t-derived "
                    "resume count would be wrong")
            done = 0
            if resume and checkpoint_exists(checkpoint_path):
                self.state, extra = load_state(
                    checkpoint_path, device=self.device, dtype=self.dtype,
                    with_extra=True)
                self.emb = extra["emb"].long()
                self.code = extra["code"].to(self.dtype)
                done = int(round(self.state.t)) // self.sub_iterations
            while done < self.MCMC_iterations:
                chunk = min(checkpoint_every, self.MCMC_iterations - done)
                code_new = self._run(chunk, discard_first=(done == 0))
                self.code = self.code + code_new if done else code_new
                done += chunk
                save_state(checkpoint_path, self.state,
                           extra={"emb": self.emb.cpu().numpy(),
                                  "code": self.code.cpu().numpy()})
        else:
            code_new = self._run(self.MCMC_iterations, discard_first=True)
            self.code = (self.code + code_new
                         if self.code.shape == code_new.shape else code_new)
        return self.state.W

    @spanned("recon.job")
    def reconstruct_network(self, recons_iter: int = 100, alpha: float = 0.0,
                            num_chains: int | None = None,
                            sparse: bool | None = None, chunks: int = 1,
                            cap: int | None = None):
        """Reconstruct the network. ``sparse=False`` returns the dense
        boolean (N, N) simple graph; ``sparse=True`` the (num_edges, 2)
        int64 array of undirected edges, with O(samples) memory;
        ``sparse=None`` picks dense for a :class:`Graph` and sparse for the
        CSR and bitset graphs. ``num_chains`` defaults to the instance's.
        ``chunks > 1`` (sparse only) runs the budget in pieces merged
        through an accumulator of at most ``cap`` distinct pairs: see
        :func:`reconstruct_network_sparse_chunked`."""
        if num_chains is None:
            num_chains = self.num_chains
        if sparse is None:
            sparse = isinstance(self.G, (BitsetGraph, CsrGraph))
        if chunks > 1 and not sparse:
            raise ValueError("chunks > 1 requires the sparse path")
        kw = dict(recons_iter=recons_iter, alpha=alpha,
                  use_glauber=self.is_glauber_recons,
                  weighted=self.weighted_patches, num_chains=num_chains,
                  method=self.coder)
        if not sparse:
            recon, cnt = reconstruct_network(self.state.W, self.G, self.gen,
                                             self.B, **kw)
            self.recon_weights = recon
            simple = (torch.round(recon) > 0) & (cnt > 0)
            self.G_recons = simple | simple.T
            self.G_recons_edges = None
            return self.G_recons
        if chunks > 1:
            ii, jj, mean, cnt = reconstruct_network_sparse_chunked(
                self.state.W, self.G, self.gen, self.B, chunks=chunks,
                cap=cap, **kw)
        else:
            ii, jj, mean, cnt = reconstruct_network_sparse(
                self.state.W, self.G, self.gen, self.B, include_self=False,
                **kw)
        self.recon_weights = None
        self.G_recons = None
        self.G_recons_edges = _edges_from_sparse_result(ii, jj, mean, cnt)
        return self.G_recons_edges

    def recons_edges(self) -> np.ndarray:
        """(num_edges, 2) undirected edges (indices) of the last
        reconstruction, whichever form it took."""
        if self.G_recons_edges is not None:
            return self.G_recons_edges
        if self.G_recons is None:
            raise ValueError("no reconstruction yet; call "
                             "reconstruct_network() first")
        rec = self.G_recons.cpu().numpy().copy()
        np.fill_diagonal(rec, False)
        return np.argwhere(np.triu(rec))

    def write_edgelist(self, path: str, delimiter: str = ","):
        """Write the reconstructed simple graph as an edge list in the
        original node labels (the reference's ``nx.write_edgelist``)."""
        ids = np.asarray(self.G.node_ids)
        with open(path, "w") as f:
            for i, j in self.recons_edges():
                f.write(f"{ids[i]}{delimiter}{ids[j]}\n")
        return path

    def compute_A_recons(self, path: str, delimiter: str = ","):
        """Dense adjacency of a reconstructed edge-list file in this
        graph's node order; labels outside the graph are dropped."""
        idx = {label: i for i, label in enumerate(self.G.node_ids)}
        n = self.G.num_nodes
        A = np.zeros((n, n), np.float64)
        raw = np.genfromtxt(path, delimiter=delimiter, dtype=np.int64)
        for a, b in raw.reshape(-1, 2):
            ia, ib = idx.get(int(a)), idx.get(int(b))
            if ia is not None and ib is not None:
                A[ia, ib] = A[ib, ia] = 1.0
        return A

    def label_of(self, index: int):
        """Array index -> original node label."""
        return self.G.node_ids[int(index)]

    def index_of(self, label) -> int:
        """Original node label -> array index."""
        return self.G.node_ids.index(label)

    def display_dict(self, title: str = "", save_filename: str | None = None,
                     show: bool = False):
        """Motif-dictionary grid (``utils/viz.py``)."""
        from onmf_ontf_ndl_tpu_torch.utils.viz import (
            display_network_dictionary)

        k = self.k1 + self.k2 + 1
        return display_network_dictionary(
            self.W, k, title=title or None, save_path=save_filename,
            show=show)

    def show_cov(self, save_path=None, show=False):
        """Trace-normalized covariance of the accumulated code matrix."""
        from onmf_ontf_ndl_tpu_torch.utils.metrics import code_covariance

        cov = code_covariance(self.code)
        if save_path or show:
            import matplotlib
            if save_path and not show:
                matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(4, 4.5),
                                   subplot_kw={"xticks": [], "yticks": []})
            im = ax.imshow(cov.cpu().numpy())
            fig.colorbar(im)
            if save_path:
                fig.savefig(save_path, bbox_inches="tight")
            if show:
                plt.show()
            plt.close(fig)
        return cov

    def has_edge(self, i, j) -> np.ndarray:
        """Vectorized edge test on any representation; host arrays in and
        out."""
        i = torch.as_tensor(np.asarray(i, np.int64), device=self.device)
        j = torch.as_tensor(np.asarray(j, np.int64), device=self.device)
        return _has_edges(self.G, i, j).cpu().numpy()

    def _dense_adjacency(self) -> np.ndarray:
        g = self.G
        if isinstance(g, Graph):
            return g.adj.cpu().numpy()
        n = g.num_nodes
        host = host_csr(g)
        dst = host[1] if host is not None else g.nbr_flat.cpu().numpy()
        adj = np.zeros((n, n), bool)
        adj[np.repeat(np.arange(n), g.deg.cpu().numpy()), dst] = True
        return adj

    def compute_recons_accuracy(self, G_recons=None) -> float:
        """``|E(G & G_recons)| / |E(G)|`` for the dense boolean matrix or
        the sparse (num_edges, 2) edge array of :meth:`reconstruct_network`
        (default: the last reconstruction's)."""
        if G_recons is None:
            G_recons = (self.G_recons if self.G_recons is not None
                        else self.G_recons_edges)
        rec = (G_recons.cpu().numpy() if isinstance(G_recons, torch.Tensor)
               else np.asarray(G_recons))
        total = self.G.num_edges
        if rec.ndim == 2 and rec.shape[1] == 2 and rec.dtype != bool:
            if len(rec) == 0:
                return 0.0
            common = int(self.has_edge(rec[:, 0], rec[:, 1]).sum())
            return common / max(total, 1)
        rec = rec.copy()
        np.fill_diagonal(rec, False)
        common = int(np.logical_and(self._dense_adjacency(), rec).sum()) // 2
        return common / max(total, 1)

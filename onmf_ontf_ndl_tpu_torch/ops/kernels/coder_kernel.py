"""Hand-written CUDA kernels for the coders and the dictionary update of
online NMF.

Counterpart of ``onmf_ontf_ndl_tpu/ops/pallas/coder_kernel.py``. The
kernels are in ``csrc/onmf_kernels.cu``, built into the library of
:func:`~onmf_ontf_ndl_tpu_torch.ops.kernels._lib.build` with the Ising
sampler of ``ising_kernel.py``. Nothing is built or loaded at import.

- :func:`coder_sweeps` replaces the TPU ``coder_sweeps`` (``:192``):
  exactly ``sub_iter`` Gauss-Seidel nonnegative-LASSO row sweeps from Gram
  form. The shared-memory kernel (``coder_lanes_kernel``, r <= 128) is the
  early-stop kernel's sweep without the stop: each pair of columns has two
  lanes (four past r = 32), each holding its rows of the columns' ``h`` and
  of the residuals ``g = A h - b`` in registers from ``H0`` to the output.
  A coordinate step is the owner's candidate, one shuffle of its delta and
  independent multiply-adds per lane, each value of A (transposed in
  shared memory, read as ``float4``) serving both columns; there is no
  tile in shared memory and no barrier after the load, so several blocks
  share an SM. ``g`` is formed anew from ``A h - b`` every 16 sweeps up to
  r = 32 and every sweep past it (:func:`coder_lanes_config`): carried in
  float32 over ten sweeps at r = 128 it drifts 5e-5 from the plain
  version, past the tolerance. What bounds it on the card: the
  ``sub_iter * r^2`` multiply-adds per column on the CUDA cores, and within
  a column the chain of r coordinate steps a sweep (the B/H0/H traffic is
  ~39 MB per call at n = 131072, r = 25: ~12 us at HBM speed).
- :func:`coder_sweeps_earlystop` replaces ``coder_sweeps_earlystop``
  (``:455``): the same sweeps with the reference's relative spectral-change
  stop decided per column tile of **TN = 128 columns** (one thread block).
  After each sweep the block forms the (r, r) Grams of the sweep delta and
  of the old iterate in shared memory and decides with certified bounds
  first (Rayleigh lower bound after one warm power step; min(trace,
  Gershgorin) upper bound) and ``pi_iters`` warm power steps only in the
  band between them. A converged tile leaves its loop. The tile is part of
  the semantics (PARITY.md deviation #8): the TPU kernel's tile is up to
  13056 columns, this one is 128, so on a batch wider than 128 columns the
  two freeze different column sets. The shared-memory kernel
  (``coder_es_lanes_kernel``, r <= 100) gives each pair of columns two
  lanes (four past r = 32), each holding its rows of the columns'
  residuals ``g = A h - b`` in registers: a coordinate step is one
  shuffle of the owner's delta and independent multiply-adds per lane,
  each value of A read from shared memory serving both columns, not an
  r-long dependent dot product; the two Grams come from one pass over
  the whole block, and the stop decision's two power iterations run on
  two warps at once. What bounds it: the r^2 multiply-adds per column and
  sweep, and as many for the Grams, on the CUDA cores, fed by shared
  memory at a quarter of their rate. Shared memory (at r = 100 within
  3 r^2 + 2 r (TN + 1) + 5 r floats) limits it to r <= 100. Where the
  tiles are too few to fill the card and r > 32 (:func:`coder_es_cluster`:
  8 tiles at n = 1000, r = 100, on 132 SMs), each tile runs on a thread
  block cluster of S = 4 or 8 CTAs (the same kernel, its cluster form):
  each holds TN / S of the columns, 16 or 32 lanes a pair of them, an
  owner's block of coordinates first on a copy of its rows and then its
  deltas to every lane; the decision's products come from the columns,
  each CTA's part stored in every CTA's shared memory and summed there in
  rank order, so every CTA decides on the same values; the traces and the
  largest diagonal entries decide where they can, else the Grams' blocks
  go to their rows' owners for the Gershgorin bounds. The columns'
  arithmetic is the one-CTA kernel's, so H is equal bit for bit where the
  sweeps agree; the sums come in another order, so a tile within rounding
  of the threshold may stop a sweep apart.
- :func:`fista_sweeps` replaces ``fista_sweeps`` (``:579``): accelerated
  projected gradient ``H <- max(0, Y - (A Y - B + alpha) / L)`` with
  Nesterov momentum, one block per tile of **TN = 128 columns**. The
  shared-memory kernel (``fista_tiled_kernel``) forms the (r, TN) product
  ``A Y`` as a register-tiled matrix product over the whole block: one
  thread per 4 rows x 8 columns of the output (128 threads at r = 25, 416
  at r = 100, so a one-tile call fills an SM's schedulers), each step of
  the sum taking one ``float4`` of A (transposed in shared memory) and two
  of Y for 32 multiply-adds. Y lives in shared memory row-major, H
  transposed, B's entries of a thread's outputs in registers; a barrier
  separates the product from the update of Y and the update from the next
  product. ``1 / L`` (``L = 1.02 lambda_max(A) + 1e-12``, 16 power steps
  from :func:`_fixed_start`) is computed once per call, outside the sweep
  kernel: by one block in a launch of its own on the card (each product's
  rows over the warps), by :func:`_inv_lipschitz` in the plain version.
  ``use_stopping`` stops each tile on the early-stop kernel's rule: the
  step delta is written, transposed, over the spent Y, both Grams come
  from one pass over 4 x 4 register blocks of their upper triangles, and
  the decision is the early-stop kernel's, each Gram's power steps on half
  of the block's warps (one thread per row). The tile's momentum stops
  with it. As for the early stop, the tile is part of the
  semantics: the Pallas tile is as wide as VMEM allows (up to 13056
  columns at r = 25, 3968 at r = 100), this one is 128. ``bf16_matmul``
  rounds A and Y to bf16 before the multiply-add and accumulates in f32,
  each output summed in order. What bounds it: the ``r^2`` multiply-adds
  per column and iteration, and as many again for the Grams with the stop,
  on the CUDA cores (float32: the tensor cores' TF32 product does not hold
  the tolerance over 100 iterations, and the Grams feed a threshold).
  Shared memory: ``r R4 + 2 TN RS`` floats for fixed iterations (``R4`` =
  r rounded up to a multiple of 4, ``RS`` = ``R4`` or ``R4 + 4``, whichever
  has an odd quarter; r <= 128), plus both Grams and six vectors for the
  stop (r <= 100: 225 KB, one block per SM). Past those ranks the wide
  kernel (``fista_wide_kernel``, :func:`fista_wide_config`) carries the
  same register tiling to ranks whose A and tiles do not fit an SM: one
  block of up to 512 threads per tile and SM, the grid striding over the
  tiles, the rows of the product in passes of up to 128, A^T staged from a
  table in device memory in chunks of 32 rows j by ``cp.async`` into two
  shared buffers, Y in shared memory up to :data:`FW_RESIDENT_MAX_RANK`
  ("resident") and past it in the block's workspace slice, staged with
  each chunk ("streamed"); the new columns go to the slice, and one
  barrier after the last pass H and Y are updated. With the stop (kernels
  of their own) the two Grams come from register blocks over the tile
  staged transposed in shared memory (4 x 4, or 8 x 8 where those would
  take the threads more than two rounds), in column chunks, stored as
  float4 row segments, and the decision is the tiled kernel's; the Grams
  and power vectors stay in shared memory up to r = 136 and go to the
  slice past it.
- :func:`dict_update_sweep` replaces ``dict_update_sweep`` (``:629``): one
  column-BCD pass over W in residual form. ``G = W A`` is formed once in
  shared memory; the columns then go in panels of :data:`_DICT_PANEL`, one
  thread a row holding its row's G over the panel (less B's rows), the old
  columns and A's block in registers, so that a column step is register
  arithmetic, one warp's shuffle sum and one exchange of the warps' partial
  sums (a named barrier in one CTA; in a cluster, stores into every CTA
  that complete its own mbarrier), and after each panel one rank-k update
  of the rest of G. Any A, symmetric or not, matches
  :func:`~onmf_ontf_ndl_tpu_torch.ops.dict_update.dict_update_bcd`. What
  bounds it: the r sequential column steps, not the roofline. The rows go
  to one CTA or to a thread block cluster of up to 8 CTAs
  (:func:`dict_route`); past the cluster's shared memory the single-block
  kernel (W in device memory, threads over the rows) runs.

**Ranks.** Each coder has two kernels, chosen by :func:`kernel_route`
from r alone: ``"shared"`` keeps A, the tiles and the Grams in one block's
shared memory and registers (the kernels above; the limits are
:data:`SMEM_MAX_RANK`); ``"workspace"`` runs a wide kernel: one block of
512 threads per tile and SM, the grid striding over the tiles, A's table
at the head of a device workspace staged through shared memory by
``cp.async`` in chunks, and what does not fit an SM (the tiles, the Grams,
the power vectors) in the block's slice of the workspace, one slice per
SM. For the two Gauss-Seidel coders it is ``coder_wide_kernel``
(:func:`coder_wide_config`): the sweep in direct form, the plain
version's own (``g = A[k, :] h - b_k + alpha``, then the step on row k):
8 lanes share a column up to r = 256 (16 up to 512, 32 past it), each
holding its float4 slots of the rows of two columns in registers and
summing them against A's row into four accumulators; a butterfly of
shuffles gives every lane the dot product and the row's owner takes the
step. Each float4 of A's row, staged 16 rows at a time with the same rows
of B's columns, feeds eight multiply-adds; the tile's 128 columns go in
one pass up to r = 256 and in 2 or 4 passes past it, A streamed again for
each. With the stop the Grams and the decision are the wide FISTA
kernel's. The residual form of the shared kernels needs ``g`` formed anew
every sweep past r = 32 (twice the multiply-adds), and its float32 rank-1
updates put it 1.3e-5 (r = 256) to 3.9e-5 (r = 512) from the plain
version after ten sweeps in a host emulation, where the direct form stays
within 7e-7. For FISTA the workspace route is the wide kernel above. Both
serve every r up to :data:`MAX_RANK` = 1248, the largest r whose Gram the
JAX wrappers keep in their kernel (``round_up(r, 8)^2 * 4 B <= 6 MiB``,
``pallas/coder_kernel.py:147``). Past it the wrappers do what the JAX
wrappers do: the same maths without a kernel (``ops.coder._code_impl``,
whose early stop is the whole-batch rule, and ``_fista_impl``), on the
tensor's device; ``"unfused"`` routes count no launch. What bounds the
wide Gauss-Seidel kernel: the sweep's r^2 multiply-adds a column (and with
the stop the Grams' as many again) on the CUDA cores, each A operand a
shared-memory load shared by two columns, and within a column the chain of
r coordinate steps.

The TPU blocking (``block_rows``/``_block_corr``, the (8, 128) padding of
``_tile_plan``, SMEM staging) is not carried over.

Each wrapper runs its plain PyTorch version (``*_plain``, the same function)
only for a CPU tensor. For a CUDA tensor it launches the kernel or raises,
and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import math

import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (
    ES_MAX_CLUSTER, LAUNCHES, TN, _es_cluster_min, _on_cpu, _raise_on_error,
    _sm_count, _stream, build, reset_launches)

__all__ = ["coder_sweeps", "coder_sweeps_earlystop", "fista_sweeps",
           "dict_update_sweep", "coder_sweeps_plain",
           "coder_sweeps_earlystop_plain", "fista_sweeps_plain",
           "dict_update_sweep_plain", "build", "LAUNCHES", "reset_launches",
           "TN", "MAX_RANK", "SMEM_MAX_RANK", "kernel_route", "dict_route",
           "coder_es_cluster", "ES_MAX_CLUSTER",
           "coder_lanes_config", "coder_wide_config", "fista_tile_config",
           "fista_wide_config",
           "FW_RESIDENT_MAX_RANK"]

# Largest rank each coder runs as a kernel: the JAX kernels' limit
# round_up(r, 8)^2 * 4 B <= 6 MiB, for every mode.
MAX_RANK = 1248
# Largest rank of each shared-memory kernel; the workspace kernel above it.
SMEM_MAX_RANK = {
    "coder_sweeps": 128,            # 4 lanes of 32 rows in registers
    "coder_sweeps_earlystop": 100,  # 3 r^2 + 2 r (TN + 1) floats in 227 KB
    "fista_sweeps": 128,            # 512 threads of 4 x 8 outputs
    "fista_sweeps_stop": 100,       # + both Grams, as the early stop
}
# Workspace of the wide kernels: at most this many bytes of slices; one
# block of 512 threads is resident per SM, so one slice per SM.
_WS_BYTES = 1 << 30
# The wide FISTA kernel (csrc FW_*): threads, rows j of a staged chunk, the
# largest rank whose tile of Y stays in shared memory, and the shared floats
# a transposed Gram chunk may take (224 KB: r = 384's Y and chunks).
_FW_MAX_THREADS = 512
_FW_CHUNK = 32
FW_RESIDENT_MAX_RANK = 384
_FW_SMEM_FLOATS = 57344
# The wide Gauss-Seidel kernel (csrc CW_*, cw_regime): threads, rows of A
# a staged chunk, and the regimes by rank: the largest r, lanes a column,
# columns a thread and float4 slots a lane.
_CW_THREADS = 512
_CW_CHUNK = 16
_CW_REGIMES = ((128, 8, 2, 4), (192, 8, 2, 6), (256, 8, 2, 8),
               (512, 16, 2, 8), (1280, 32, 2, 10))


def kernel_route(name: str, r: int) -> str:
    """Which form a coder takes at rank ``r``, from ``r`` alone:
    ``"shared"`` (the shared-memory kernel), ``"workspace"`` (the
    workspace kernel) or ``"unfused"`` (past :data:`MAX_RANK`, the plain
    maths, as the JAX wrapper does). ``name`` is a key of
    :data:`SMEM_MAX_RANK`."""
    if r <= SMEM_MAX_RANK[name]:
        return "shared"
    return "workspace" if r <= MAX_RANK else "unfused"


def coder_es_cluster(r: int, n: int, sms: int = 132) -> int:
    """CTAs a tile of the shared-memory :func:`coder_sweeps_earlystop`
    kernel takes at rank ``r`` on ``n`` columns and a card of ``sms`` SMs,
    from those alone: for 32 < r <= 100, the largest power of two S from
    the form's least (4; 8 past r = 64) to :data:`ES_MAX_CLUSTER` whose
    clusters take at most 7/8 of the SMs (``tiles * S * 8 <= sms * 7``),
    each tile's columns then split over a thread block cluster of S CTAs
    that decide its stop together; else 1 (one CTA a tile). The clusters
    are meant to be resident at once: on an H100 at r = 100 (one CTA an
    SM) clusters of 8 hold 120 of its 132 SMs. Up to r = 32 one CTA a tile
    is the faster: a sweep's two exchanges across the cluster cost more
    than its short chains and small Grams save (ndl-train, r = 25 on 4
    tiles, on an H100: 2.45M and 2.39M patches/s on clusters of 4 and 8
    against 2.59M-2.62M on one CTA a tile)."""
    tiles = -(-n // TN)
    S = _es_cluster_min(r)
    if not S or tiles < 1 or tiles * S * 8 > sms * 7:
        return 1
    while 2 * S <= ES_MAX_CLUSTER and tiles * 2 * S * 8 <= sms * 7:
        S *= 2
    return S


def coder_lanes_config(r: int) -> tuple[int, int, int]:
    """``(L, Q, reform)`` of the shared-memory :func:`coder_sweeps` kernel
    at rank ``r``, from ``r`` alone (csrc ``es_lanes``,
    ``cs_rows_per_lane``, ``CS_REFORM``): L lanes per pair of columns, Q
    rows of ``h`` and ``g = A h - b`` per lane, and ``g`` formed anew every
    ``reform`` sweeps."""
    if not 1 <= r <= SMEM_MAX_RANK["coder_sweeps"]:
        raise ValueError(f"no shared-memory coder_sweeps kernel at r={r}")
    L = 2 if r <= 32 else 4
    Q = 8 if r <= 16 else 16 if r <= 64 else 25 if r <= 100 else 32
    return L, Q, (16 if L * Q <= 32 else 1)


def fista_tile_config(r: int, use_stopping: bool = False):
    """``(threads, row_stride, gram_lanes, smem_bytes)`` of the
    shared-memory :func:`fista_sweeps` kernel at rank ``r``, from ``r`` and
    the mode alone (csrc ``ft_threads``, ``ft_row_stride``,
    ``ft_smem_floats``): one thread per 4 x 8 outputs of the (r, TN) tile
    in whole warps (at least two), the transposed tiles' row stride (a
    multiple of 4 with an odd quarter), the lanes that share a 4 x 4 block
    of the Grams (as many of 4, 2, 1 as the threads allow), and the
    block's shared memory."""
    name = "fista_sweeps_stop" if use_stopping else "fista_sweeps"
    if not 1 <= r <= SMEM_MAX_RANK[name]:
        raise ValueError(f"no shared-memory {name} kernel at r={r}")
    nb = -(-r // 4)
    threads = max(64, -(-nb * (TN // 8) // 32) * 32)
    stride = 4 * nb if nb % 2 else 4 * nb + 4
    blocks = nb * (nb + 1) // 2
    lanes = 4 if 4 * blocks <= threads else 2 if 2 * blocks <= threads else 1
    floats = r * 4 * nb + 2 * TN * stride
    if use_stopping:
        floats += 2 * r * r + 6 * r
    return threads, stride, lanes, 4 * floats


def _gram_shape(r: int, threads: int, use_stopping: bool):
    """The wide kernels' Gram shape at rank r (csrc ``fw_config``,
    ``cw_config``): the side of the Grams' register blocks (8 where 4 x 4
    blocks would take the ``threads`` more than two rounds, else 4), a
    Gram's rows (r to a multiple of the side), the staged tile's row stride
    (at least that, with an odd quarter), the columns of a staged Gram
    chunk (the largest power of two up to TN whose tile fits 224 KB), and
    the floats of the power vectors and of both Grams and whether those
    and a chunk fit 224 KB of shared memory."""
    nb = -(-r // 4)
    side = 8 if nb * (nb + 1) // 2 > 2 * threads else 4
    rows = -(-r // side) * side
    stride = rows if (rows // 4) % 2 else rows + 4
    cols = TN
    while cols > 1 and cols * stride > _FW_SMEM_FLOATS:
        cols //= 2
    vectors, grams = -(-6 * r // 4) * 4, 2 * rows * rows
    shared = (use_stopping
              and vectors + grams + cols * stride <= _FW_SMEM_FLOATS)
    return side, rows, stride, cols, vectors, grams, shared


def coder_wide_config(r: int, use_stopping: bool = True):
    """``(lanes, slots, passes, chunk, gram_block, gram_cols, grams_shared,
    smem_bytes, head_floats, slice_floats)`` of the wide Gauss-Seidel
    kernel (``coder_wide_kernel``) at rank ``r``, from ``r`` and the mode
    alone (csrc ``cw_config``): 8 lanes share a column up to r = 256, 16 up
    to 512, 32 past it, each holding ``slots`` float4 slots of rows of its
    two columns (4, 6 or 8 with 8 lanes, 8 with 16, 10 with 32; A's rows
    are zero-padded to ``4 lanes slots``); the block's 512 threads sweep
    1024 / lanes columns at a time, so the tile's 128 in ``passes`` passes;
    rows of A (and of B's
    columns) a staged chunk; with the stop, the Grams' block side and
    chunk columns and whether the Grams and power vectors fit shared
    memory (:func:`_gram_shape` at 512 threads); the block's shared
    memory; the workspace's floats: A's table (rows padded to
    ``4 lanes slots``) and, with the stop, one slice per block (the two
    iterate tiles, and the Grams and vectors where they are not shared)."""
    name = "coder_sweeps_earlystop" if use_stopping else "coder_sweeps"
    if kernel_route(name, r) != "workspace":
        raise ValueError(f"no wide {name} kernel at r={r}")
    lanes, per_thread, slots = next(reg[1:] for reg in _CW_REGIMES
                                    if r <= reg[0])
    stride, cols_pass = 4 * lanes * slots, _CW_THREADS * per_thread // lanes
    sweep = 2 * _CW_CHUNK * (stride + cols_pass) + -(-r // 4) * 4
    side, _, gram_stride, cols, vectors, grams, shared = _gram_shape(
        r, _CW_THREADS, use_stopping)
    staged = cols * gram_stride
    floats = sweep
    if shared:
        floats = vectors + max(sweep, grams + staged)
    elif use_stopping:
        floats = max(sweep, staged)
    slice_floats = 0
    if use_stopping:
        slice_floats = 2 * r * TN + (0 if shared else grams + vectors)
        slice_floats = -(-slice_floats // 32) * 32
    return (lanes, slots, TN // cols_pass, _CW_CHUNK, side, cols, shared,
            4 * floats, r * stride, slice_floats)


def fista_wide_config(r: int, use_stopping: bool = False):
    """``(regime, threads, passes, rows, chunk, gram_block, gram_cols,
    grams_shared, smem_bytes)`` of the wide :func:`fista_sweeps` kernel at
    rank ``r``, from ``r`` and the mode alone (csrc ``fw_config``): Y
    ``"resident"`` in shared memory up to :data:`FW_RESIDENT_MAX_RANK`,
    else ``"streamed"`` from the workspace; 16 threads per 4-row block of a
    pass, in whole warps; passes over the row blocks (at most 32 a pass)
    and rows a pass; rows j of a staged chunk of A^T (and streamed, of Y);
    with the stop, the side of the Grams' register blocks (8 where 4 x 4
    blocks would take the threads more than two rounds, else 4), the
    columns of a Gram chunk (the largest power of two up to TN whose
    transposed tile fits 224 KB), whether both Grams and six power vectors
    fit 224 KB of shared memory beside a Gram chunk (else they live in the
    workspace); the block's shared memory."""
    name = "fista_sweeps_stop" if use_stopping else "fista_sweeps"
    if kernel_route(name, r) != "workspace":
        raise ValueError(f"no wide {name} kernel at r={r}")
    nb = -(-r // 4)
    passes = -(-nb // (_FW_MAX_THREADS // 16))
    blocks = -(-nb // passes)
    threads = -(-blocks * 16 // 32) * 32
    resident = r <= FW_RESIDENT_MAX_RANK
    product = (2 * _FW_CHUNK * (4 * blocks + (0 if resident else TN))
               + (r * TN if resident else 0))
    side, _, stride, cols, vectors, grams, shared = _gram_shape(
        r, threads, use_stopping)
    floats = product
    if shared:
        floats = vectors + max(product, grams + cols * stride)
    elif use_stopping:
        floats = max(product, cols * stride)
    return ("resident" if resident else "streamed", threads, passes,
            4 * blocks, _FW_CHUNK, side, cols, shared, 4 * floats)


# The dictionary kernel (csrc dict_stride, dict_threads, dict_smem_floats):
# one thread a row, at most _DICT_MAX_THREADS and at least _DICT_MIN_WARPS
# warps a CTA, the largest cluster, the slots of the column's partial sums
# (a warp's each) and the panel width.
_DICT_MAX_THREADS = 448
_DICT_MIN_WARPS = 8
_DICT_MAX_CLUSTER = 8
_DICT_MAX_PARTS = 128
_DICT_PANEL = 8
_DICT_SMEM_BYTES = 232448


def _dict_stride(n: int) -> int:
    """A row stride of at least ``n`` floats, = 4 (mod 32)."""
    return n + (4 - n) % 32


def _dict_threads(rows: int, r: int) -> int:
    """One thread a row, at least :data:`_DICT_MIN_WARPS` warps."""
    return 32 * max(-(-rows // 32), _DICT_MIN_WARPS)


def _dict_smem_floats(rows: int, r: int) -> int:
    """Shared floats of a dictionary-kernel CTA of ``rows`` rows: two
    buffers of partial sums and two barriers, the reciprocals of A's
    diagonal, A padded to whole panels, the CTA's rows of W transposed and
    its rows of G."""
    ra = -(-r // _DICT_PANEL) * _DICT_PANEL
    return (2 * _DICT_MAX_PARTS + 4 + ra + ra * ra + r * _dict_stride(rows)
            + rows * _dict_stride(-(-r // 4) * 4))


def dict_route(d: int, r: int) -> tuple[str, int]:
    """How :func:`dict_update_sweep` runs at (d, r), from the shape alone:
    ``("shared", 1)`` (one CTA), ``("cluster", c)`` (the rows split over a
    cluster of c CTAs) or ``("single", 0)`` (past the cluster's shared
    memory: the single-block kernel). One CTA up to 256 rows; past them a
    cluster of 4 CTAs where r <= 32 and each holds at most 128 rows, else
    of 8: the fewest CTAs the rule asks for whose rows fit, or the most
    that fit. Measured on the H100 (PERF.md §6): one CTA fastest at d
    <= 200 (r <= 25); at (300, 25) and (441, 25) 4 CTAs 8-24% faster than
    one, 8 no faster; at (400, 100) and (300, 64) 8 CTAs 4-5% faster than
    4; two CTAs never fastest."""
    fits = [c for c in (1, 4, _DICT_MAX_CLUSTER)
            if _dict_threads(-(-d // c), r) <= _DICT_MAX_THREADS
            and 4 * _dict_smem_floats(-(-d // c), r) <= _DICT_SMEM_BYTES]
    if not fits:
        return "single", 0
    want = 1 if d <= 256 else 4 if r <= 32 and d <= 512 else 8
    c = next((c for c in fits if c >= want), fits[-1])
    return ("shared" if c == 1 else "cluster"), c


def _workspace(B: torch.Tensor, slice_floats: int, head_floats: int = 0):
    """The workspace of a wide kernel and its block count: one slice of
    ``slice_floats`` per block (after ``head_floats`` shared by all), as
    many blocks as there are tiles, up to one per SM (the kernels' 512
    threads and shared memory keep one block on an SM) and
    :data:`_WS_BYTES` of slices."""
    tiles = -(-B.shape[1] // TN)
    blocks = max(1, min(tiles, _sm_count(B.device),
                        _WS_BYTES // max(4 * slice_floats, 1)))
    ws = torch.empty(head_floats + blocks * slice_floats,
                     dtype=torch.float32, device=B.device)
    return ws, blocks


def _check(name: str, **tensors) -> None:
    for arg, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_coder(name: str, A, B, H0, max_rank: int) -> tuple[int, int]:
    _check(name, A=A, B=B, H0=H0)
    if B.dim() != 2:
        raise ValueError(f"{name}: B must be (r, n), got {tuple(B.shape)}")
    r, n = B.shape
    if tuple(A.shape) != (r, r) or tuple(H0.shape) != (r, n):
        raise ValueError(
            f"{name}: shapes A {tuple(A.shape)}, B {tuple(B.shape)}, "
            f"H0 {tuple(H0.shape)} do not agree")
    if not 1 <= r <= max_rank:
        raise ValueError(f"{name}: rank r={r} outside the kernel's "
                         f"limit 1 <= r <= {max_rank}")
    return r, n


def coder_sweeps(A: torch.Tensor, B: torch.Tensor, H0: torch.Tensor,
                 alpha: float = 0.0, *, sub_iter: int = 10) -> torch.Tensor:
    """Exactly ``sub_iter`` nonnegative sparse-coding sweeps from Gram form.

    Args:
      A: (r, r) = W^T W.   B: (r, n) = W^T X.   H0: (r, n) start iterate.
    Returns the (r, n) code.
    """
    if _on_cpu(A, B, H0):
        return coder_sweeps_plain(A, B, H0, alpha, sub_iter=sub_iter)
    route = kernel_route("coder_sweeps", B.shape[0])
    if route == "unfused":
        return coder_sweeps_plain(A, B, H0, alpha, sub_iter=sub_iter)
    r, n = _check_coder("coder_sweeps", A, B, H0, MAX_RANK)
    out = torch.empty_like(B)
    if n == 0:
        return out
    lib = build()["lib"]
    ws, blocks = None, 0
    if route == "workspace":
        ws, blocks = _workspace(B, 0, coder_wide_config(r, False)[8])
    with torch.cuda.device(B.device):
        err = lib.onmf_coder_sweeps(
            A.data_ptr(), B.data_ptr(), H0.data_ptr(), out.data_ptr(), r, n,
            float(alpha), int(sub_iter), None if ws is None else ws.data_ptr(),
            blocks, _stream(B))
    _raise_on_error("coder_sweeps", err)
    LAUNCHES["coder_sweeps"] += 1
    return out


def coder_sweeps_earlystop(A: torch.Tensor, B: torch.Tensor,
                           H0: torch.Tensor, alpha: float = 0.0,
                           stopping_diff: float = 0.01, *,
                           sub_iter: int = 10,
                           pi_iters: int = 12) -> torch.Tensor:
    """Early-stopping nonnegative sparse coding from Gram form: up to
    ``sub_iter`` sweeps per tile of :data:`TN` columns, each tile stopping
    once its relative spectral change is at most ``stopping_diff``.
    Args/returns as :func:`coder_sweeps`."""
    if _on_cpu(A, B, H0):
        return coder_sweeps_earlystop_plain(
            A, B, H0, alpha, stopping_diff, sub_iter=sub_iter,
            pi_iters=pi_iters)
    route = kernel_route("coder_sweeps_earlystop", B.shape[0])
    if route == "unfused":
        from onmf_ontf_ndl_tpu_torch.ops.coder import _code_impl

        return _code_impl(A, B, H0, alpha, stopping_diff, None,
                          int(sub_iter), True, False)
    r, n = _check_coder("coder_sweeps_earlystop", A, B, H0, MAX_RANK)
    out = torch.empty_like(B)
    if n == 0:
        return out
    lib = build()["lib"]
    ws, blocks = None, 0
    if route == "workspace":
        cfg = coder_wide_config(r, True)
        ws, blocks = _workspace(B, cfg[9], cfg[8])
    cluster = coder_es_cluster(r, n, _sm_count(B.device))
    with torch.cuda.device(B.device):
        err = lib.onmf_coder_sweeps_earlystop(
            A.data_ptr(), B.data_ptr(), H0.data_ptr(), out.data_ptr(), r, n,
            float(alpha), float(stopping_diff), int(sub_iter),
            int(pi_iters), cluster, None if ws is None else ws.data_ptr(),
            blocks, _stream(B))
    _raise_on_error("coder_sweeps_earlystop", err)
    LAUNCHES["coder_sweeps_earlystop"] += 1
    return out


def fista_sweeps(A: torch.Tensor, B: torch.Tensor, H0: torch.Tensor,
                 alpha: float = 0.0, stopping_diff: float = 0.01, *,
                 sub_iter: int = 10, use_stopping: bool = True,
                 pi_iters: int = 12,
                 bf16_matmul: bool = False) -> torch.Tensor:
    """FISTA nonnegative sparse coding from Gram form: exactly ``sub_iter``
    accelerated projected-gradient iterations, or with ``use_stopping`` up
    to ``sub_iter`` per tile of :data:`TN` columns, each tile stopping once
    its relative spectral change is at most ``stopping_diff``.
    ``bf16_matmul`` takes the product ``A Y`` from bf16-rounded inputs with
    f32 accumulation. The step size comes from power steps on ``A v`` and
    the product is ``A Y`` as written, so an A that is not exactly
    symmetric gives what the plain version gives. Args/returns as
    :func:`coder_sweeps`."""
    if _on_cpu(A, B, H0):
        return fista_sweeps_plain(
            A, B, H0, alpha, stopping_diff, sub_iter=sub_iter,
            use_stopping=use_stopping, pi_iters=pi_iters,
            bf16_matmul=bf16_matmul)
    route = kernel_route(
        "fista_sweeps_stop" if use_stopping else "fista_sweeps", B.shape[0])
    if route == "unfused":
        from onmf_ontf_ndl_tpu_torch.ops.coder import _fista_impl

        return _fista_impl(A, B, H0, alpha, stopping_diff, int(sub_iter),
                           use_stopping, bf16_matmul=bf16_matmul)
    r, n = _check_coder("fista_sweeps", A, B, H0, MAX_RANK)
    out = torch.empty_like(B)
    if n == 0:
        return out
    inv_L = torch.empty(1, dtype=torch.float32, device=B.device)
    lib = build()["lib"]
    ws, blocks = None, 0
    if route == "workspace":
        ws, blocks = _workspace(
            B, lib.onmf_fista_slice_floats(r, int(use_stopping)),
            lib.onmf_fista_head_floats(r))
    with torch.cuda.device(B.device):
        err = lib.onmf_fista_sweeps(
            A.data_ptr(), B.data_ptr(), H0.data_ptr(), out.data_ptr(), r, n,
            float(alpha), inv_L.data_ptr(), max(16, int(pi_iters)),
            float(stopping_diff if use_stopping else 0.0), int(sub_iter),
            int(use_stopping), int(pi_iters), int(bf16_matmul),
            None if ws is None else ws.data_ptr(), blocks, _stream(B))
    _raise_on_error("fista_sweeps", err)
    LAUNCHES["fista_sweeps"] += 1
    return out


def dict_update_sweep(W: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor) -> torch.Tensor:
    """One column-BCD pass over the dictionary.

    Args: W (d, r), A (r, r), B (r, d). Returns the updated (d, r) W; any
    A, symmetric or not, matches ``dict_update_bcd``.
    """
    if _on_cpu(W, A, B):
        return dict_update_sweep_plain(W, A, B)
    _check("dict_update_sweep", W=W, A=A, B=B)
    if W.dim() != 2:
        raise ValueError(f"dict_update_sweep: W must be (d, r), got "
                         f"{tuple(W.shape)}")
    d, r = W.shape
    if tuple(A.shape) != (r, r) or tuple(B.shape) != (r, d):
        raise ValueError(
            f"dict_update_sweep: shapes W {tuple(W.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)} do not agree")
    out = torch.empty_like(W)
    if W.numel() == 0:
        return out
    lib = build()["lib"]
    _, ctas = dict_route(d, r)
    with torch.cuda.device(W.device):
        err = lib.onmf_dict_update_sweep(
            W.data_ptr(), A.data_ptr(), B.data_ptr(), out.data_ptr(), d, r,
            ctas, _stream(W))
    _raise_on_error("dict_update_sweep", err)
    LAUNCHES["dict_update_sweep"] += 1
    return out


# ---------------------------------------------------------- plain versions
def coder_sweeps_plain(A, B, H0, alpha=0.0, *, sub_iter: int = 10):
    """Plain PyTorch :func:`coder_sweeps`: row-at-a-time sweeps."""
    from onmf_ontf_ndl_tpu_torch.ops.coder import _code_impl

    return _code_impl(A, B, H0, alpha, None, None, sub_iter, False, False)


def dict_update_sweep_plain(W, A, B):
    """Plain PyTorch :func:`dict_update_sweep`."""
    from onmf_ontf_ndl_tpu_torch.ops.dict_update import dict_update_bcd

    return dict_update_bcd(W, A, B)


def _fixed_start(r: int, dtype, device) -> torch.Tensor:
    """Fixed unstructured positive start vector for the power steps."""
    idx = torch.arange(r, device=device)
    return 0.5 + ((idx * 40503) % 65536).to(dtype) / 65536.0


def _lambda_max(G: torch.Tensor, iters: int) -> torch.Tensor:
    """Top eigenvalue of a small PSD matrix: the Rayleigh quotient after
    ``iters`` normalized power steps from :func:`_fixed_start`. In float32
    whatever ``G``'s type, as the JAX helper computes it; the quotient only
    under-estimates."""
    G = G.float()
    v = _fixed_start(G.shape[0], torch.float32, G.device)
    for _ in range(iters):
        w = G @ v
        v = w / torch.clamp_min(torch.sqrt(torch.sum(w * w)), 1e-30)
    return torch.sum(v * (G @ v)) / torch.clamp_min(torch.sum(v * v), 1e-30)


def _inv_lipschitz(A: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """The FISTA step ``1 / L``, ``L = 1.02 lambda_max(A) + 1e-12`` (the
    1.02 covers the power estimate's shortfall); a float32 scalar tensor."""
    return 1.0 / (_lambda_max(A, iters) * 1.02 + 1e-12)


def _warm_pair(Gd, Gh, vd, vh, iters: int):
    """``iters`` power steps on batched Grams (tiles, r, r) from vd/vh
    (tiles, r); returns the Rayleigh quotients and the final vectors."""
    def step(G, v):
        w = (G @ v[..., None])[..., 0]
        nrm = torch.sqrt(torch.sum(w * w, dim=-1, keepdim=True))
        return w / torch.clamp_min(nrm, 1e-30)

    def rayleigh(G, v):
        Gv = (G @ v[..., None])[..., 0]
        return (torch.sum(v * Gv, dim=-1)
                / torch.clamp_min(torch.sum(v * v, dim=-1), 1e-30))

    for _ in range(iters):
        vd, vh = step(Gd, vd), step(Gh, vh)
    return rayleigh(Gd, vd), rayleigh(Gh, vh), vd, vh


def _psd_lambda_ub(G):
    """Certified upper bound on lambda_max of batched PSD matrices: the
    smaller of the trace and the Gershgorin max absolute row sum."""
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    return torch.minimum(tr, G.abs().sum(-1).amax(-1))


def _tile_view(M: torch.Tensor) -> torch.Tensor:
    """(r, tiles * TN) -> (tiles, r, TN)."""
    r, N = M.shape
    return M.view(r, N // TN, TN).transpose(0, 1)


class _TileStop:
    """The per-tile stop of the early-stop and FISTA kernels (the kernels'
    ``stop_decision``), for all tiles at once: certified bounds first, warm
    power steps only in the band between them."""

    def __init__(self, tiles: int, r: int, stopping_diff: float,
                 pi_iters: int, dtype, device):
        self.v0 = _fixed_start(r, dtype, device)
        self.vd = self.v0.expand(tiles, r).clone()
        self.vh = self.v0.expand(tiles, r).clone()
        self.conv = torch.zeros(tiles, dtype=torch.bool, device=device)
        self.stop2 = torch.tensor(stopping_diff, dtype=dtype) ** 2
        self.pi_iters = pi_iters

    def update(self, D: torch.Tensor, O: torch.Tensor) -> None:
        """Decide on step delta ``D`` and old iterate ``O`` (r, tiles * TN);
        tiles that converged before keep their vectors and stay stopped."""
        Dt, Ot = _tile_view(D), _tile_view(O)
        Gd = Dt @ Dt.transpose(1, 2)
        Gh = Ot @ Ot.transpose(1, 2)
        lb_d, lb_h, vd1, vh1 = _warm_pair(Gd, Gh, self.vd + 0.05 * self.v0,
                                          self.vh + 0.05 * self.v0, 1)
        ub_d, ub_h = _psd_lambda_ub(Gd), _psd_lambda_ub(Gh)
        conv_certain = ub_d <= self.stop2 * lb_h
        band = ~(conv_certain | (lb_d > self.stop2 * ub_h))
        now = conv_certain
        if bool(band.any()):
            num, den, vd2, vh2 = _warm_pair(Gd, Gh, vd1, vh1, self.pi_iters)
            now = torch.where(band, num <= self.stop2 * den, conv_certain)
            vd1 = torch.where(band[:, None], vd2, vd1)
            vh1 = torch.where(band[:, None], vh2, vh1)
        live = ~self.conv
        self.vd = torch.where(live[:, None], vd1, self.vd)
        self.vh = torch.where(live[:, None], vh1, self.vh)
        self.conv = self.conv | (live & now)


def _padded(B, H0):
    """B and H0 zero-padded to whole tiles, and the padding-column mask."""
    r, n = B.shape
    N = -(-n // TN) * TN
    H = torch.zeros((r, N), dtype=B.dtype, device=B.device)
    Bp = torch.zeros_like(H)
    H[:, :n] = H0
    Bp[:, :n] = B
    return H, Bp, torch.arange(N, device=B.device) >= n


def coder_sweeps_earlystop_plain(A, B, H0, alpha=0.0, stopping_diff=0.01, *,
                                 sub_iter: int = 10, pi_iters: int = 12,
                                 with_sweeps: bool = False):
    """Plain PyTorch :func:`coder_sweeps_earlystop`: the same per-tile rule
    at the same tile width :data:`TN`, all tiles batched. ``with_sweeps``
    also returns the sweeps each tile ran, a (tiles,) int64 tensor."""
    from onmf_ontf_ndl_tpu_torch.ops.coder import _sweep

    r, n = B.shape
    H, Bp, pad = _padded(B, H0)
    stop = _TileStop(H.shape[1] // TN, r, stopping_diff, pi_iters, B.dtype,
                     B.device)
    sweeps = torch.zeros(H.shape[1] // TN, dtype=torch.int64, device=B.device)
    for i in range(sub_iter):
        if bool(stop.conv.all()):
            break
        sweeps += ~stop.conv
        H_old = H.clone()
        _sweep(H, A, Bp, alpha, 1.0 / math.sqrt(i + 10.0))
        H = torch.where(stop.conv.repeat_interleave(TN) | pad, H_old, H)
        stop.update(H - H_old, H_old)
    H = H[:, :n].contiguous()
    return (H, sweeps) if with_sweeps else H


def fista_sweeps_plain(A, B, H0, alpha=0.0, stopping_diff=0.01, *,
                       sub_iter: int = 10, use_stopping: bool = True,
                       pi_iters: int = 12, bf16_matmul: bool = False,
                       with_sweeps: bool = False):
    """Plain PyTorch :func:`fista_sweeps`: fixed iterations as
    ``ops.coder._fista_impl``; with ``use_stopping`` the kernel's per-tile
    rule at the same tile width :data:`TN`, all tiles batched, each tile
    with its own momentum. ``with_sweeps`` also returns the iterations
    each tile ran, a (tiles,) int64 tensor."""
    from onmf_ontf_ndl_tpu_torch.ops.coder import _fista_fixed, _fista_grad

    inv_L = _inv_lipschitz(A, max(16, pi_iters))
    r, n = B.shape
    if not use_stopping:
        H = _fista_fixed(A, B, H0, alpha, inv_L, sub_iter, bf16_matmul)
        sweeps = torch.full((-(-n // TN),), sub_iter, dtype=torch.int64,
                            device=B.device)
        return (H, sweeps) if with_sweeps else H
    H, Bp, pad = _padded(B, H0)
    tiles = H.shape[1] // TN
    sweeps = torch.zeros(tiles, dtype=torch.int64, device=B.device)
    Y = H.clone()
    tmom = torch.ones(tiles, dtype=B.dtype, device=B.device)
    stop = _TileStop(tiles, r, stopping_diff, pi_iters, B.dtype, B.device)
    for _ in range(sub_iter):
        if bool(stop.conv.all()):
            break
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tmom * tmom))
        mom = ((tmom - 1.0) / tn).repeat_interleave(TN)
        Hn = torch.clamp_min(
            Y - inv_L * _fista_grad(A, Y, Bp, alpha, bf16_matmul), 0.0)
        Hn = torch.where(pad, 0.0, Hn)
        D = Hn - H
        live = ~stop.conv
        sweeps += live
        cols = live.repeat_interleave(TN)
        stop.update(D, H)
        H, Y = torch.where(cols, Hn, H), torch.where(cols, Hn + mom * D, Y)
        tmom = torch.where(live, tn, tmom)
    H = H[:, :n].contiguous()
    return (H, sweeps) if with_sweeps else H

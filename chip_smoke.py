"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its findings on a line of its own:

1. build   - nvcc builds the kernel library from ``csrc/*.cu`` (sm_90a), one
             compiler per source at once; the card's name and power limit.
2. kernels - each kernel against its plain PyTorch version on the card at
             the slices' shapes, with CUDA-event times of both: the sweep
             kernels and FISTA (fixed, stop 0.01, bf16) at r in {25, 100},
             n in {TN, 131072 + 37}, d = 300, rtol 2e-4 / atol 2e-5; bf16
             FISTA over one iteration at that tolerance and over ten at
             atol 1.5e-3, each outside the f32 tolerance of the f32 plain
             version; the coders past their shared-memory ranks (the
             wide Gauss-Seidel and FISTA kernels) at
             ``LARGE_RANK_SHAPES``: r in {128, 256} and 101 for the
             stopping modes at n = 131072 + 37, r = 512 at n = 16384, each
             with its kernel, bound and share. Then the dictionary kernel,
             the three coders and the checkerboard sampler at the paths'
             shapes (``PATH_SHAPES``), each with its route, device time,
             bound and share of the bound; the sampler equal to its plain
             version site for site on every route and vector width (at the
             paths' shapes from a host seed and from a device seed, the
             entry the Ising round graphs launch), and two
             physics checks at n = 4096; the grouping at the dense
             network reconstruction's shape, dense and sparse, against
             its plain version. Kernel times are device times: a
             CUDA graph of 20 calls (5 of the larger ones), replayed; the
             plain versions (host loops that synchronise) are timed by CUDA
             events around a few calls.
3. main    - ``OnlineNMF(...).train_dict()`` on synthetic sparse-dictionary
             data (trained W within 10% of the ground-truth W's score),
             then ``init_state`` + ``train_dict`` at d = 300, r = 25,
             batch 16384 (patches/s: fixed sweeps, early stop, FISTA),
             each step a replay of the captured step. At batch 16384 and
             128 for each coder: the captured route against the eager one
             from the same state and generator state (W, A and B equal bit
             for bit, the code within float32 rounding, the generator's
             next draw equal, one launch a step of each kernel) and the
             host ms a step of both routes. Then a short run against the
             same run on the CPU in float64 with the same draws.
4. image   - ``ImageReconstructor`` on a 1024x1024x3 synthetic image, colour
             reconstruction, and a checkpoint written and resumed.
5. tensor  - ``ImageReconstructorTensor`` (r = 100, patch 20, joint mode 2,
             d = 1200; ``benchmarks/run_all.py``'s configuration) on the
             same image, colour reconstruction, and a short card/CPU run.
6. ising   - ``IsingReconstructor`` (r = 100, lattice 200, 20 rounds,
             T = 5; ``benchmarks/run_all.py``'s configuration), config
             reconstruction, and a short card/CPU run; then
             ``ImageReconstructor(is_stack=True)`` on a stack of sampled
             lattices.
7. video   - ``VideoDictionaryLearner`` at the reference's defaults
             (r = 100, patch 7, colour: d = 147; 200 patches a frame, 10
             inner steps) on 16 synthetic 256x256x3 frames built on the
             card, one epoch, and one frame reconstructed (its error must
             be below the initial W's).
8. network - ``NetworkReconstructor`` at ``NETWORK_RUNS``' two
             configurations (the reference main()'s 21-node motif on a
             seeded 4,039-node Barabasi-Albert graph, dense reconstruction;
             the 129,600-node torus on a CsrGraph, sparse reconstruction of
             4.8M samples): train and reconstruction seconds and accuracy;
             the chains run in blocks of moves (M from the shapes, a
             last block of the rest), each block a replay of a captured
             CUDA graph of its draws and one launch of the block kernel
             (``csrc/motif_kernels.cu``), which writes the block's trail;
             each chain at its run's own moves must equal its eager route
             and its plain moves (``backend="torch"``) bit for bit (trail,
             final embeddings, the generator's next draw), also on a
             BitsetGraph, and its kernel must run once a block; chain
             steps per second on three routes, graphs, host launches and
             copies and device operations per move over a whole run, the
             block kernel's and plain block's ms a move, bound and share,
             the (b) reconstruction's chain graph bytes (draws, trail,
             pool); the sparse reconstruction once more in 4 chunks, with
             the peak device memory of both; both runs again with every
             move on the plain version (the same W and accuracy); a short
             card/CPU run.
9. surfaces - the CLI in process (``cli.main``) on the card: ``ising`` at
             phase 6's configuration (its state equal to phase 6's),
             ``network`` at phase 8 (a)'s on an edge-list file of the same
             graph (accuracy beside (a)'s), ``image`` at d = 300, r = 25,
             patch 10 on a PNG of phase 4's image (on a .npy lattice, grey,
             d = 100, where Pillow is missing); ``check_state`` on the
             final state of every phase from 3 to 8.
10. parallel - one rank in an NCCL group (``parallel/multihost.py``):
             ``dp_train_dict`` at the headline shape, fixed sweeps and early
             stop, its step captured with the all-reduce, equal to
             ``train_dict`` bit for bit (host ms a step of both, the least
             of three runs after one that captures); ``dp_ising_learning``
             equal to phase 6's learner; the sharded sampler through the
             group; then the banded sampler in one process (n = 1024 in 4
             bands, n = 200 in 2, 100 sweeps) against the whole-lattice
             kernel and its plain version, site for site, all timed.

Phases 3 and 5 to 10 each drive one path of the port (6: two, the Ising
path and the stacked run) with the launch counts set to 0 before it, and
fail unless every kernel of that path launched. Every training run of
phases 3 to 10 replays a captured step (``models/onmf.py::_train_loop``);
a replay counts the launches its capture recorded, and the four kernels of
the step also count their own runs on the card (``_lib.device_runs``),
which each path's check holds the wrappers' counts to. Phase 3 reads its
path's counts after its captured runs, before its eager comparisons.
Every app's training (phases 4 to 10: image, tensor, Ising, stack,
video, both network runs, the CLI's three, ``dp_ising_learning``) runs
its rounds on the captured route (``models/onmf.py::_run_rounds``): one
round graph per key, replayed once a round, the Ising sampler's seed drawn
and read on the device (``rounds_taken``, which fails a run that replayed
no round graph); phases 4 to 8 then run each app's training again on the
captured route and on the eager rounds (``eager_rounds``: the apps'
entry points with ``capture=False``), equal bit for
bit (W, A, B, C, the dictionary stack, errors, lattice, chains and the
generators' next draws), with the walls and the graphs, kernels and copies
launched from the host per round of both (``round_checks``).
The last two lines are the kernels' JSON summary and the result line.
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

import collections
import contextlib
import ctypes
import functools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

TOL = dict(rtol=2e-4, atol=2e-5)
# bf16 FISTA over ten iterations: a float32 sum in another order carries a
# few iterates across a bf16 rounding boundary. About 3x the largest
# kernel-vs-plain error measured on an H100 (4.7e-4 at r = 25,
# n = 131109), and below the gap between the f32 and bf16 plain versions on
# these inputs (2.2e-3 at r = 100, n = 128, to 9.3e-3 at r = 25, n = 131109).
BF16_TOL = dict(rtol=0.0, atol=1.5e-3)
CSRC = "onmf_ontf_ndl_tpu_torch/ops/kernels/csrc/"
PALLAS = "onmf_ontf_ndl_tpu/ops/pallas/"
# kernel -> (source, the TPU kernel it replaces, the path whose run counts
# its launches)
KERNELS = {
    "coder_sweeps": ("onmf_kernels.cu", PALLAS + "coder_kernel.py:192",
                     "main"),
    "coder_sweeps_earlystop": ("onmf_kernels.cu",
                               PALLAS + "coder_kernel.py:455", "main"),
    "fista_sweeps": ("onmf_kernels.cu", PALLAS + "coder_kernel.py:579",
                     "tensor"),
    "dict_update_sweep": ("onmf_kernels.cu", PALLAS + "coder_kernel.py:629",
                          "main"),
    "checkerboard_sweeps": ("ising_kernels.cu", PALLAS + "ising_kernel.py:64",
                            "ising"),
    # the banded entry of the sampler (a route of checkerboard_sweeps)
    "checkerboard_sweeps_band": ("ising_kernels.cu",
                                 PALLAS + "ising_kernel.py:64", "parallel"),
    # the chain's move: no Pallas kernel, the JAX package's jitted chain
    # scan (a lax.scan over the moves, vmapped over the chains)
    "chain_move": ("motif_kernels.cu",
                   "onmf_ontf_ndl_tpu/samplers/motif.py:653", "network"),
    # the grouping of a reconstruction's paints by pair: no Pallas kernel,
    # the JAX package's lax.sort and sums
    "group_pairs": ("group_kernels.cu",
                    "onmf_ontf_ndl_tpu/apps/network.py:736", "network"),
    # the overlap average of a reconstruction's paint: no Pallas kernel,
    # the JAX package's k^2 pads and adds
    "overlap_average": ("patch_kernels.cu",
                        "onmf_ontf_ndl_tpu/ops/patches.py:175", "tensor"),
}
# the kernels each path must launch
PATH_KERNELS = {
    "main": ("coder_sweeps", "coder_sweeps_earlystop", "fista_sweeps",
             "dict_update_sweep"),
    "tensor": ("fista_sweeps", "dict_update_sweep", "overlap_average"),
    "ising": ("checkerboard_sweeps", "coder_sweeps_earlystop",
              "coder_sweeps", "dict_update_sweep"),
    "stack": ("checkerboard_sweeps", "coder_sweeps_earlystop",
              "coder_sweeps", "dict_update_sweep"),
    "video": ("coder_sweeps_earlystop", "coder_sweeps", "dict_update_sweep"),
    "network": ("coder_sweeps_earlystop", "coder_sweeps",
                "dict_update_sweep", "chain_move", "group_pairs"),
    "surfaces": ("checkerboard_sweeps", "coder_sweeps_earlystop",
                 "coder_sweeps", "dict_update_sweep", "chain_move"),
    "parallel": ("coder_sweeps", "coder_sweeps_earlystop",
                 "dict_update_sweep", "checkerboard_sweeps",
                 "checkerboard_sweeps_band"),
}
# the final optimizer state of each phase from main to network, for
# check_state in the surfaces phase, and what phases 9 and 10 compare with
FINAL_STATES = {}
REFERENCE = {}
HEADLINE_N = 131072 + 37   # a ragged last tile
# The card's published peaks (NVIDIA's H100 SXM datasheet, dense rates):
# device memory bytes/s, float32 operations/s outside the tensor cores, and
# bf16 operations/s on the tensor cores, which is the card's peak for a
# product of bf16 operands summed in f32 (FISTA's bf16_matmul product),
# wherever a kernel computes it.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
PEAK_BF16_OPS = 989e12
# Integer instructions/s of the CUDA cores (the sampler's Philox and site
# updates): 132 SMs of 64 INT32 lanes (NVIDIA H100 Tensor Core GPU
# Architecture whitepaper: 4 partitions of 16 INT32 units an SM, beside 32
# FP32 each; the arithmetic throughput table of NVIDIA's CUDA C++
# programming manual gives 64 results a clock and SM at compute capability
# 9.0 for 32-bit integer multiply-add and for add, compare and logic
# alike) at the 1.98 GHz that
# the datasheet's 67e12 FP32 operations/s imply (132 x 128 x 2 x 1.98e9).
# Multiplies and the other integer instructions issue to different pipes,
# so each is held to this rate on its own and the bound takes the larger.
PEAK_INT_MUL = PEAK_INT_ALU = 132 * 64 * 1.98e9
# The kernels at the shapes their paths give them: main path and image app
# (d = 300, r = 25; batch 16384 and the headline n), the network path
# (d = 441, r = 25; 500 samples a step), Ising (d = 400, r = 100, 1000
# patches) and tensor (d = 1200, r = 100; 100 patches a step, 252,004 in
# the colour reconstruction) paths. FISTA: (r, n, mode of FISTA_MODES).
# The sampler: (n, sweeps): a lattice of one CTA, the Ising path's for one
# sweep (a round) and for 100, and two larger ones.
PATH_SHAPES = {
    "dict_update_sweep": [(300, 25), (441, 25), (400, 100), (1200, 100)],
    "coder_sweeps_earlystop": [(25, 16384), (25, HEADLINE_N), (100, 1000)],
    "coder_sweeps": [(25, 16384), (25, HEADLINE_N), (25, 500), (100, 1000)],
    "fista_sweeps": [(25, 16384, "fixed"), (25, HEADLINE_N, "fixed"),
                     (100, 100, "stop"), (100, 252004, "stop"),
                     (100, 100, "bf16")],
    "checkerboard_sweeps": [(16, 100), (200, 1), (200, 100), (1024, 100),
                            (4096, 100)],
}
# The coders past their shared-memory ranks, d = 300: (r, n). r = 101 runs
# the two stopping modes only (the others are on their shared kernels
# there); r = 512 on one wave of 128 tiles, so that the plain versions
# (r dependent row steps a sweep) and the one thread per column kernels of
# a parent package timed by chip_compare.py stay within a call's time.
LARGE_RANK_SHAPES = [(101, HEADLINE_N), (128, HEADLINE_N),
                     (256, HEADLINE_N), (512, 16384)]
# The CUDA kernel of each coder's route (kernel_route)
ROUTE_KERNELS = {
    ("coder_sweeps", "shared"): "coder_lanes_kernel",
    ("coder_sweeps", "workspace"): "coder_wide_kernel",
    ("coder_sweeps_earlystop", "shared"): "coder_es_lanes_kernel",
    ("coder_sweeps_earlystop", "workspace"): "coder_wide_kernel",
    ("fista_sweeps", "shared"): "fista_tiled_kernel",
    ("fista_sweeps", "workspace"): "fista_wide_kernel",
}
# 10 fixed iterations (the main path's FISTA step); the tensor path's up to
# 100 iterations with the 0.01 stop, in f32 and with the bf16 product
FISTA_MODES = {
    "fixed": dict(sub_iter=10, use_stopping=False),
    "stop": dict(sub_iter=100),
    "bf16": dict(sub_iter=100, bf16_matmul=True),
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20, replays=1):
    """Mean device milliseconds per call: ``reps`` calls captured in a CUDA
    graph and replayed (no host launch cost between the kernels); the least
    mean of ``replays`` timed replays."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def bound(nbytes, ops, bf16_ops=0):
    """(ms, "bytes" or "operations"): the least time for moving ``nbytes``
    and doing ``ops`` float32 operations and ``bf16_ops`` operations of a
    bf16 product at the card's peaks."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    t_ops = 1e3 * (ops / PEAK_OPS + bf16_ops / PEAK_BF16_OPS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def coder_bound(name, r, n, args, kw, sweeps=None):
    """A coder's bound at (r, n): A, B and H0 read and H written once; the
    sweeps' and iterations' 2 r^2 operations per column (``sub_iter`` of
    them), and for the early stop and FISTA with the stop, over the
    column-sweeps its tiles ran on these inputs (``sweeps`` per tile, from
    the plain version when not given), 2 r (r + 1) more for the two
    Grams. With ``bf16_matmul`` the product's operations count at the bf16
    tensor-core peak, the Grams' (float32) at the float32 one."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck

    column_sweeps, grams = n * kw.get("sub_iter", 10), 0
    if name == "coder_sweeps_earlystop" or (
            name == "fista_sweeps" and kw.get("use_stopping", True)):
        if sweeps is None:
            _, sweeps = getattr(ck, name + "_plain")(*args, **kw,
                                                     with_sweeps=True)
        cols = torch.full_like(sweeps, ck.TN)
        cols[-1] = n - ck.TN * (len(cols) - 1)
        column_sweeps = int((sweeps * cols).sum())
        grams = column_sweeps * 2 * r * (r + 1)
    product = column_sweeps * 2 * r * r
    nbytes = 4 * (r * r + 3 * r * n)
    if kw.get("bf16_matmul"):
        return bound(nbytes, grams, bf16_ops=product)
    return bound(nbytes, product + grams)


def dict_bound(d, r):
    """The dictionary update's bound: W, A and B read and W written once;
    W A[:, j] for every column, 2 d r^2 operations."""
    return bound(4 * (2 * d * r + r * r + r * d), 2 * d * r * r)


# Integer instructions of the sampler, whatever kernel runs it. A
# Philox4x32-10 call is 10 rounds of two 32 x 32 -> 64 multiplies and two
# three-input xors (the key schedule is the same for every site and is not
# counted); it serves four sites. A site then takes its 24 bits (a shift),
# sums four neighbours (3 adds), forms the table index (1), compares (1)
# and flips (1).
PHILOX_MULS, PHILOX_ALU, SITE_ALU = 20, 20, 7


def checkerboard_bound(n, nsweeps):
    """The sampler's bound at (n, nsweeps), the same for every route: the
    lattice read and written once a call; one Philox call per four sites of
    a colour and the site updates, multiplies and other integer
    instructions each at their rate."""
    calls = 2 * nsweeps * -(-n * (n // 2) // 4)
    sites = n * n * nsweeps
    t_bytes = 1e3 * 2 * n * n / PEAK_BYTES
    t_ops = 1e3 * max(PHILOX_MULS * calls / PEAK_INT_MUL,
                      (PHILOX_ALU * calls + SITE_ALU * sites) / PEAK_INT_ALU)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_once(fn):
    """(result, milliseconds) of one call, from CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare(name, got, want, tol=TOL):
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max())


def check_launches(ck, path):
    """The launch counts of the path just driven; fail unless each of its
    kernels launched, and unless the wrappers' counts of the kernels that
    count their own runs on the card (``_lib.device_runs``: every replay
    of a captured step) equal those runs."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (RUN_KERNELS,
                                                          device_runs)

    launches = dict(ck.LAUNCHES)
    runs = device_runs()
    emit(path, launches=launches, device_runs=runs)
    differ = {k: (launches[k], runs[k]) for k in RUN_KERNELS
              if launches[k] != runs[k]}
    if differ:
        raise AssertionError(f"{path}: wrapper counts and the kernels' own "
                             f"runs differ: {differ}")
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")
    return launches


def rel_err(a, b):
    return float((a.double().cpu() - b.double().cpu()).norm()
                 / b.double().cpu().norm())


# ------------------------------------------------------- the apps' rounds
# models/onmf.py::_run_rounds: on the card each app's training round (its
# sampler, its patches, its inner steps) is captured once as a CUDA graph
# per key and replayed a round at a time.

@contextlib.contextmanager
def eager_rounds():
    """Every app's rounds in a Python loop, their steps eager: the apps'
    round entry points, which the apps' classes and the CLI call (and
    which take no such argument), given ``capture=False`` for the time of
    the block."""
    from onmf_ontf_ndl_tpu_torch.apps import (image, image_tensor, ising,
                                              network, video)

    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (image, "train_image_dict"), (image_tensor, "_train_tensor"),
        (video, "train_video_dict"), (ising, "ising_trajectory_learning"),
        (network, "ndl_train"))]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, functools.partial(fn, capture=False))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def rounds_taken(run, app, rounds):
    """``(run(), key)``: ``key`` is the cache key of the round graph of
    ``app`` that the run replayed once a round (once a round after the
    first where the run captured it), or None where no graph was: the run
    did not take the captured route."""
    from onmf_ontf_ndl_tpu_torch.models import onmf

    before = {key: e.replays for key, e in onmf._ROUND_GRAPHS.items()}
    out = run()
    torch.cuda.synchronize()
    took = [key for key, e in onmf._ROUND_GRAPHS.items()
            if key[0][0] == app and e.replays - before.get(key, -1) == rounds]
    return out, (took[0] if len(took) == 1 else None)


def host_calls(fn):
    """Per call of ``fn()`` under ``torch.profiler`` (after one call that
    captures what it captures): the CUDA graphs launched, the kernels
    launched and the copies started from the host, and the device
    operations run (kernels, copies and fills, replayed graphs' included)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {"graph": 0, "kernel": 0, "copy": 0, "device": 0}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            counts["device"] += ev.count
        elif ev.key == "cudaGraphLaunch":
            counts["graph"] += ev.count
        elif ev.key.startswith("cudaLaunchKernel"):
            counts["kernel"] += ev.count
        elif ev.key.startswith("cudaMemcpy"):
            counts["copy"] += ev.count
    return counts


def outputs_equal(got, want):
    """Whether two runs' outputs (tensors; states: W, A, B, C and t) are
    equal bit for bit."""
    def flat(out):
        for x in out:
            if hasattr(x, "W"):
                yield from (x.W, x.A, x.B, x.C, torch.tensor(x.t))
            else:
                yield x
    return all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(flat(got), flat(want), strict=True))


def round_checks(phase, key, rounds, run, **fields):
    """The rounds of a phase's counted run (``key``: the round graph it
    took, ``rounds_taken``): ``run()`` (a fresh instance trained as the
    counted run was; returns its outputs, the generators' next draws
    included) once more on the captured route (replays only) and on the
    eager rounds (``eager_rounds``), the outputs equal bit for bit; the
    walls of both, and per round on both the graphs and kernels launched
    and copies started from the host and the device operations
    (``host_calls``). Emits a line; fails unless the counted run took the
    captured route and both routes agree."""
    from onmf_ontf_ndl_tpu_torch.models import onmf

    timed = {}
    for route in ("captured", "eager"):
        with eager_rounds() if route == "eager" else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            timed[route] = (out, time.perf_counter() - t0, host_calls(run))
    equal = outputs_equal(timed["captured"][0], timed["eager"][0])
    out = dict(check="rounds", **fields, rounds=rounds,
               captured_route=key is not None,
               round_graphs=len(onmf._ROUND_GRAPHS),
               round_graph_replays=None if key is None
               else onmf._ROUND_GRAPHS[key].replays,
               captured_equal_eager_bit_for_bit=equal)
    for route, (_, seconds, calls) in timed.items():
        out[f"{route}_train_seconds"] = seconds
        if "counted_train_seconds" in fields and route == "captured":
            # the counted run ran its first round eagerly and captured
            out["first_round_and_capture_seconds"] = (
                fields["counted_train_seconds"] - seconds * (rounds - 1)
                / rounds)
        out.update({f"{route}_{name}_per_round": n / rounds
                    for name, n in calls.items()})
    emit(phase, **out)
    if not (key is not None and equal):
        raise AssertionError(f"{phase}: rounds not captured ({key is None}) "
                             f"or captured != eager: {out}")
    return out


def phase_build(ck):
    info = ck.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("build", nvcc_seconds=info["seconds"], compiled=info["compiled"],
         library=Path(info["path"]).name, torch=torch.__version__,
         cuda=torch.version.cuda)
    print(smi, flush=True)
    return smi


def phase_kernels(ck, dev):
    from onmf_ontf_ndl_tpu_torch.ops.coder import _spectral_norm, _sweep

    gen = torch.Generator().manual_seed(0)
    summary = {name: {"max_abs_err": 0.0} for name in KERNELS
               if not name.startswith("checkerboard")}
    d = 300
    for r in (25, 100):
        for n in (ck.TN, HEADLINE_N):
            W = torch.rand((d, r), generator=gen)
            W = (W / W.norm(dim=0)).to(dev)
            X = torch.rand((d, n), generator=gen).to(dev)
            H0 = torch.rand((r, n), generator=gen).to(dev)
            A, B = W.T @ W, W.T @ X
            Hs, Xs = H0[:, :4096], X[:, :4096]
            A_agg, B_agg = Hs @ Hs.T, Hs @ Xs.T
            fista = dict(sub_iter=10, use_stopping=False)
            bf16 = dict(fista, bf16_matmul=True)
            cases = [
                ("coder_sweeps", ck.coder_sweeps, ck.coder_sweeps_plain,
                 (A, B, H0, 0.1), {}, ""),
                ("coder_sweeps_earlystop", ck.coder_sweeps_earlystop,
                 ck.coder_sweeps_earlystop_plain, (A, B, H0, 0.1, 0.01), {},
                 ""),
                ("fista_sweeps", ck.fista_sweeps, ck.fista_sweeps_plain,
                 (A, B, H0, 0.1, 0.01), fista, "fixed"),
                ("fista_sweeps", ck.fista_sweeps, ck.fista_sweeps_plain,
                 (A, B, H0, 0.1, 0.01), dict(sub_iter=10), "stop"),
                # one iteration: A and H0 round to the same bf16 values in
                # both and their products are exact in f32, so the two agree
                # at the f32 tolerance; rounding neither, only A or only Y
                # lands 1.9e-4 or more outside it on these inputs
                ("fista_sweeps", ck.fista_sweeps, ck.fista_sweeps_plain,
                 (A, B, H0, 0.1, 0.01), dict(bf16, sub_iter=1),
                 "bf16_one_iteration"),
                ("fista_sweeps", ck.fista_sweeps, ck.fista_sweeps_plain,
                 (A, B, H0, 0.1, 0.01), bf16, "bf16"),
                ("dict_update_sweep", ck.dict_update_sweep,
                 ck.dict_update_sweep_plain, (W, A_agg, B_agg), {}, ""),
            ]
            for name, kernel, plain, args, kw, mode in cases:
                label = f"{name} {mode} r={r} n={n}"
                tol = BF16_TOL if mode == "bf16" else TOL
                got = kernel(*args, **kw)
                err = compare(label, got, plain(*args, **kw), tol)
                gap = None
                if kw.get("bf16_matmul"):
                    # the rounding must show against the f32 plain version
                    f32 = plain(*args, **dict(kw, bf16_matmul=False))
                    gap = float((got - f32).abs().max())
                    if torch.allclose(got, f32, **TOL):
                        raise AssertionError(f"{label}: agrees with the f32 "
                                             "plain version")
                ms = graph_ms(lambda: kernel(*args, **kw))
                loop_ms = cuda_ms(lambda: kernel(*args, **kw), 20)
                plain_ms = cuda_ms(lambda: plain(*args, **kw), 3)
                s = summary[name]
                if tol is TOL:
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                if r == 25 and n == HEADLINE_N and mode in ("", "fixed"):
                    bound_ms, by = (dict_bound(d, r)
                                    if name == "dict_update_sweep"
                                    else coder_bound(name, r, n, args, kw))
                    s.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=by)
                emit("kernels", kernel=name, mode=mode or None, r=r, n=n,
                     d=d, max_abs_err=err, atol=tol["atol"],
                     rtol=tol["rtol"], gap_vs_f32_plain=gap, ms=ms,
                     loop_ms=loop_ms, plain_ms=plain_ms)
    # many tiles, each freezing on its own relative-change test: every
    # tile's iterate must meet the global rule's guarantee (slack over
    # stop = 0.05 as in the Pallas kernel's test: the probe sweep takes
    # the larger i = 0 step)
    W = torch.rand((d, 25), generator=gen).to(dev)
    A, B = W.T @ W, W.T @ torch.rand((d, HEADLINE_N), generator=gen).to(dev)
    H = ck.coder_sweeps_earlystop(
        A, B, torch.rand((25, HEADLINE_N), generator=gen).to(dev), 0.0,
        0.05, sub_iter=50)
    probe = _sweep(H.clone(), A, B, 0.0, 1.0 / math.sqrt(10.0))
    rel = float(_spectral_norm(probe - H) / _spectral_norm(H))
    emit("kernels", check="earlystop_multi_tile_converged", tiles=math.ceil(
        HEADLINE_N / ck.TN), one_more_sweep_rel_change=rel, limit=0.1)
    if not (rel <= 0.1 and bool((H >= 0).all())):
        raise AssertionError(f"multi-tile early stop not converged: {rel}")
    large_rank_kernels(ck, dev, gen)
    path_shape_kernels(ck, dev, gen)
    summary["checkerboard_sweeps"] = checkerboard_kernels(dev, gen)
    summary["group_pairs"] = group_kernels(dev)
    summary["overlap_average"] = overlap_average_kernels(dev)
    return summary


def gram_inputs(r, n, gen, dev, d=300):
    """(A, B, H0) of a coder at (r, n): Grams of a normalised random
    dictionary and random data."""
    W = torch.rand((d, r), generator=gen)
    W = (W / W.norm(dim=0)).to(dev)
    X = torch.rand((d, n), generator=gen).to(dev)
    return W.T @ W, W.T @ X, torch.rand((r, n), generator=gen).to(dev)


def path_shape_kernels(ck, dev, gen):
    """The dictionary kernel and the coders at PATH_SHAPES against their
    plain versions, with their route, device time, bound and share: the
    dictionary on an asymmetric A (any A must match), the coders at
    alpha = 0.1 and the default stop 0.01."""
    lib = ck.build()["lib"]
    for r, use_stopping in [(r, s) for r in (1, 25, 33, 100) for s in (0, 1)
                            ] + [(128, 0)]:
        if lib.onmf_fista_sweeps_smem(r, use_stopping) \
                != ck.fista_tile_config(r, bool(use_stopping))[3]:
            raise AssertionError(f"fista_tile_config's shared-memory size "
                                 f"at r={r} differs from the kernel's")
    out = (ctypes.c_int * 9)()
    for r, use_stopping in [(r, s) for r in (129, 132, 133, 136, 137, 256,
                                             384, 385, 512, 1248)
                            for s in (0, 1)] + [(101, 1), (128, 1)]:
        lib.onmf_fista_wide_config(r, use_stopping, out)
        regime, *shape = ck.fista_wide_config(r, bool(use_stopping))
        if [int(regime == "resident"), *map(int, shape)] != list(out):
            raise AssertionError(f"fista_wide_config at r={r} differs from "
                                 f"the kernel's: {list(out)}")
    for r in (1, 16, 25, 33, 100, 128):
        L, Q, _ = ck.coder_lanes_config(r)
        if lib.onmf_coder_sweeps_smem(r) != 4 * r * L * Q:
            raise AssertionError(f"coder_lanes_config at r={r} differs "
                                 "from the kernel's lanes")
    for d, r in PATH_SHAPES["dict_update_sweep"]:
        rows = -(-d // max(ck.dict_route(d, r)[1], 1))
        if lib.onmf_dict_smem_floats(rows, r) != ck._dict_smem_floats(rows, r):
            raise AssertionError(f"dict_route's shared-memory size at d={d} "
                                 f"r={r} differs from the kernel's")
        W = torch.rand((d, r), generator=gen).to(dev)
        A = torch.rand((r, r), generator=gen).to(dev)
        B = torch.rand((r, d), generator=gen).to(dev)
        before = ck.LAUNCHES["dict_update_sweep"]
        got = ck.dict_update_sweep(W, A, B)
        if ck.LAUNCHES["dict_update_sweep"] != before + 1:
            raise AssertionError(f"dict_update_sweep d={d} r={r}: no launch")
        err = compare(f"dict_update_sweep d={d} r={r}", got,
                      ck.dict_update_sweep_plain(W, A, B))
        ms = graph_ms(lambda: ck.dict_update_sweep(W, A, B))
        bound_ms, by = dict_bound(d, r)
        emit("kernels", kernel="dict_update_sweep", d=d, r=r,
             route=list(ck.dict_route(d, r)), max_abs_err=err,
             atol=TOL["atol"], rtol=TOL["rtol"], ms=ms,
             loop_ms=cuda_ms(lambda: ck.dict_update_sweep(W, A, B), 20),
             plain_ms=cuda_ms(lambda: ck.dict_update_sweep_plain(W, A, B),
                              3),
             bound_ms=bound_ms, bound_by=by, share=bound_ms / ms)
    for r, n in PATH_SHAPES["coder_sweeps_earlystop"]:
        args = (*gram_inputs(r, n, gen, dev), 0.1, 0.01)
        before = ck.LAUNCHES["coder_sweeps_earlystop"]
        got = ck.coder_sweeps_earlystop(*args)
        if ck.LAUNCHES["coder_sweeps_earlystop"] != before + 1:
            raise AssertionError(f"coder_sweeps_earlystop r={r}: no launch")
        err = compare(f"coder_sweeps_earlystop r={r} n={n}", got,
                      ck.coder_sweeps_earlystop_plain(*args))
        ms = graph_ms(lambda: ck.coder_sweeps_earlystop(*args))
        bound_ms, by = coder_bound("coder_sweeps_earlystop", r, n, args, {})
        emit("kernels", kernel="coder_sweeps_earlystop", r=r, n=n, d=300,
             route=ck.kernel_route("coder_sweeps_earlystop", r),
             max_abs_err=err, atol=TOL["atol"], rtol=TOL["rtol"], ms=ms,
             loop_ms=cuda_ms(lambda: ck.coder_sweeps_earlystop(*args), 20),
             plain_ms=cuda_ms(
                 lambda: ck.coder_sweeps_earlystop_plain(*args), 3),
             bound_ms=bound_ms, bound_by=by, share=bound_ms / ms)
    for r, n in PATH_SHAPES["coder_sweeps"]:
        args = (*gram_inputs(r, n, gen, dev), 0.1)
        before = ck.LAUNCHES["coder_sweeps"]
        got = ck.coder_sweeps(*args)
        if ck.LAUNCHES["coder_sweeps"] != before + 1:
            raise AssertionError(f"coder_sweeps r={r}: no launch")
        err = compare(f"coder_sweeps r={r} n={n}", got,
                      ck.coder_sweeps_plain(*args))
        ms = graph_ms(lambda: ck.coder_sweeps(*args))
        bound_ms, by = coder_bound("coder_sweeps", r, n, args, {})
        emit("kernels", kernel="coder_sweeps", r=r, n=n, d=300,
             route=ck.kernel_route("coder_sweeps", r),
             lanes=list(ck.coder_lanes_config(r)), max_abs_err=err,
             atol=TOL["atol"], rtol=TOL["rtol"], ms=ms,
             loop_ms=cuda_ms(lambda: ck.coder_sweeps(*args), 20),
             plain_ms=cuda_ms(lambda: ck.coder_sweeps_plain(*args), 3),
             bound_ms=bound_ms, bound_by=by, share=bound_ms / ms)
    for r, n, mode in PATH_SHAPES["fista_sweeps"]:
        args = (*gram_inputs(r, n, gen, dev), 0.1, 0.01)
        kw = FISTA_MODES[mode]
        label = f"fista_sweeps {mode} r={r} n={n}"
        before = ck.LAUNCHES["fista_sweeps"]
        got = ck.fista_sweeps(*args, **kw)
        if ck.LAUNCHES["fista_sweeps"] != before + 1:
            raise AssertionError(f"{label}: no launch")
        # the plain version once: a host loop over up to 100 iterations
        (want, sweeps), plain_ms = timed_once(
            lambda: ck.fista_sweeps_plain(*args, **kw, with_sweeps=True))
        if mode == "bf16":
            # with the stop, a bf16 rounding can move a tile's stopping
            # iteration: the kernel is held to the plain version under the
            # two bf16 checks of phase 2 (one iteration; ten fixed ones),
            # and the timed call itself tile by tile
            one = dict(sub_iter=1, use_stopping=False, bf16_matmul=True)
            compare(label + " one iteration", ck.fista_sweeps(*args, **one),
                    ck.fista_sweeps_plain(*args, **one))
            ten = dict(one, sub_iter=10)
            tol = BF16_TOL
            err = compare(label + " ten iterations",
                          ck.fista_sweeps(*args, **ten),
                          ck.fista_sweeps_plain(*args, **ten), tol)
            if not bool(torch.isfinite(got).all() and (got >= 0).all()):
                raise AssertionError(f"{label}: bad output")
            stop_err, moved = stop_tiles_check(ck, label, got, want, sweeps,
                                               args, kw)
        else:
            tol = TOL
            err = compare(label, got, want)
            stop_err = moved = None
        ms = graph_ms(lambda: ck.fista_sweeps(*args, **kw),
                      reps=20 if n < 100000 else 5)
        bound_ms, by = coder_bound("fista_sweeps", r, n, args, kw, sweeps)
        emit("kernels", kernel="fista_sweeps", mode=mode, r=r, n=n, d=300,
             route=ck.kernel_route(
                 "fista_sweeps_stop" if kw.get("use_stopping", True)
                 else "fista_sweeps", r),
             tile=list(ck.fista_tile_config(
                 r, kw.get("use_stopping", True))[:3]),
             iterations_mean=float(sweeps.float().mean()),
             iterations_max=int(sweeps.max()), max_abs_err=err,
             atol=tol["atol"], rtol=tol["rtol"], stop_max_abs_err=stop_err,
             stop_tiles_moved=moved, ms=ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=by, share=bound_ms / ms)


def stop_tiles_check(ck, label, got, want, sweeps, args, kw):
    """The bf16 run with the stop against its plain version, tile by
    tile, at BF16_TOL. A bf16 rounding can move a tile's stopping iteration:
    such a tile must agree with the plain version run for a neighbouring
    count (``sweeps`` gives the plain version's; a tile that stops after k
    iterations holds k fixed ones). Returns the largest error of the tiles
    as matched and the number of tiles whose count moved."""
    A, B, H0, alpha, stop = args
    worst, moved = 0.0, 0
    for i, k in enumerate(sweeps.tolist()):
        cols = slice(i * ck.TN, min(got.shape[1], (i + 1) * ck.TN))
        g, w = got[:, cols], want[:, cols]
        if not torch.allclose(g, w, **BF16_TOL):
            for k2 in (k - 1, k + 1, k - 2, k + 2):
                if not 1 <= k2 <= kw["sub_iter"]:
                    continue
                w = ck.fista_sweeps_plain(
                    A, B[:, cols].contiguous(), H0[:, cols].contiguous(),
                    alpha, stop, sub_iter=k2, use_stopping=False,
                    bf16_matmul=True)
                if torch.allclose(g, w, **BF16_TOL):
                    moved += 1
                    break
            else:
                raise AssertionError(
                    f"{label}: tile {i} differs from the plain version by "
                    f"{float((g - want[:, cols]).abs().max())} and agrees "
                    f"with none of its runs of {k - 2} to {k + 2} iterations")
        worst = max(worst, float((g - w).abs().max()))
    return worst, moved


def cuda_kernel(ck, name, r, kw):
    """The CUDA kernel that coder ``name`` launches at rank r with the
    wrapper's keywords ``kw`` (FISTA's wide kernel with its regime)."""
    stop = name == "fista_sweeps" and kw.get("use_stopping", True)
    route = ck.kernel_route("fista_sweeps_stop" if stop else name, r)
    kernel = ROUTE_KERNELS[(name, route)]
    if kernel == "fista_wide_kernel":
        kernel += f" ({ck.fista_wide_config(r, stop)[0]})"
    elif kernel == "coder_wide_kernel":
        lanes, _, passes = ck.coder_wide_config(
            r, name == "coder_sweeps_earlystop")[:3]
        kernel += f" ({lanes} lanes, {passes} passes)"
    return kernel


def large_rank_kernels(ck, dev, gen):
    """The coders past their shared-memory ranks at LARGE_RANK_SHAPES
    (fixed-sweep coder_sweeps and FISTA still shared at r = 128), kernel
    against plain, with CUDA-event times of both, the kernel that ran, its
    bound and its share."""
    d = 300
    for r, n in LARGE_RANK_SHAPES:
        W = torch.rand((d, r), generator=gen)
        W = (W / W.norm(dim=0)).to(dev)
        X = torch.rand((d, n), generator=gen).to(dev)
        H0 = torch.rand((r, n), generator=gen).to(dev)
        A, B = W.T @ W, W.T @ X
        fista = dict(sub_iter=10, use_stopping=False)
        bf16 = dict(fista, bf16_matmul=True)
        cases = [
            ("coder_sweeps", "coder_sweeps", "", {}),
            ("coder_sweeps_earlystop", "coder_sweeps_earlystop", "", {}),
            ("fista_sweeps", "fista_sweeps", "fixed", fista),
            ("fista_sweeps", "fista_sweeps_stop", "stop", dict(sub_iter=10)),
            ("fista_sweeps", "fista_sweeps", "bf16_one_iteration",
             dict(bf16, sub_iter=1)),
            ("fista_sweeps", "fista_sweeps", "bf16", bf16),
        ]
        for name, route_name, mode, kw in cases:
            if r == 101 and route_name not in ("coder_sweeps_earlystop",
                                               "fista_sweeps_stop"):
                continue
            kernel = getattr(ck, name)
            plain = getattr(ck, name + "_plain")
            args = (A, B, H0, 0.1) if name == "coder_sweeps" \
                else (A, B, H0, 0.1, 0.01)
            label = f"{name} {mode} r={r} n={n}"
            tol = BF16_TOL if mode == "bf16" else TOL
            before = ck.LAUNCHES[name]
            got = kernel(*args, **kw)
            if ck.LAUNCHES[name] != before + 1:
                raise AssertionError(f"{label}: no kernel launched")
            err = compare(label, got, plain(*args, **kw), tol)
            ms = cuda_ms(lambda: kernel(*args, **kw), 5)
            plain_ms = cuda_ms(lambda: plain(*args, **kw), 2)
            bound_ms, by = coder_bound(name, r, n, args, kw)
            emit("kernels", kernel=name, mode=mode or None, r=r, n=n, d=d,
                 route=ck.kernel_route(route_name, r),
                 cuda_kernel=cuda_kernel(ck, name, r, kw), max_abs_err=err,
                 atol=tol["atol"], rtol=tol["rtol"], ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, by=by,
                 share=bound_ms / ms)


def checkerboard_kernels(dev, gen):
    """The checkerboard kernels site for site against the plain version: at
    PATH_SHAPES with route, device time, bound and share, then every route
    at every vector width (n % 16 == 0, n % 8 == 0, neither, where a Philox
    call straddles two rows), then two physics checks from an all-(+1)
    start at n = 4096; returns the summary of the n = 4096 comparison."""
    import ctypes

    from onmf_ontf_ndl_tpu_torch.ops.kernels import ising_kernel as ik

    def lattice(n):
        return (1 - 2 * torch.randint(0, 2, (n, n), generator=gen)).to(
            torch.int8).to(dev)

    lib = ik.build()["lib"]
    for band, n in ((200, 200), (25, 200), (128, 1024)):
        if lib.onmf_checkerboard_smem(band, n) \
                != ik._RES_HEAD_BYTES + band * n:
            raise AssertionError("the resident kernel's shared memory "
                                 f"at band={band} n={n} differs")
    summary, routes = {}, set()
    kw = dict(J=1.0, H=0.0, T=2.5)
    for n, sweeps in PATH_SHAPES["checkerboard_sweeps"]:
        lat = lattice(n)
        route = ik.checkerboard_route(n, sweeps)
        routes.add(route[0])
        before = ik.LAUNCHES["checkerboard_sweeps"]
        got = ik.checkerboard_sweeps(n, lat, sweeps, **kw)
        launched = ik.LAUNCHES["checkerboard_sweeps"] - before
        if launched != (1 if route[1] else 2 * sweeps):
            raise AssertionError(f"checkerboard n={n}: {launched} launches "
                                 f"on route {route}")
        want, plain_ms = timed_once(
            lambda: ik.checkerboard_sweeps_plain(n, lat, sweeps, **kw))
        # the device-seed entry, which the Ising round graphs launch
        before = ik.LAUNCHES["checkerboard_sweeps"]
        at = ik.checkerboard_sweeps(
            torch.tensor([n], dtype=torch.int64, device=dev), lat, sweeps,
            **kw)
        at_launched = ik.LAUNCHES["checkerboard_sweeps"] - before
        at_mismatched = int((at != want).sum())
        if at_launched != launched or at_mismatched:
            raise AssertionError(
                f"checkerboard n={n}, device seed: {at_launched} launches, "
                f"{at_mismatched} sites differ from the plain version")
        mismatched = int((got != want).sum())
        err = float((got.float() - want.float()).abs().max())
        ms = graph_ms(lambda: ik.checkerboard_sweeps(n, lat, sweeps, **kw),
                      reps=20 if route[1] else 5)
        bound_ms, by = checkerboard_bound(n, sweeps)
        emit("kernels", kernel="checkerboard_sweeps", n=n, sweeps=sweeps,
             route=list(route), launches=launched,
             mismatched_sites=mismatched,
             device_seed_mismatched_sites=at_mismatched,
             changed_sites=int((want != lat).sum()), max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
             share=bound_ms / ms)
        if mismatched:
            raise AssertionError(f"checkerboard n={n}: {mismatched} sites "
                                 "differ from the plain version")
        if n == 4096:
            summary.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=by)
    if routes != {"shared", "cluster", "global"}:
        raise AssertionError(f"PATH_SHAPES reached only the routes {routes}")
    # every route (ctas as in checkerboard_route) at every vector width
    thr = (ctypes.c_uint * 10)(*ik.acceptance_thresholds(1.0, 0.1, 2.3))
    for n, sweeps, ctas_all in ((2, 5, (0, 1)), (6, 7, (0, 1, 2)),
                                (24, 7, (0, 1, 4, 8)), (64, 7, (0, 1, 8)),
                                (202, 3, (0, 1, 8)), (200, 3, (0, 1, 2, 8)),
                                (482, 2, (1,)), (1022, 2, (0, 8)),
                                (1024, 2, (0, 8)), (1360, 1, (8,))):
        lat = lattice(n)
        want = ik.checkerboard_sweeps_plain(77, lat, sweeps, 1.0, 0.1, 2.3)
        for ctas in ctas_all:
            got = lat.clone()
            ik._launch(got, n, sweeps, 77, thr, ctas)
            mismatched = int((got != want).sum())
            emit("kernels", kernel="checkerboard_sweeps", check="route",
                 n=n, sweeps=sweeps, ctas=ctas, mismatched_sites=mismatched)
            if mismatched:
                raise AssertionError(
                    f"checkerboard n={n} ctas={ctas}: {mismatched} sites "
                    "differ from the plain version")
    # Onsager: |m| = 0.9993 at T = 1; T = 5 is far above T_c = 2.269
    ones = torch.ones((4096, 4096), dtype=torch.int8, device=dev)
    for T, ok in ((1.0, lambda m: m > 0.99), (5.0, lambda m: m < 0.05)):
        m = abs(float(ik.checkerboard_sweeps(1, ones, 100, T=T)
                      .float().mean()))
        emit("kernels", check="checkerboard_magnetization", n=4096,
             sweeps=100, T=T, abs_m=m)
        if not ok(m):
            raise AssertionError(f"magnetization {m} at T={T}")
    return summary


def group_kernels(dev, M=100_096, k=21, n=4039):
    """The grouping (``group_kernels.cu``) at the dense network
    reconstruction's shape (``NETWORK_RUNS`` (a): 100,096 pivot samples of
    the 21-node motif on 4,039 nodes) against its plain version on the
    same paints: the int64 key sort, segment sum and ``index_put`` into
    the two canvases. Node draws fall off as a power of the node's rank,
    as a Barabasi-Albert graph's walks crowd its hubs (runs up to ~10^5
    paints, over many of the run sum's tiles). The dense form: counts
    equal, each mean within float32 rounding of the float64 mean (the
    worst case over any order of the run's c - 1 additions, gamma_(c-1)
    of the sum, plus the division's rounding), and the plain version's
    means held to the same bound. The sparse form, with and without the
    self slots: pairs and counts equal, sums within the same bound.
    Device times by CUDA events (the plain version synchronises); the
    bound: the values and embeddings read once, the two canvases written
    once."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels.group_kernel import (
        group_pairs, group_pairs_plain)

    rng = np.random.default_rng(20)
    p = 1.0 / np.arange(1, n + 1) ** 0.8
    embs = torch.as_tensor(rng.choice(n, size=(M, k), p=p / p.sum()),
                           device=dev)
    vals = torch.as_tensor(rng.random((k * k, M), dtype=np.float32),
                           device=dev)
    canvas = [torch.zeros((n, n), device=dev) for _ in range(2)]
    plain_canvas = [torch.zeros((n, n), device=dev) for _ in range(2)]

    def plain():
        ii, jj, sums, cnt = group_pairs_plain(embs, vals, n)
        plain_canvas[0][ii, jj] = sums / cnt
        plain_canvas[1][ii, jj] = cnt
        return plain_canvas

    def sum_bound(exact):
        c = exact[3]
        g = (c - 1).clamp(min=0) * 2.0**-24
        return (g / (1 - g) + c * 2.0**-53) * exact[2]

    recon, count = group_pairs(embs, vals, n, canvas=canvas)
    want_recon, want_count = plain()
    exact = group_pairs_plain(embs, vals.double(), n)
    mean = exact[2] / exact[3]
    tol = sum_bound(exact) / exact[3] + 2.0**-23 * mean
    where = exact[0], exact[1]
    kernel_err = (recon[where].double() - mean).abs()
    plain_err = (want_recon[where].double() - mean).abs()
    err = float((recon - want_recon).abs().max())
    fields = dict(M=M, k=k, n=n, pairs=len(exact[0]),
                  longest_run=int(exact[3].max()),
                  count_mismatched=int((count != want_count).sum()),
                  max_abs_err=err,
                  max_err_vs_f64=float(kernel_err.max()),
                  plain_max_err_vs_f64=float(plain_err.max()),
                  max_tol=float(tol.max()))
    if fields["count_mismatched"] or not bool((kernel_err <= tol).all()) \
            or not bool((plain_err <= tol).all()) \
            or int((count > 0).sum()) != len(exact[0]):
        raise AssertionError(f"group_pairs dense: {fields}")
    for include_self in (True, False):
        got = group_pairs(embs, vals, n, include_self=include_self)
        want = group_pairs_plain(embs, vals, n, include_self)
        f64 = group_pairs_plain(embs, vals.double(), n, include_self)
        same = all(torch.equal(got[i], want[i]) for i in (0, 1, 3))
        sparse_err = (got[2].double() - f64[2]).abs()
        emit("kernels", kernel="group_pairs", form="sparse",
             include_self=include_self, pairs=len(got[0]),
             pairs_counts_equal=same,
             max_abs_err=float((got[2] - want[2]).abs().max()),
             max_err_vs_f64=float(sparse_err.max()))
        if not same or not bool((sparse_err <= sum_bound(f64)).all()):
            raise AssertionError(f"group_pairs sparse, include_self="
                                 f"{include_self}: differs")
    del exact, f64, want, got
    ms = cuda_ms(lambda: group_pairs(embs, vals, n, canvas=canvas), 20)
    sparse_ms = cuda_ms(lambda: group_pairs(embs, vals, n), 20)
    plain_ms = cuda_ms(plain, 5)
    nbytes = vals.numel() * 4 + embs.numel() * 8 + 2 * n * n * 4
    bound_ms, by = bound(nbytes, 0)
    emit("kernels", kernel="group_pairs", form="dense", **fields, ms=ms,
         sparse_ms=sparse_ms, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=by, share=bound_ms / ms)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by)


# (H, W, C, k, stride) of the reconstruction cells' paints: image-recon's
# stride-1 grid of 10 x 10 patches and tensor-recon's stride-2 grid of
# 20 x 20, on 1024 x 1024 colour images
PAINT_SHAPES = [(1024, 1024, 3, 10, 1), (1024, 1024, 3, 20, 2)]


def overlap_average_kernels(dev):
    """The overlap average (``patch_kernels.cu``) at ``PAINT_SHAPES``
    against its plain version, the ``F.fold`` form, on the same float32
    values on the card: within ``TOL``, and the canvas equal from call to
    call. Device times from a graph of 20 calls; the bound: the values
    read once and the canvas written once. The summary is the first
    shape's."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels.patch_kernel import (
        overlap_average)
    from onmf_ontf_ndl_tpu_torch.ops.patches import overlap_average_fold

    summary = None
    gen = torch.Generator(device=dev).manual_seed(27)
    for H, W, C, k, stride in PAINT_SHAPES:
        ni = nj = -(-(H - k) // stride)
        vals = torch.rand((k * k * C, ni * nj), generator=gen, device=dev)

        def kernel():
            return overlap_average(vals, k, stride, ni, nj, (H, W, C))

        def plain():
            return overlap_average_fold(vals, k, stride, ni, nj, (H, W, C))

        got, want = kernel(), plain()
        err = compare("overlap_average", got, want)
        if not torch.equal(got, kernel()):
            raise AssertionError("overlap_average: two calls differ")
        del got, want
        ms = graph_ms(kernel, replays=3)
        plain_ms = cuda_ms(plain, 5)
        bound_ms, by = bound(vals.numel() * 4 + H * W * C * 4, 0)
        emit("kernels", kernel="overlap_average", H=H, W=W, C=C, k=k,
             stride=stride, patches=ni * nj, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
             share=bound_ms / ms)
        summary = summary or dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=by)
    return summary


def sparse_dictionary_data(rng, d, r, n):
    Wt = np.abs(rng.standard_normal((d, r)))
    Wt /= np.linalg.norm(Wt, axis=0)
    codes = np.abs(rng.standard_normal((r, n))) * (rng.random((r, n)) < .3)
    return Wt, Wt @ codes + .01 * rng.random((d, n))


def headline_data(dev, d=300, r=25, n=131072):
    """The headline shape's data: (d, n) from a seeded sparse dictionary of
    rank r, built on the card."""
    gen = torch.Generator(device=dev).manual_seed(1)
    Wt = torch.rand((d, r), generator=gen, device=dev)
    Wt = Wt / Wt.norm(dim=0)
    codes = torch.rand((r, n), generator=gen, device=dev)
    codes = codes * (torch.rand(codes.shape, generator=gen, device=dev) < .3)
    return Wt @ codes + .01 * torch.rand((d, n), generator=gen, device=dev)


# the main path's three coders: fixed sweeps, the early stop, FISTA
CODERS = (("bcd", None), ("bcd", 0.01), ("fista", None))


def train_loop(st, X, batch, steps, coder, stop, **route):
    """``steps`` steps of ``train_dict``'s defaults (code tracked), through
    the training loop; ``route``: ``capture=`` where the package has it
    (``chip_compare.py`` also times a package from before it)."""
    from onmf_ontf_ndl_tpu_torch.models import onmf

    code = torch.zeros((st.r, X.shape[1]), device=X.device)
    return onmf._train_loop(st, X, code, 0.0, 1.0, stop, steps + 1, batch,
                            True, 10, True, "stale", backend="cuda",
                            coder=coder, **route)


def step_ms(X, batch, steps, coder, stop, **route):
    """Host ms of synchronised runs of ``steps``: the first run's (which
    captures on the captured route) and the least of three more, a
    step."""
    import onmf_ontf_ndl_tpu_torch as lib

    st = lib.init_state(3, X.shape[0], 25, device=X.device)
    runs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_loop(st, X, batch, steps, coder, stop, **route)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    return {"first_run_ms": runs[0], "step_ms": min(runs[1:]) / steps}


def captured_vs_eager(ck, X, batch, coder, stop, steps=20):
    """The captured route against the eager one from the same state and
    generator state: W, A and B equal bit for bit (the same kernels on the
    same inputs in the same order); the code within the stated bound; the
    generator's next draw equal; the captured run's kernel runs a step, as
    the kernels count them on the card."""
    import dataclasses

    import onmf_ontf_ndl_tpu_torch as lib
    from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (RUN_KERNELS,
                                                          device_runs)

    st = lib.init_state(4, X.shape[0], 25, device=X.device)
    runs = {}
    for capture in (False, True):
        gen = torch.Generator(device=X.device)
        gen.set_state(st.gen.get_state())
        before = device_runs()
        runs[capture] = train_loop(dataclasses.replace(st, gen=gen), X,
                                   batch, steps, coder, stop,
                                   capture=capture)
        after = device_runs()
        per_step = {k: (after[k] - before[k]) / steps
                    for k in RUN_KERNELS if after[k] > before[k]}
    (eager, e_code, _), (capt, c_code, _) = runs[False], runs[True]
    equal = {f: bool(torch.equal(getattr(eager, f), getattr(capt, f)))
             for f in "WAB"}
    # index_add_ adds a step's duplicate columns in a nondeterministic
    # order: each step may round each code entry once more, by at most one
    # float32 ulp of the largest entry
    code_bound = steps * 2.0 ** -23 * float(e_code.abs().max())
    code_err = float((e_code - c_code).abs().max())
    gen_equal = bool(torch.equal(
        torch.rand(8, generator=eager.gen, device=X.device),
        torch.rand(8, generator=capt.gen, device=X.device)))
    emit("main", check="captured_vs_eager", coder=coder, stopping_diff=stop,
         batch=batch, steps=steps, bitwise_equal=equal,
         code_max_abs_err=code_err, code_bound=code_bound,
         generator_equal=gen_equal, launches_per_step=per_step)
    if not (all(equal.values()) and code_err <= code_bound and gen_equal
            and set(per_step.values()) == {1.0}):
        raise AssertionError(f"captured run differs from eager: {equal}, "
                             f"code {code_err} > {code_bound}, generator "
                             f"{gen_equal}, launches {per_step}")


def phase_main(ck, dev):
    import onmf_ontf_ndl_tpu_torch as lib
    from onmf_ontf_ndl_tpu_torch.utils.profiling import Throughput

    ck.reset_launches()
    # the canonical drive: trained W should score like the ground truth
    # under the same coder (the coder floors near 0.17 on this problem)
    rng = np.random.default_rng(0)
    d, r, n = 100, 25, 2000
    Wt, X = sparse_dictionary_data(rng, d, r, n)
    nmf = lib.OnlineNMF(X, n_components=r, iterations=100, batch_size=100,
                        device=dev)

    def score(W):
        W = torch.as_tensor(W, dtype=nmf.dtype, device=dev)
        H = nmf.sparse_code(nmf.X, W)
        return float(torch.linalg.norm(nmf.X - W @ H)
                     / torch.linalg.norm(nmf.X))

    random_score = score(nmf.state.W)
    t0 = time.perf_counter()
    W, A, B, _, _ = nmf.train_dict()
    for _ in range(2):   # warm-started rounds, as the reference's scripts do
        nmf = lib.OnlineNMF(X, n_components=r, iterations=100,
                            batch_size=100, ini_dict=W, ini_A=A, ini_B=B,
                            history=nmf.history, device=dev)
        W, A, B, _, _ = nmf.train_dict()
    torch.cuda.synchronize()
    trained, truth = score(W), score(Wt)
    emit("main", check="online_nmf_canonical", rounds=3,
         seconds=time.perf_counter() - t0, random_w=random_score,
         trained_w=trained, truth_w=truth, ratio=trained / truth,
         limit=1.10)
    if not trained <= 1.10 * truth:
        raise AssertionError(f"trained W {trained} vs truth {truth}")

    # the headline shape: d = 300 (10x10 colour patches), r = 25, 10 sweeps
    d, r, batch, steps = 300, 25, 16384, 50
    X = headline_data(dev)
    tp = Throughput()
    for coder, stop in CODERS:
        st = lib.init_state(2, d, r, device=dev)
        # a run of the timed run's length first: it captures the step
        st, _ = lib.train_dict(st, X, iterations=steps + 1, batch_size=batch,
                               stopping_diff=stop, coder=coder)
        torch.cuda.synchronize()
        # the phase's timer and the port's Throughput around the same run
        t0 = time.perf_counter()
        with tp.measure(items=steps * batch):
            st, code = lib.train_dict(st, X, iterations=steps + 1,
                                      batch_size=batch, stopping_diff=stop,
                                      coder=coder)
            tp.fence((st, code))
        dt = time.perf_counter() - t0
        if not (torch.isfinite(st.W).all() and torch.isfinite(code).all()
                and (st.W >= 0).all()):
            raise AssertionError("non-finite or negative training state")
        emit("main", check="throughput", coder=coder, stopping_diff=stop,
             d=d, r=r, batch=batch, steps=steps, route="captured",
             step_ms=1e3 * dt / steps,
             patches_per_s=steps * batch / dt,
             throughput_patches_per_s=tp.items_per_sec)
    FINAL_STATES["main"] = st
    # the main path's launches: the captured runs above only; the eager
    # comparisons and timings below do not count
    launches = check_launches(ck, "main")
    # eager per-step overhead: a batch so small that the card is idle
    st = lib.init_state(3, d, r, device=dev)
    train_loop(st, X, 128, 2, "bcd", None, capture=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_loop(st, X, 128, 100, "bcd", None, capture=False)
    torch.cuda.synchronize()
    emit("main", check="eager_step_overhead", batch=128, route="eager",
         step_ms=1e3 * (time.perf_counter() - t0) / 100)
    for b in (batch, 128):
        for coder, stop in CODERS:
            captured_vs_eager(ck, X, b, coder, stop)
            fields = {}
            for route in ("eager", "captured"):
                ms = step_ms(X, b, steps, coder, stop,
                             capture=route == "captured")
                fields.update({f"{route}_{k}": v for k, v in ms.items()})
            emit("main", check="step_ms", coder=coder, stopping_diff=stop,
                 batch=b, steps=steps, **fields)

    # the same short run on the card (kernels, float32) and on the CPU
    # (plain, float64) from the same draws; fixed sweeps, so both run the
    # same schedule. float32 vs float64 over 5 steps: measured ~5e-6
    # relative on the CPU; limit 1e-4.
    rng = np.random.default_rng(5)
    Xh = X[:, :8192].cpu().numpy().astype(np.float64)
    W0 = rng.random((d, r))
    draws = [(rng.integers(0, 8192, 2048), rng.random((r, 2048)))
             for _ in range(5)]
    out = {}
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        st = lib.init_state(0, d, r, device=device, dtype=dtype, W=W0)
        dr = [(torch.as_tensor(i, device=device),
               torch.as_tensor(h, dtype=dtype, device=device))
              for i, h in draws]
        st, code = lib.train_dict(
            st, torch.as_tensor(Xh, dtype=dtype, device=device),
            iterations=6, batch_size=2048, stopping_diff=None, draws=dr)
        out[device] = (st.W.double().cpu(), code.double().cpu())
    rel = [rel_err(a, b) for a, b in zip(out[dev], out["cpu"])]
    emit("main", check="cuda_f32_vs_cpu_f64", rel_err_W=rel[0],
         rel_err_code=rel[1], limit=1e-4)
    if not max(rel) <= 1e-4:
        raise AssertionError(f"card run differs from the CPU run: {rel}")
    return launches


def synthetic_image(seed, h=1024, w=1024):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0) \
        + 0.1 * np.sin((xx + 2 * yy) / 3.0)
    img = np.stack([base, base**2, 1 - base], axis=-1)
    return np.clip(img + 0.02 * rng.random(img.shape), 0, 1)


def masked_err(out, img):
    """Relative error over the painted pixels."""
    mask = out.sum(dim=-1) > 0
    return float(torch.linalg.norm((out - img)[mask])
                 / torch.linalg.norm(img[mask]))


def phase_image(dev, img):
    from onmf_ontf_ndl_tpu_torch.apps.image import (ImageReconstructor,
                                                    reconstruct)
    from onmf_ontf_ndl_tpu_torch.models.state import make_generator

    kw = dict(data=img, device=dev, patch_size=10, n_components=25,
              num_patches=16384, sub_iterations=10, seed=4)
    rec = ImageReconstructor(iterations=5, **kw)
    W0 = rec.state.W.clone()
    t0 = time.perf_counter()
    _, key = rounds_taken(rec.train_dict, "image", 5)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = rec.reconstruct_image_color(data=img, recons_resolution=2)
    torch.cuda.synchronize()
    recon_s = time.perf_counter() - t0
    out0 = reconstruct(img, W0 / W0.norm(dim=0).clamp_min(1.0),
                       make_generator(17, dev), patch_size=10, stride=2)

    if tuple(out.shape) != tuple(img.shape) or not torch.isfinite(out).all():
        raise AssertionError("bad reconstruction")
    emit("image", train_seconds=train_s, recon_seconds=recon_s,
         recon_err=masked_err(out, img),
         recon_err_initial_w=masked_err(out0, img), history=rec.state.t)
    if not masked_err(out, img) < masked_err(out0, img):
        raise AssertionError("training did not lower the recon error")
    FINAL_STATES["image"] = rec.state

    def run():
        again = ImageReconstructor(iterations=5, **kw)
        again.train_dict()
        return again.state, torch.rand(8, generator=again.state.gen,
                                       device=dev)

    round_checks("image", key, 5, run, counted_train_seconds=train_s)

    with tempfile.TemporaryDirectory(
            dir=Path(__file__).resolve().parent) as tmp:
        path = str(Path(tmp) / "image_state.npz")
        part = ImageReconstructor(iterations=3, **kw)
        part.train_dict(checkpoint_path=path, checkpoint_every=2)
        resumed = ImageReconstructor(iterations=5, **kw)
        resumed.train_dict(checkpoint_path=path, checkpoint_every=2,
                           resume=True)
    diff = float((resumed.state.W - rec.state.W).abs().max())
    emit("image", check="checkpoint_resume", history=resumed.state.t,
         max_abs_diff_vs_uninterrupted=diff, limit=1e-5)
    if not (resumed.state.t == rec.state.t and diff <= 1e-5):
        raise AssertionError(f"resumed run differs: {diff}")


def phase_tensor(ck, dev, img):
    """The tensor path at benchmarks/run_all.py's configuration: r = 100,
    patch 20, joint mode 2 (d = 1200), 20 outer iterations of 2 inner, 100
    patches, block_iterations 4 (so the exact coder runs FISTA with at
    least 100 iterations and the 0.01 stop)."""
    from onmf_ontf_ndl_tpu_torch.apps.image import reconstruct
    from onmf_ontf_ndl_tpu_torch.apps.image_tensor import (
        ImageReconstructorTensor, _train_tensor)
    from onmf_ontf_ndl_tpu_torch.models.state import init_state, make_generator

    ck.reset_launches()
    kw = dict(data=img, n_components=100, iterations=20, sub_iterations=2,
              batch_size=100, block_iterations=4, num_patches=100,
              patch_size=20, device=dev, seed=3)
    rec = ImageReconstructorTensor(**kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    W, key = rounds_taken(lambda: rec.train_dict(
        mode=2, learn_joint_dict=True), "tensor", 20)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = rec.reconstruct_image_color(data=img, recons_resolution=2)
    torch.cuda.synchronize()
    recon_s = time.perf_counter() - t0
    launches = check_launches(ck, "tensor")
    FINAL_STATES["tensor"] = rec.state

    def run():
        again = ImageReconstructorTensor(**kw)
        again.train_dict(mode=2, learn_joint_dict=True)
        return again.state, torch.rand(8, generator=again.state.gen,
                                       device=dev)

    round_checks("tensor", key, 20, run, counted_train_seconds=train_s)
    W0 = init_state(3, 1200, 100, device=dev).W
    out0 = reconstruct(img, W0 / W0.norm(dim=0).clamp_min(1.0),
                       make_generator(29, dev), patch_size=20, stride=2,
                       sub_iter=rec.coder_sub_iter, method="fista")
    e, e0 = masked_err(out, img), masked_err(out0, img)
    emit("tensor", W_shape=list(W.shape), coder_sub_iter=rec.coder_sub_iter,
         train_seconds=train_s, recon_seconds=recon_s, recon_patches=502**2,
         recon_err=e, recon_err_initial_w=e0, history=rec.state.t)
    if tuple(out.shape) != tuple(img.shape) or not torch.isfinite(out).all() \
            or not (W >= 0).all():
        raise AssertionError("bad tensor dictionary or reconstruction")
    if not e < e0:
        raise AssertionError(f"training did not lower the error: {e} {e0}")

    # the same short run on the card (float32) and on the CPU (float64)
    # from the same draws, fixed FISTA iterations; limit 1e-3 relative
    rng = np.random.default_rng(6)
    k, num, r, d = 20, 100, 100, 1200
    small = img[:200, :200].double().cpu()
    W0 = rng.random((d, r))
    draws = [((rng.integers(0, 180, num), rng.integers(0, 180, num)),
              [(rng.integers(0, num, num), rng.random((r, num)))])
             for _ in range(3)]
    res = {}
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        dr = [(tuple(torch.as_tensor(c, device=device) for c in cs),
               [(torch.as_tensor(i, device=device),
                 torch.as_tensor(h, dtype=dtype, device=device))
                for i, h in inner]) for cs, inner in draws]
        st = init_state(0, d, r, device=device, dtype=dtype, W=W0)
        st = _train_tensor(
            st, small.to(device, dtype), outer_iterations=3,
            num_patches=num, inner_iterations=2, batch_size=num,
            patch_size=k, mode=2, joint=True, alpha=2.0, beta=1.0,
            sub_iter=100, use_stopping=False, coder="fista", draws=dr)
        res[str(device)] = st.W
    rel = rel_err(res[str(dev)], res["cpu"])
    emit("tensor", check="cuda_f32_vs_cpu_f64", rel_err_W=rel, limit=1e-3)
    if not rel <= 1e-3:
        raise AssertionError(f"card run differs from the CPU run: {rel}")
    return launches


# Phase 6's configuration (benchmarks/run_all.py's), which the CLI's and the
# data-parallel runs of phases 9 and 10 repeat: every key is an IsingConfig
# field
ISING_RUN = dict(n_components=100, lattice_size=200, ising_iterations=20,
                 temperature=5.0, ising_subsampling_steps=40000,
                 sub_iterations=20, batch_size=50, num_patches=1000,
                 patch_size=20, beta=1.0, seed=5)


def phase_ising(ck, dev):
    """The Ising path at benchmarks/run_all.py's configuration: r = 100,
    lattice 200, 20 rounds at T = 5, 40000 subsampling steps (one sweep a
    round), 20 inner iterations on 1000 patches of 20x20 (d = 400), early
    stop; then a config reconstruction (fixed sweeps)."""
    from onmf_ontf_ndl_tpu_torch.apps.ising import (
        IsingReconstructor, ising_trajectory_learning)
    from onmf_ontf_ndl_tpu_torch.models.state import init_state

    ck.reset_launches()
    rec = IsingReconstructor(**ISING_RUN, device=dev)
    lat0 = rec.lattice.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_, dict_stack, errors), key = rounds_taken(
        rec.ising_mcmc_learning, "ising", ISING_RUN["ising_iterations"])
    learn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = rec.reconstruct_config(rec.lattice)
    torch.cuda.synchronize()
    recon_s = time.perf_counter() - t0
    launches = check_launches(ck, "ising")
    FINAL_STATES["ising"] = rec.state

    def run():
        again = IsingReconstructor(**ISING_RUN, device=dev)
        _, stack, errs = again.ising_mcmc_learning()
        return (again.state, stack, errs, again.lattice,
                torch.rand(8, generator=again.gen, device=dev),
                torch.rand(8, generator=again.state.gen, device=dev))

    round_checks("ising", key, ISING_RUN["ising_iterations"], run,
                 counted_train_seconds=learn_s)
    REFERENCE["ising"] = (rec.state, dict_stack, errors, rec.lattice)
    REFERENCE["ising_learn_seconds"] = learn_s
    emit("ising", learn_seconds=learn_s, recon_seconds=recon_s,
         errors_len=len(errors), error_first=float(errors[0]),
         error_last=float(errors[-1]),
         lattice_changed_sites=int((rec.lattice != lat0).sum()),
         dict_stack=list(dict_stack.shape))
    if not (len(errors) == 21 and bool(torch.isfinite(errors).all())
            and bool((rec.W >= 0).all()) and tuple(out.shape) == (200, 200)
            and bool(torch.isfinite(out).all())):
        raise AssertionError("bad Ising learning result")

    # the same short run on the card (float32) and on the CPU (float64)
    # from the same draws and a fixed lattice, fixed sweeps; limit 1e-3
    rng = np.random.default_rng(7)
    n, k, r, num = 40, 6, 10, 200
    lat = rng.choice(np.array([1, -1], np.int8), (n, n))
    W0 = rng.random((k * k, r))
    draws = [((rng.integers(0, n - k, num), rng.integers(0, n - k, num)),
              [(None, rng.random((r, num))) for _ in range(4)])
             for _ in range(4)]
    res = {}
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        dr = [(tuple(torch.as_tensor(c, device=device) for c in cs),
               [(None, torch.as_tensor(h, dtype=dtype, device=device))
                for _, h in inner]) for cs, inner in draws]
        st = init_state(0, k * k, r, device=device, dtype=dtype, W=W0,
                        track_xxt=True)
        _, stack, errs, _, _ = ising_trajectory_learning(
            st, torch.as_tensor(lat, device=device),
            torch.Generator(device=device), ising_iterations=3, nsteps=1,
            num_patches=num, inner_iterations=5, batch_size=num,
            patch_size=k, update_lattice=False, use_stopping=False,
            draws=dr)
        res[str(device)] = (stack, errs)
    rel = [rel_err(a, b) for a, b in zip(res[str(dev)], res["cpu"])]
    emit("ising", check="cuda_f32_vs_cpu_f64", rel_err_dict_stack=rel[0],
         rel_err_errors=rel[1], limit=1e-3)
    if not max(rel) <= 1e-3:
        raise AssertionError(f"card run differs from the CPU run: {rel}")
    return launches


def phase_stack(ck, dev):
    """The image app's stacked path on what the reference names for it, a
    stack of Ising lattices: 8 lattices of 200 x 200 at T = 2.5, 16
    checkerboard sweeps apart (a resident call of the sampler), r = 25,
    patch 10 (d = 100), 1000 patches a lattice, 10 inner steps, two passes;
    then the grey full-grid reconstruction of the first lattice."""
    from onmf_ontf_ndl_tpu_torch.apps.image import ImageReconstructor
    from onmf_ontf_ndl_tpu_torch.models.state import make_generator
    from onmf_ontf_ndl_tpu_torch.samplers.ising import (checkerboard_sweeps,
                                                        init_lattice)

    ck.reset_launches()
    lat = init_lattice(make_generator(9, dev), 200)
    lats = []
    for i in range(8):
        lat = checkerboard_sweeps(100 + i, lat, 16, T=2.5)
        lats.append(lat)
    stack = (torch.stack(lats).float() + 1.0) / 2.0
    kw = dict(data=stack, is_stack=True, n_components=25, iterations=16,
              sub_iterations=10, num_patches=1000, patch_size=10,
              downscale_factor=1, device=dev, seed=2)
    rec = ImageReconstructor(**kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    W, key = rounds_taken(rec.train_dict, "video", 16)
    train_s = time.perf_counter() - t0
    out = rec.reconstruct_image(data=stack[0])
    torch.cuda.synchronize()
    launches = check_launches(ck, "stack")
    FINAL_STATES["stack"] = rec.state

    def run():
        again = ImageReconstructor(**kw)
        again.train_dict()
        return again.state, torch.rand(8, generator=again.state.gen,
                                       device=dev)

    round_checks("stack", key, 16, run, counted_train_seconds=train_s)
    err = float(torch.linalg.norm(out - stack[0])
                / torch.linalg.norm(stack[0]))
    emit("stack", stack=list(stack.shape),
         W_shape=list(W.shape), train_seconds=train_s, history=rec.state.t,
         magnetization=float(lats[-1].float().mean()), recon_err=err)
    if not (tuple(W.shape) == (100, 25) and bool((W >= 0).all())
            and bool(torch.isfinite(W).all()) and rec.state.t == 2 * 8 * 10
            and tuple(out.shape) == (200, 200)
            and bool(torch.isfinite(out).all()) and err < 1.0):
        raise AssertionError("bad stacked-image result")
    return launches


def synthetic_frames(dev, frames=16, h=256, w=256):
    """A drifting colour pattern with a little noise, (F, H, W, 3) in
    [0, 1], built on the device from a seed."""
    gen = torch.Generator(device=dev).manual_seed(12)
    yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    t = torch.arange(frames, device=dev, dtype=torch.float32)[:, None, None]
    base = 0.5 + 0.3 * torch.sin((xx + 3 * t) / 7.0) * torch.cos(yy / 11.0) \
        + 0.1 * torch.sin((xx + 2 * yy - 5 * t) / 3.0)
    out = torch.stack([base, base**2, 1 - base], dim=-1)
    noise = torch.rand(out.shape, generator=gen, device=dev)
    return torch.clamp(out + 0.02 * noise, 0, 1)


def phase_video(ck, dev):
    """The video path at the reference's defaults (r = 100, patch 7,
    colour: d = 147; 200 patches a frame, 10 inner steps, early stop) on 16
    frames of 256 x 256 x 3, one epoch; then frame 8 reconstructed at
    stride 1 (62,001 patches)."""
    from onmf_ontf_ndl_tpu_torch import VideoDictionaryLearner
    from onmf_ontf_ndl_tpu_torch.apps.image import reconstruct
    from onmf_ontf_ndl_tpu_torch.models.state import make_generator

    frames = synthetic_frames(dev)
    ck.reset_launches()
    rec = VideoDictionaryLearner(frames=frames, device=dev, seed=8)
    W0 = rec.W.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    W, key = rounds_taken(lambda: rec.train_dict(epochs=1), "video", 16)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = rec.reconstruct_frame(8)
    torch.cuda.synchronize()
    recon_s = time.perf_counter() - t0
    launches = check_launches(ck, "video")
    FINAL_STATES["video"] = rec.state

    def run():
        again = VideoDictionaryLearner(frames=frames, device=dev, seed=8)
        again.train_dict(epochs=1)
        return again.state, torch.rand(8, generator=again.state.gen,
                                       device=dev)

    round_checks("video", key, 16, run, counted_train_seconds=train_s)
    out0 = reconstruct(frames[8], W0 / W0.norm(dim=0).clamp_min(1.0),
                       make_generator(31, dev), patch_size=7)
    e, e0 = masked_err(out, frames[8]), masked_err(out0, frames[8])
    emit("video", frames=list(frames.shape), W_shape=list(W.shape),
         train_seconds=train_s, recon_seconds=recon_s, recon_patches=249**2,
         recon_err=e, recon_err_initial_w=e0, history=rec.state.t)
    if not (tuple(W.shape) == (147, 100) and bool((W >= 0).all())
            and bool(torch.isfinite(W).all()) and rec.state.t == 16 * 10
            and tuple(out.shape) == (256, 256, 3)
            and bool(torch.isfinite(out).all())):
        raise AssertionError("bad video dictionary or reconstruction")
    if not e < e0:
        raise AssertionError(f"training did not lower the error: {e} {e0}")
    return launches


def torus_edges(m):
    """Edges of the m x m torus, each node's (down, right) pair in turn:
    ``benchmarks/scale_extras.py::torus_edges``."""
    u = np.arange(m * m, dtype=np.int64).reshape(m, m)
    e = np.empty((2 * m * m, 2), np.int64)
    e[:, 0] = np.repeat(u.reshape(-1), 2)
    e[0::2, 1] = np.roll(u, -1, axis=0).reshape(-1)
    e[1::2, 1] = np.roll(u, -1, axis=1).reshape(-1)
    return e


def ba_edges(n, m, seed, chunk=4096):
    """A Barabasi-Albert edge list from an (m+1)-clique, targets drawn from
    the repeated-endpoint bag as of each chunk's start:
    ``benchmarks/scale_extras.py::ba_edges``."""
    rng = np.random.default_rng(seed)
    init = np.asarray([(i, j) for i in range(m + 1) for j in range(i)],
                      np.int64)
    bag = np.empty(2 * (m * n + len(init)), np.int64)
    bl = init.size
    bag[:bl] = init.reshape(-1)
    pieces, node = [init], m + 1
    while node < n:
        c = min(chunk, n - node, max(1, bl // (2 * m)))
        e = np.stack([np.repeat(np.arange(node, node + c), m),
                      bag[rng.integers(0, bl, c * m)]], axis=1)
        pieces.append(e)
        bag[bl:bl + e.size] = e.reshape(-1)
        bl += e.size
        node += c
    return np.concatenate(pieces)


def chain_start(g, B, chains, seed, dev):
    """A generator of ``seed`` and ``chains`` chains grown from uniform
    pivots drawn from it, as ``_recon_sample_vals`` grows them."""
    from onmf_ontf_ndl_tpu_torch.samplers.motif import (tree_parents,
                                                        tree_sample)

    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.randint(0, g.num_nodes, (chains,), generator=gen, device=dev)
    return gen, tree_sample(gen, tree_parents(B), g, x0)


def chain_rate(g, B, chains, steps, use_glauber, dev, **route):
    """Sequential chain steps per second of ``chains`` chains (each step
    moves every chain once), host clock around synchronised runs, after a
    run of the same length (which captures on the captured route);
    ``route``: ``capture=`` where the package has it (``chip_compare.py``
    also times a package from before it)."""
    from onmf_ontf_ndl_tpu_torch.samplers.motif import run_chains

    gen, emb0 = chain_start(g, B, chains, 11, dev)
    run_chains(gen, g, emb0, B, steps, use_glauber=use_glauber, **route)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_chains(gen, g, emb0, B, steps, use_glauber=use_glauber, **route)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def chains_equal(g, B, chains, steps, use_glauber, dev, route, other):
    """``run_chains`` with the keywords ``route`` against ``other`` from
    the same chains and generator state: the trail, the final embeddings
    and the generator's next draw equal bit for bit (the same moves on the
    same draws). Returns the three verdicts and the largest difference of
    the trails."""
    from onmf_ontf_ndl_tpu_torch.samplers.motif import run_chains

    out = []
    for kw in (route, other):
        gen, emb0 = chain_start(g, B, chains, 12, dev)
        trail = run_chains(gen, g, emb0, B, steps, use_glauber=use_glauber,
                           **kw)
        out.append((trail, torch.rand(8, generator=gen, device=dev)))
    (a, a_next), (b, b_next) = out
    return dict(trail=bool(torch.equal(a, b)),
                final=bool(torch.equal(a[:, -1], b[:, -1])),
                generator=bool(torch.equal(a_next, b_next))), \
        float((a - b).abs().max())


def chain_blocks(g, B, chains, steps, use_glauber):
    """(kind, M, the run's blocks as (moves, times)) of a run of ``steps``
    moves of these chains: ``_chain_block_moves`` and ``_chain_blocks``."""
    from onmf_ontf_ndl_tpu_torch.samplers import motif

    k = B.shape[0]
    kind = motif._chain_kind(use_glauber, k)
    roots = sum(p < 0 for p in motif.tree_parents(B))
    M = motif._chain_block_moves(chains, k, kind, steps, roots)
    return kind, M, motif._chain_blocks(steps, M)


def chain_keys(g, B, chains, steps, use_glauber, dev, backend="auto"):
    """The cache keys of a run's block graphs: the blocks of M, and the
    rest's where there is a rest."""
    from onmf_ontf_ndl_tpu_torch.samplers import motif

    emb = torch.empty((chains, B.shape[0]), dtype=torch.int64, device=dev)
    return [motif._chain_key(g, emb, B, use_glauber, moves, backend)
            for moves, _ in chain_blocks(g, B, chains, steps,
                                         use_glauber)[2]]


def chain_trace(g, B, chains, steps, use_glauber, dev, **route):
    """Per move of one whole run of ``steps`` moves of ``chains`` chains on
    the route of the keywords ``route``, under ``torch.profiler`` after a
    run of the same length: the CUDA graphs launched, the kernels launched
    from the host, the copies started from the host and the device
    operations run (kernels, copies and fills, those of replayed graphs
    included); and the run's blocks beside the chain kernel's own runs in
    it (``device_runs``; none on the plain moves)."""
    from torch.profiler import ProfilerActivity, profile

    from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (device_runs,
                                                          reset_launches)
    from onmf_ontf_ndl_tpu_torch.samplers.motif import run_chains

    gen, emb0 = chain_start(g, B, chains, 13, dev)
    run_chains(gen, g, emb0, B, steps, use_glauber=use_glauber, **route)
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_chains(gen, g, emb0, B, steps, use_glauber=use_glauber, **route)
        torch.cuda.synchronize()
    runs = device_runs()["chain_move"]
    counts = {"graph": 0, "kernel": 0, "copy": 0, "device": 0}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            counts["device"] += ev.count
        elif ev.key == "cudaGraphLaunch":
            counts["graph"] += ev.count
        elif ev.key.startswith("cudaLaunchKernel"):
            counts["kernel"] += ev.count
        elif ev.key.startswith("cudaMemcpy"):
            counts["copy"] += ev.count
    _, M, blocks = chain_blocks(g, B, chains, steps, use_glauber)
    return dict({f"{name}_per_move": n / steps for name, n in counts.items()},
                moves=steps, block_moves=M,
                blocks=sum(times for _, times in blocks), kernel_runs=runs)


def chain_checks(g, B, chains, steps, use_glauber, dev):
    """The checks and times of a chain of ``steps`` moves (its run's own):
    the kernel's captured route against its eager route and against the
    plain captured route (``backend="torch"``), all bit for bit
    (``chains_equal``); steps per second on those three routes; per move
    over one whole run on the kernel's and the plain captured routes the
    graphs, host launches, host copies and device operations, and the
    kernel's runs beside the run's blocks (``chain_trace``, which must
    agree: one launch a block); the block kernel's and the plain block's ms
    a move at the route's M, the bound and share
    (``chain_kernel_times``)."""
    args = (g, B, chains)
    eager, err_eager = chains_equal(*args, steps, use_glauber, dev, {},
                                    dict(capture=False))
    plain, err_plain = chains_equal(*args, steps, use_glauber, dev, {},
                                    dict(backend="torch"))
    fields = dict(chain_captured_vs_eager=eager, chain_kernel_vs_plain=plain,
                  chains_equal=all(eager.values()) and all(plain.values()),
                  chain_max_abs_err=max(err_eager, err_plain))
    for name, route in (("", {}), ("_eager", dict(capture=False)),
                        ("_plain", dict(backend="torch"))):
        fields[f"chain_steps_per_s{name}"] = chain_rate(
            *args, steps, use_glauber, dev, **route)
        if name != "_eager":
            fields[f"chain_trace{name}"] = chain_trace(
                *args, steps, use_glauber, dev, **route)
    trace = fields["chain_trace"]
    fields["chain_one_launch_per_block"] = (trace["kernel_runs"]
                                            == trace["blocks"])
    fields["chain_move"] = chain_kernel_times(*args, steps, use_glauber, dev)
    return fields


@contextlib.contextmanager
def plain_chain_moves():
    """Every chain move on the plain version, as ``backend="torch"``
    gives it, also for the apps, which take no backend: the route function
    that ``samplers/motif.py`` asks, swapped for the time of the block."""
    from onmf_ontf_ndl_tpu_torch.samplers import motif

    route = motif.chain_move_route
    motif.chain_move_route = (
        lambda device_type, backend="auto": route(device_type, "torch"))
    try:
        yield
    finally:
        motif.chain_move_route = route


def chain_block_inputs(g, B, chains, steps, use_glauber, dev):
    """A block's arguments for ``chains`` chains of ``chain_start`` in a
    run of ``steps`` moves: (kind, emb, draws, tbl, parents), M moves'
    draws at the route's M, taken as ``_chain_block`` takes them."""
    from onmf_ontf_ndl_tpu_torch.samplers import motif

    gen, emb = chain_start(g, B, chains, 14, dev)
    parents = motif.tree_parents(B)
    kind, M, _ = chain_blocks(g, B, chains, steps, use_glauber)
    ch = motif._new_chains(emb, kind, M, sum(p < 0 for p in parents))
    motif._block_draws(ch, gen, parents, g.num_nodes, kind)
    tbl = motif._neighbor_table_on(B, dev) if kind == "glauber" else None
    return kind, ch.emb, ch.draws, tbl, parents


def _row_entries(g, x, idx):
    """("nbr_flat" or "nbr", the flat indices) of entry ``idx`` of the
    neighbour rows of the nodes ``x``."""
    from onmf_ontf_ndl_tpu_torch.data.graphs import BitsetGraph, CsrGraph

    if isinstance(g, (CsrGraph, BitsetGraph)):
        return "nbr_flat", g.offsets[x] + idx
    return "nbr", x * g.nbr.shape[1] + idx


def _search_reads(g, r, v):
    """The nbr_flat indices that the kernel's lower-bound binary search of
    each v in r's CSR row reads (``has_edge``): every probe, then the
    entry it ends on where that is in the row."""
    base, lo, hi = g.offsets[r], torch.zeros_like(r), g.deg[r].clone()
    out = []
    while bool((lo < hi).any()):
        on = lo < hi
        mid = (lo + hi) >> 1
        out.append((base + mid)[on])
        less = g.nbr_flat[(base + mid).clamp(max=g.nbr_flat.shape[0] - 1)] < v
        lo = torch.where(on & less, mid + 1, lo)
        hi = torch.where(on & ~less, mid, hi)
    out.append((base + lo)[lo < g.deg[r]])
    return torch.cat(out) if out else r[:0]


def chain_move_reads(g, kind, before, after, draws, tbl, parents):
    """The graph elements that one move of these chains must read, as
    (array name, flat indices) pairs; ``before`` and ``after`` the chains
    around the move, ``draws`` the move's (without the M axis). A Glauber
    move: the first valid constraint image's degree (and row start) and
    candidate row, then per candidate each other valid constraint's test
    in slot order until one fails (as the kernel's ``candidate_ok`` stops):
    one adjacency byte (dense), one word (bitset), or the row's degree and
    start and the entries a binary search probes (CSR). The walk: the
    root's degree (and row start), the entry it proposes and that node's
    degree. A regrown node: its parent's degree (and row start) and the
    entry it picks."""
    from onmf_ontf_ndl_tpu_torch.data.graphs import BitsetGraph, CsrGraph
    from onmf_ontf_ndl_tpu_torch.samplers import motif

    csr = isinstance(g, (CsrGraph, BitsetGraph))
    reads = []

    def node_rows(x, u):        # the degree, row start and picked entry
        d = g.deg[x]
        reads.append(("deg", x))
        if csr:
            reads.append(("offsets", x[d > 0]))
        on = d > 0
        idx = torch.minimum((u * d.clamp_min(1)).long(), d.clamp_min(1) - 1)
        name, at = _row_entries(g, x[on], idx[on])
        reads.append((name, at))
        return on, (g.nbr_flat if csr else g.nbr.reshape(-1))[at]

    if kind == "glauber":
        sel = tbl[draws[0]]                                 # (C, S)
        valid = sel >= 0
        has = valid.any(1)
        imgs = before.gather(1, sel.clamp_min(0))
        first = valid.long().argmax(1)
        u0 = imgs.gather(1, first[:, None])[:, 0][has]
        reads.append(("deg", u0))
        if csr:
            reads.append(("offsets", u0))
        d0 = g.deg[u0]
        chain = torch.repeat_interleave(torch.arange(len(u0), device=u0.device),
                                        d0)
        idx = torch.arange(len(chain), device=u0.device) - \
            torch.repeat_interleave(torch.cumsum(d0, 0) - d0, d0)
        name, at = _row_entries(g, u0[chain], idx)
        reads.append((name, at))
        v = (g.nbr_flat if csr else g.nbr.reshape(-1))[at]
        alive = torch.ones_like(v, dtype=torch.bool)
        imgs, valid, first = imgs[has][chain], valid[has][chain], \
            first[has][chain]
        for slot in range(sel.shape[1]):
            test = alive & valid[:, slot] & (first != slot)
            r, w = imgs[test, slot], v[test]
            if isinstance(g, BitsetGraph):
                reads.append(("bits", r * g.bits.shape[1] + (w >> 5)))
            elif csr:
                reads += [("deg", r), ("offsets", r),
                          ("nbr_flat", _search_reads(g, r, w))]
            else:
                reads.append(("adj", r * g.num_nodes + w))
            alive[test] = motif._has_edges(g, r, w)
        return reads
    if kind in ("walk", "pivot"):
        x = before[:, 0]
        on, y = node_rows(x, draws[0])
        reads.append(("deg", y))
    if kind != "walk":
        tree = draws[-2]
        for i, p in enumerate(parents, start=1):
            if p >= 0:
                node_rows(after[:, p], tree[i - 1])
    return reads


def chain_block_bound(g, kind, emb, draws, tbl, parents):
    """(ms, "bytes" or "operations"): the least time of a block of M moves
    of these chains with these (M, ...) draws. Bytes, counted from this
    block's data: the embeddings read and written once, every draw, the
    motif's table and parent list read once, the trail's M rows written,
    and each graph element that the block's moves read
    (``chain_move_reads``, on the chains as each move finds them: the plain
    moves advance a copy) read once, however many moves read it. Integer
    operations: two per byte read (a compare and an index), at
    ``PEAK_INT_ALU``."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels import motif_kernel as mk

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    C, k = emb.shape
    M = draws[0].shape[0]
    nbytes_ = (16 * C * k + 8 * C * k * M + nbytes(*draws)
               + 8 * len(parents) + (0 if tbl is None else nbytes(tbl)))
    reads = collections.defaultdict(list)
    e = emb.clone()
    for s in range(M):
        before = e.clone()
        mk.chain_moves_plain(kind, e, tuple(d[s:s + 1] for d in draws), g,
                             tbl, parents)
        for name, at in chain_move_reads(g, kind, before, e,
                                         tuple(d[s] for d in draws), tbl,
                                         parents):
            reads[name].append(at)
    for name, ats in reads.items():
        size = getattr(g, name).element_size()
        nbytes_ += size * int(torch.unique(torch.cat(ats)).numel())
    t_bytes = 1e3 * nbytes_ / PEAK_BYTES
    t_ops = 1e3 * 2 * nbytes_ / PEAK_INT_ALU
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chain_kernel_times(g, B, chains, steps, use_glauber, dev):
    """One block of ``chains`` chains at the route's M for a run of
    ``steps`` moves, with its trail: the block kernel's device ms (a CUDA
    graph of 5 blocks, replayed) and its plain version's (CUDA events), on
    the same inputs, each a move (over M); the block's bound a move and the
    share."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels import motif_kernel as mk

    kind, emb, draws, tbl, parents = chain_block_inputs(
        g, B, chains, steps, use_glauber, dev)
    C, k = emb.shape
    M = draws[0].shape[0]
    trail = torch.empty((C, M, k), dtype=torch.int64, device=dev)
    bound_ms, by = chain_block_bound(g, kind, emb, draws, tbl, parents)
    ms = graph_ms(lambda: mk.chain_moves(kind, emb, draws, g, tbl, parents,
                                         trail), reps=5, replays=3) / M
    plain_ms = cuda_ms(lambda: mk.chain_moves_plain(
        kind, emb, draws, g, tbl, parents, trail), 2) / M
    return dict(move_kind=kind, block_moves=M, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms / M, bound_by=by, share=bound_ms / M / ms)


def chain_graph_bytes(g, B, chains, steps, use_glauber, dev):
    """Device bytes that the cached graphs of a run of these chains hold
    (its blocks of M and of the rest): their buffers (the embeddings, the
    block's draws and its trail) and their memory pools (the block's
    intermediates)."""
    from onmf_ontf_ndl_tpu_torch.samplers import motif

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    out = dict(chain_graph_emb_bytes=0, chain_graph_draw_bytes=0,
               chain_graph_trail_bytes=0, chain_graph_pool_bytes=0)
    segments = torch.cuda.memory_snapshot()
    for key in chain_keys(g, B, chains, steps, use_glauber, dev):
        entry = motif._CHAIN_GRAPHS[key]
        pool = tuple(entry.graph.pool())
        out["chain_graph_emb_bytes"] += nbytes(entry.buffers.emb)
        out["chain_graph_draw_bytes"] += nbytes(*entry.buffers.draws)
        out["chain_graph_trail_bytes"] += nbytes(entry.buffers.trail)
        out["chain_graph_pool_bytes"] += sum(
            seg["total_size"] for seg in segments
            if tuple(seg.get("segment_pool_id", ())) == pool)
    return out


def chain_cache_bytes():
    """The chain graphs cached at the end of phase 8 (at most
    the chain cache's ``size``), and the device bytes their buffers
    hold."""
    from onmf_ontf_ndl_tpu_torch.samplers import motif

    held = sum(t.numel() * t.element_size()
               for entry in motif._CHAIN_GRAPHS.values()
               for t in (entry.buffers.emb, entry.buffers.trail,
                         *entry.buffers.draws))
    return dict(chain_graphs=len(motif._CHAIN_GRAPHS),
                chain_cache_size=motif._CHAIN_GRAPHS.size,
                chain_graph_buffer_bytes=held)


# Phase 8's configurations: the graph (built in the script, as the
# benchmarks build theirs), the NetworkReconstructor's arguments and the
# reconstruction's.
NETWORK_RUNS = {
    # the reference main()'s (benchmarks/run_all.py::bench_facebook) on a
    # seeded Barabasi-Albert graph of facebook_combined's size
    "a": (lambda: ba_edges(4039, 22, seed=0), "dense",
          dict(n_components=25, MCMC_iterations=20, sub_iterations=20,
               sample_size=500, batch_size=20, k1=0, k2=20, alpha=0.1,
               is_glauber_dict=True, is_glauber_recons=False, fast=False,
               num_chains=8, seed=0),
          dict(recons_iter=100_000, num_chains=256)),
    # benchmarks/scale_extras.py::big_torus_ndl at m = 360, on a CsrGraph
    "b": (lambda: torus_edges(360), "csr",
          dict(n_components=25, MCMC_iterations=50, sub_iterations=30,
               sample_size=500, batch_size=100, k1=0, k2=2, num_chains=16,
               fast=True, seed=0),
          dict(recons_iter=4_800_000, num_chains=8192)),
}


def phase_network(ck, dev):
    """Network dictionary learning at NETWORK_RUNS' two configurations:
    (a) 21-node path motif (d = 441), r = 25, 20 MCMC iterations of 500
        Glauber samples over 8 chains, each followed by 19 optimizer steps
        on all 500 (``subsample=False``, the default, leaves batch_size
        unused), early stop;
        dense reconstruction from 100,000 pivot samples over 256 chains; the
        trained W must score above the initial W;
    (b) the 360 x 360 torus, 3-node path, r = 25, 50 MCMC iterations of 500
        samples over 16 chains and 29 optimizer steps, fixed sweeps; sparse
        reconstruction from 4.8M Glauber samples over 8192 chains; accuracy
        at least 0.90.
    Every chain block runs the chain kernel (``chain_move``, counted on
    the path). Each run's training and reconstruction chains must have
    been captured in the run (a cached graph of each of its blocks: M
    moves, and the rest). The sparse reconstruction runs once more in 4
    chunks, with the peak device memory of both. Then each chain, at its
    run's own number of moves, must equal its eager route and its plain
    route (``backend="torch"``, captured) bit for bit (``chains_equal``:
    trail, final embeddings, the generator's next draw), and its kernel
    must have run once a block; its steps per second on the kernel's
    captured and eager routes and the plain captured one, and per move
    over one whole run the graphs launched, the kernels launched and
    copies started from the host and the device operations run
    (``chain_trace``); the block kernel's and the plain block's ms a move,
    bound and share (``chain_kernel_times``); for (b) the bytes that the
    reconstruction's chain graphs hold (embeddings, draws, trail and
    memory pool). The same for (a)'s training chain on a BitsetGraph of
    (a)'s edges. Then both runs again with every move on the plain
    version: W and the accuracy equal the kernel's runs', and their
    seconds; the chain graphs then cached and their buffers' bytes.
    ``NetworkReconstructor`` at its own defaults (3 rounds on (a)'s graph)
    must take the captured round route and equal its eager rounds. Then
    (c) a short training run on the card (float32) and on
    the CPU (float64) from the same patches and draws. Returns the path's
    launches and the kernel's summary (at the (b) reconstruction's
    block)."""
    from onmf_ontf_ndl_tpu_torch.apps.network import (NetworkReconstructor,
                                                      ndl_train)
    from onmf_ontf_ndl_tpu_torch.data.graphs import (bitset_graph_from_edges,
                                                     csr_graph_from_edges,
                                                     graph_from_edgelist)
    from onmf_ontf_ndl_tpu_torch.models.state import init_state
    from onmf_ontf_ndl_tpu_torch.samplers import motif

    build = {"dense": graph_from_edgelist, "csr": csr_graph_from_edges}
    graphs = {tag: build[kind](edges(), device=dev)
              for tag, (edges, kind, _, _) in NETWORK_RUNS.items()}
    # the initial W's accuracy in (a), before the counted run: the same
    # seed gives the same initial W
    _, _, conf_a, recon_a = NETWORK_RUNS["a"]
    base = NetworkReconstructor(source=graphs["a"], device=dev, **conf_a)
    base.reconstruct_network(**recon_a)
    acc0 = base.compute_recons_accuracy()
    REFERENCE["network_a_accuracy_initial_w"] = acc0

    ck.reset_launches()
    # every chain of the runs below is captured in them: the cache then
    # holds a graph for each
    motif._CHAIN_GRAPHS.clear()
    runs, peak, held, round_keys = {}, {}, {}, {}
    for tag, (_, _, conf, recon) in NETWORK_RUNS.items():
        rec = NetworkReconstructor(source=graphs[tag], device=dev, **conf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        W, round_keys[tag] = rounds_taken(rec.train_dict, "network",
                                          conf["MCMC_iterations"])
        train_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        held[tag] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = rec.reconstruct_network(**recon)
        torch.cuda.synchronize()
        runs[tag] = (rec, W, out, train_s, time.perf_counter() - t0)
        peak[tag] = torch.cuda.max_memory_allocated()
    launches = check_launches(ck, "network")

    # each run's accuracy; the chains of training and of reconstruction of
    # each run, at the run's own moves: the training's blocks ran inside
    # the round graph its run captured, and each block graph of the
    # reconstruction was captured by the run above (cached), checked
    # before any other chain is captured
    chain_runs, captured_in_run, accs = {}, {}, {}
    for tag, (rec, _, _, _, _) in runs.items():
        accs[tag] = rec.compute_recons_accuracy()
        recon = NETWORK_RUNS[tag][3]
        chain_runs[tag] = {
            "train": (rec.num_chains, -(-rec.sample_size // rec.num_chains),
                      rec.is_glauber_dict),
            "recon": (recon["num_chains"],
                      -(-recon["recons_iter"] // recon["num_chains"]),
                      rec.is_glauber_recons)}
        captured_in_run[tag, "train"] = round_keys[tag] is not None
        chains, steps, glauber = chain_runs[tag]["recon"]
        captured_in_run[tag, "recon"] = all(
            key in motif._CHAIN_GRAPHS for key in chain_keys(
                rec.G, rec.B, chains, steps, glauber, dev))
    graph_bytes = chain_graph_bytes(runs["b"][0].G, runs["b"][0].B,
                                    *chain_runs["b"]["recon"], dev)

    # (b) once more in 4 chunks of 1.2M samples: fresh chains per chunk, the
    # per-pair (sum, count) merged; the same accuracy limit
    rec = runs["b"][0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunked_held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = rec.reconstruct_network(chunks=4, **NETWORK_RUNS["b"][3])
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    acc = rec.compute_recons_accuracy()
    emit("network", config="b", check="chunked_reconstruction", chunks=4,
         recon_seconds=chunked_s, accuracy=acc, limit=0.90,
         recon_edges=len(out), recon_peak_bytes=torch.cuda.
         max_memory_allocated(), held_bytes_before_recon=chunked_held,
         unchunked_recon_seconds=runs["b"][4],
         unchunked_recon_peak_bytes=peak["b"])
    if not (out.shape[1] == 2 and acc >= 0.90):
        raise AssertionError(f"chunked reconstruction: accuracy {acc}")

    chain_err, chain_summary = 0.0, None
    for tag, (rec, W, out, train_s, recon_s) in runs.items():
        acc = accs[tag]
        k, n = rec.k1 + rec.k2 + 1, rec.G.num_nodes
        ok = (tuple(W.shape) == (k * k, rec.n_components)
              and bool(torch.isfinite(W).all()) and bool((W >= 0).all())
              and rec.state.t == rec.MCMC_iterations * rec.sub_iterations)
        chain_fields = {}
        for part, (chains, steps, glauber) in chain_runs[tag].items():
            args = (rec.G, rec.B, chains)
            if tag == "b" and part == "recon":
                chain_fields.update(graph_bytes)
            chain_fields[f"{part}_chain_captured_in_run"] = \
                captured_in_run[tag, part]
            fields = chain_checks(*args, steps, glauber, dev)
            chain_fields.update({f"{part}_{key}": value
                                 for key, value in fields.items()})
            chain_err = max(chain_err, fields.pop("chain_max_abs_err"))
            if tag == "b" and part == "recon":
                chain_summary = dict(fields["chain_move"],
                                     max_abs_err=chain_err)
        fields = dict(config=tag, nodes=n, edges=rec.G.num_edges,
                      max_deg=int(rec.G.deg.max()), k=k,
                      train_seconds=train_s, recon_seconds=recon_s,
                      train_chain_steps=rec.MCMC_iterations
                      * chain_runs[tag]["train"][1],
                      recon_chain_steps=chain_runs[tag]["recon"][1],
                      **chain_fields, accuracy=acc)
        ok = ok and all(chain_fields[f"{part}_chain_captured_in_run"]
                        and chain_fields[f"{part}_chains_equal"]
                        and chain_fields[f"{part}_chain_one_launch_per_block"]
                        for part in chain_runs[tag])
        FINAL_STATES[f"network_{tag}"] = rec.state
        if tag == "a":
            REFERENCE["network_a_accuracy"] = acc
            fields.update(accuracy_initial_w=acc0,
                          recon_edges=int(out.sum()) // 2)
            ok = ok and tuple(out.shape) == (n, n) and acc > acc0
        else:
            fields.update(recon_edges=len(out), limit=0.90,
                          recon_peak_bytes=peak[tag],
                          held_bytes_before_recon=held[tag])
            ok = ok and out.shape[1] == 2 and acc >= 0.90
        emit("network", **fields)
        if not ok:
            raise AssertionError(f"network ({tag}): bad result {fields}")

    # each run's training rounds once more on the captured route and on
    # the eager rounds: the same W, A, B, C, chains and next draws
    for tag, (_, _, conf, _) in NETWORK_RUNS.items():
        def run(tag=tag, conf=conf):
            again = NetworkReconstructor(source=graphs[tag], device=dev,
                                         **conf)
            again.train_dict()
            return again.state, again.emb, torch.rand(
                8, generator=again.state.gen, device=dev)

        round_checks("network", round_keys[tag], conf["MCMC_iterations"],
                     run, config=tag, counted_train_seconds=runs[tag][3])

    # NetworkReconstructor at its own defaults (r = 100, 1000 samples of
    # one chain, 100 inner iterations: 99 steps and a chain block a
    # round), 3 rounds on (a)'s graph: captured too, equal to its eager
    # rounds
    def run_defaults():
        again = NetworkReconstructor(source=graphs["a"], device=dev,
                                     MCMC_iterations=3)
        again.train_dict()
        return again.state, again.emb, torch.rand(
            8, generator=again.state.gen, device=dev)

    t0 = time.perf_counter()
    _, key = rounds_taken(run_defaults, "network", 3)
    round_checks("network", key, 3, run_defaults, config="defaults",
                  counted_train_seconds=time.perf_counter() - t0)

    # the bitset representation: (a)'s training chain on a BitsetGraph of
    # (a)'s edges
    edges_a, _, conf_a, _ = NETWORK_RUNS["a"]
    fields = chain_checks(
        bitset_graph_from_edges(edges_a(), device=dev), runs["a"][0].B,
        conf_a["num_chains"], -(-conf_a["sample_size"] // conf_a["num_chains"]),
        True, dev)
    emit("network", config="a", check="bitset_chain", **fields)
    if not (fields["chains_equal"] and fields["chain_one_launch_per_block"]):
        raise AssertionError(f"bitset chain: {fields}")

    # both runs again with every chain move on the plain version: the
    # same chains, so the same W and accuracy
    with plain_chain_moves():
        for tag, (_, _, conf, recon) in NETWORK_RUNS.items():
            rec = NetworkReconstructor(source=graphs[tag], device=dev, **conf)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            W = rec.train_dict()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            rec.reconstruct_network(**recon)
            torch.cuda.synchronize()
            recon_s = time.perf_counter() - t0 - train_s
            acc = rec.compute_recons_accuracy()
            same = bool(torch.equal(W, runs[tag][1])) and acc == accs[tag]
            emit("network", config=tag, check="plain_chain_moves",
                 W_equal_bit_for_bit=bool(torch.equal(W, runs[tag][1])),
                 accuracy=acc, kernel_accuracy=accs[tag],
                 train_seconds=train_s, recon_seconds=recon_s,
                 kernel_train_seconds=runs[tag][3],
                 kernel_recon_seconds=runs[tag][4])
            if not same:
                raise AssertionError(f"network ({tag}): the plain moves' run "
                                     "differs from the kernel's")
    emit("network", check="chain_graph_cache", **chain_cache_bytes())

    # the same short training run on the card (float32) and on the CPU
    # (float64) from the same patches and draws, fixed sweeps, the 21-node
    # motif; limit 1e-3 relative
    rng = np.random.default_rng(8)
    d, r, S, inner = 441, 25, 500, 5
    W0 = rng.random((d, r))
    draws = [((rng.random((d, S)) < 0.2).astype(np.float64),
              [(rng.integers(0, S, 20), rng.random((r, 20)))
               for _ in range(inner - 1)]) for _ in range(3)]
    res = {}
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        dr = [(torch.as_tensor(X, dtype=dtype, device=device),
               [(torch.as_tensor(i, device=device),
                 torch.as_tensor(h, dtype=dtype, device=device))
                for i, h in steps]) for X, steps in draws]
        st = init_state(0, d, r, device=device, dtype=dtype, W=W0)
        st, _, _ = ndl_train(
            st, graphs["a"].to(device), torch.arange(21, device=device),
            runs["a"][0].B, mcmc_iterations=3, sample_size=S,
            inner_iterations=inner, batch_size=20, alpha=0.1,
            use_stopping=False, subsample=True, draws=dr)
        res[str(device)] = st.W
    rel = rel_err(res[str(dev)], res["cpu"])
    emit("network", check="cuda_f32_vs_cpu_f64", rel_err_W=rel, limit=1e-3)
    if not rel <= 1e-3:
        raise AssertionError(f"card run differs from the CPU run: {rel}")
    return launches, chain_summary


def cli_flags(conf: dict) -> list:
    """CLI flags of config fields: ``--field-name value``."""
    return [x for key, value in conf.items()
            for x in ("--" + key.replace("_", "-").lower(), str(value))]


def phase_surfaces(ck, dev):
    """The CLI in process on the card (``--device`` is the default,
    ``cuda``) at the configurations of phases 6, 8 (a) and 4; then
    ``check_state`` on every phase's final state."""
    from onmf_ontf_ndl_tpu_torch import cli
    from onmf_ontf_ndl_tpu_torch.samplers.ising import (checkerboard_sweeps,
                                                        init_lattice)
    from onmf_ontf_ndl_tpu_torch.models.state import make_generator
    from onmf_ontf_ndl_tpu_torch.utils.debug import check_state

    ck.reset_launches()
    with tempfile.TemporaryDirectory(
            dir=Path(__file__).resolve().parent) as tmp:
        tmp = Path(tmp)

        def run(cmd, flags):
            out = tmp / cmd
            t0 = time.perf_counter()
            if cli.main(["--out-dir", str(out), cmd] + flags) != 0:
                raise AssertionError(f"cli {cmd} failed")
            torch.cuda.synchronize()
            meta = json.loads((out / "run.json").read_text())
            return out, meta, dict(
                seconds_with_setup=time.perf_counter() - t0,
                wall_seconds=meta["wall_seconds"],
                dict_png=meta.get("dict_png", "written"),
                artifacts=sorted(p.name for p in out.iterdir()))

        # ising at phase 6's configuration: the state equals phase 6's
        (out, meta, info), key = rounds_taken(
            lambda: run("ising", cli_flags(ISING_RUN)), "ising",
            ISING_RUN["ising_iterations"])
        info["captured_rounds"] = key is not None
        saved = np.load(out / "state.npz")
        ref, _, errors, _ = REFERENCE["ising"]
        ref_arrays = {f: getattr(ref, f).cpu().numpy() for f in "WABC"}
        bitwise = all(np.array_equal(saved[f], ref_arrays[f]) for f in "WABC")
        diff = max(float(np.abs(saved[f] - ref_arrays[f]).max())
                   for f in "WABC")
        emit("surfaces", cmd="ising", **info,
             state_vs_phase_ising="bitwise" if bitwise else "atol 2e-5",
             max_abs_diff=diff, history=float(saved["t"]),
             final_surrogate_error=meta["final_surrogate_error"],
             phase_ising_final_error=float(errors[-1]))
        if not (bitwise or diff <= 2e-5) or float(saved["t"]) != ref.t \
                or key is None:
            raise AssertionError(f"cli ising differs from phase 6 ({diff}) "
                                 "or did not replay its rounds")

        # network at phase 8 (a)'s configuration, on an edge-list file of
        # the same graph (its nodes in the file's order)
        edges_fn, _, conf, recon = NETWORK_RUNS["a"]
        np.savetxt(tmp / "ba.txt", edges_fn(), fmt="%d", delimiter=",")
        (_, meta, info), key = rounds_taken(lambda: run("network", [
            "--source", str(tmp / "ba.txt"), *cli_flags(conf),
            "--recons-iter", str(recon["recons_iter"]),
            "--recons-chains", str(recon["num_chains"])]), "network",
            conf["MCMC_iterations"])
        info["captured_rounds"] = key is not None
        acc, acc0 = (meta["recons_accuracy"],
                     REFERENCE["network_a_accuracy_initial_w"])
        emit("surfaces", cmd="network", **info, accuracy=acc,
             phase_network_a_accuracy=REFERENCE["network_a_accuracy"],
             accuracy_initial_w=acc0)
        if not (acc > acc0 and key is not None):
            raise AssertionError(f"cli network accuracy {acc} <= {acc0} "
                                 "or its rounds not replayed")

        # image at the headline width: a PNG of phase 4's image where
        # Pillow is there, else a lattice saved as .npy (grey, d = 100)
        try:
            from PIL import Image
        except ImportError:
            Image = None
        flags = ["--n-components", "25", "--patch-size", "10",
                 "--iterations", "5", "--num-patches", "16384",
                 "--sub-iterations", "10", "--recons-resolution", "2",
                 "--seed", "4"]
        if Image is not None:
            Image.fromarray((synthetic_image(7) * 255).astype(np.uint8)).save(
                tmp / "image.png")
            flags += ["--path", str(tmp / "image.png")]
            source, d = "png", 300
        else:
            lat = checkerboard_sweeps(3, init_lattice(
                make_generator(14, dev), 1024), 16, T=2.5)
            np.save(tmp / "lattice.npy", lat.cpu().numpy())
            flags += ["--path", str(tmp / "lattice.npy"), "--is-matrix",
                      "true", "--is-color", "false"]
            source, d = "npy lattice (Pillow missing)", 100
        (out, meta, info), key = rounds_taken(lambda: run("image", flags),
                                              "image", 5)
        info["captured_rounds"] = key is not None
        saved, rec = np.load(out / "state.npz"), np.load(out / "recons.npy")
        emit("surfaces", cmd="image", **info, input=source, d=d,
             W_shape=list(saved["W"].shape), recons_shape=list(rec.shape))
        if saved["W"].shape != (d, 25) or not np.isfinite(rec).all() \
                or key is None:
            raise AssertionError("cli image: bad dictionary or recons, or "
                                 "its rounds not replayed")
    launches = check_launches(ck, "surfaces")
    for name, st in FINAL_STATES.items():
        check_state(st, name=name)
        emit("surfaces", check="check_state", state=name, ok=True)
    return launches


def banded_plain(seed, lat, nsweeps, bands, **kw):
    """The banded sweeps through the plain version of the banded entry:
    the halo rows are the neighbours' rows before each colour."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels.ising_kernel import (
        checkerboard_band_half_plain as half)

    rows = lat.shape[0] // bands
    parts = [lat[i * rows:(i + 1) * rows] for i in range(bands)]
    for sweep in range(nsweeps):
        for colour in (0, 1):
            halos = [(parts[i - 1][-1], parts[(i + 1) % bands][0])
                     for i in range(bands)]
            parts = [half(seed, p, a, b, i * rows, sweep, colour, **kw)
                     for i, (p, (a, b)) in enumerate(zip(parts, halos))]
    return torch.cat(parts)


def phase_parallel(ck, dev, gen):
    """One rank in an NCCL group: the data-parallel trainers and
    ``auto_train_dict`` on a one-rank {"dp": 1, "tp": 1} mesh equal the
    one-process ones (an all-reduce or all-gather over one rank is the
    identity), the sharded sampler runs its banded kernel; then the banded sampler in one
    process against the whole-lattice kernel and the plain version.
    Returns the path's launches and the banded entry's summary."""
    import socket

    import torch.distributed as dist

    import onmf_ontf_ndl_tpu_torch as lib
    from onmf_ontf_ndl_tpu_torch.apps.ising import IsingReconstructor
    from onmf_ontf_ndl_tpu_torch.models import onmf
    from onmf_ontf_ndl_tpu_torch.models.state import make_generator
    from onmf_ontf_ndl_tpu_torch.ops.kernels import ising_kernel as ik
    from onmf_ontf_ndl_tpu_torch.parallel import auto, dp, multihost
    from onmf_ontf_ndl_tpu_torch.parallel.ising_sharded import (
        banded_checkerboard_sweeps, sharded_checkerboard_sweeps)
    from onmf_ontf_ndl_tpu_torch.samplers.ising import init_lattice

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=1, process_id=0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        ck.reset_launches()
        X = headline_data(dev)
        # NCCL sets its communicator up at the first collective: one step
        # before the timed runs
        dp.dp_train_dict(lib.init_state(2, 300, 25, device=dev), X,
                         iterations=2, batch_size_per_device=16384)
        steps = 50
        # the two-axis trainer on a one-rank {"dp": 1, "tp": 1} mesh: its
        # step gathers over tp and sums over dp, each over one rank
        mesh = multihost.global_mesh({"dp": 1, "tp": 1})
        for stop in (None, 0.01):
            kw = dict(iterations=steps + 1, stopping_diff=stop)
            runs = {
                "dp": lambda: dp.dp_train_dict(
                    lib.init_state(2, 300, 25, device=dev), X,
                    batch_size_per_device=16384, **kw),
                "one": lambda: lib.train_dict(
                    lib.init_state(2, 300, 25, device=dev), X,
                    batch_size=16384, track_code=False, **kw)[0],
                "auto": lambda: auto.auto_train_dict(
                    lib.init_state(2, 300, 25, device=dev), X, mesh=mesh,
                    dp_axis="dp", tp_axis="tp", batch_size=16384, **kw),
                "one_code": lambda: lib.train_dict(
                    lib.init_state(2, 300, 25, device=dev), X,
                    batch_size=16384, **kw)}
            per_step = {}
            for name, fn in runs.items():
                fn()                    # captures this run's step
                best = math.inf
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runs[name] = fn()
                    torch.cuda.synchronize()
                    best = min(best, time.perf_counter() - t0)
                per_step[name] = 1e3 * best / steps
            got, want = runs["dp"], runs["one"]
            equal = got.t == want.t and all(
                torch.equal(getattr(got, f), getattr(want, f)) for f in "WAB")
            # the group's step is captured, its all-reduce in the graph
            captured = any(key[-1].group is not None and key[-1].tp is None
                           for key in onmf._GRAPHS)
            emit("parallel", check="dp_train_dict_vs_train_dict",
                 stopping_diff=stop, d=300, r=25, batch=16384, steps=steps,
                 bitwise_equal=equal, dp_captured=captured,
                 dp_step_ms=per_step["dp"],
                 train_dict_step_ms=per_step["one"])
            if not (equal and captured):
                raise AssertionError(f"dp_train_dict (stop {stop}) differs "
                                     "from train_dict or was not captured")
            (got, got_code), (want, want_code) = runs["auto"], \
                runs["one_code"]
            got = auto.unshard_state(got)
            state_equal = got.t == want.t and all(
                torch.equal(getattr(got, f), getattr(want, f))
                for f in "WABC")
            # index_add_ adds a step's duplicate columns in no fixed order
            # (as phase main's captured_vs_eager holds the code)
            code_bound = steps * 2.0 ** -23 * float(want_code.abs().max())
            code_err = float((got_code - want_code).abs().max())
            captured = any(key[-1].tp is not None
                           and key[-1].group is not None
                           for key in onmf._GRAPHS)
            emit("parallel", check="auto_train_dict_vs_train_dict",
                 mesh={"dp": 1, "tp": 1}, stopping_diff=stop, d=300, r=25,
                 batch=16384, steps=steps, state_bitwise_equal=state_equal,
                 code_bitwise_equal=bool(torch.equal(got_code, want_code)),
                 code_max_abs_err=code_err, code_bound=code_bound,
                 auto_captured=captured, auto_step_ms=per_step["auto"],
                 dp_step_ms=per_step["dp"],
                 train_dict_step_ms=per_step["one_code"])
            if not (state_equal and code_err <= code_bound and captured):
                raise AssertionError(
                    f"auto_train_dict (stop {stop}) differs from train_dict "
                    f"(state equal {state_equal}, code {code_err} > "
                    f"{code_bound}) or was not captured ({captured})")
        # dp_ising_learning from phase 6's construction: phase 6's learner
        rec = IsingReconstructor(**ISING_RUN, device=dev)
        t0 = time.perf_counter()
        (st, stack, errors, lat), key = rounds_taken(
            lambda: dp.dp_ising_learning(
                rec.state, rec.lattice[None], rec.gen,
                ising_iterations=rec.ising_iterations,
                nsteps=rec.ising_subsampling_steps,
                num_patches_per_device=rec.num_patches,
                inner_iterations=rec.sub_iterations,
                batch_size=rec.batch_size, patch_size=rec.patch_size,
                T=rec.temperature, beta=rec.beta),
            "ising", rec.ising_iterations)
        learn_s = time.perf_counter() - t0
        ref, ref_stack, ref_errors, ref_lat = REFERENCE["ising"]
        pairs = [(getattr(st, f), getattr(ref, f)) for f in "WABC"] + [
            (stack, ref_stack), (errors, ref_errors)]
        bitwise = torch.equal(lat, ref_lat) and all(
            torch.equal(a, b) for a, b in pairs)
        diff = max(float((a - b).abs().max()) for a, b in pairs)
        emit("parallel", check="dp_ising_learning_vs_phase_ising",
             learn_seconds=learn_s,
             phase_ising_learn_seconds=REFERENCE["ising_learn_seconds"],
             equal="bitwise" if bitwise else "atol 2e-5", max_abs_diff=diff,
             lattice_equal=bool(torch.equal(lat, ref_lat)),
             captured_rounds=key is not None)
        if not (bitwise or (diff <= 2e-5 and torch.equal(lat, ref_lat))) \
                or key is None:
            raise AssertionError(f"dp_ising_learning differs ({diff}) or "
                                 "did not replay its rounds")
        # the sharded sampler over the group: one band, the whole lattice
        lat0 = init_lattice(make_generator(13, dev), 200)
        band = sharded_checkerboard_sweeps(21, lat0, 100, T=2.5)
        mismatched = int((band != ik.checkerboard_sweeps(
            21, lat0, 100, T=2.5)).sum())
        emit("parallel", check="sharded_one_rank", n=200, sweeps=100,
             mismatched_sites=mismatched)
        if mismatched:
            raise AssertionError(f"sharded sampler: {mismatched} sites")
        launches = check_launches(ck, "parallel")
    finally:
        multihost.shutdown()

    summary = {}
    kw = dict(J=1.0, H=0.0, T=2.5)
    for n, bands in ((1024, 4), (200, 2)):
        lat = (1 - 2 * torch.randint(0, 2, (n, n), generator=gen)).to(
            torch.int8).to(dev)
        before = ik.LAUNCHES["checkerboard_sweeps_band"]
        got = banded_checkerboard_sweeps(n, lat, 100, bands, **kw)
        launched = ik.LAUNCHES["checkerboard_sweeps_band"] - before
        whole = ik.checkerboard_sweeps(n, lat, 100, **kw)
        want, plain_ms = timed_once(lambda: banded_plain(n, lat, 100, bands,
                                                         **kw))
        vs_whole, vs_plain = (int((got != whole).sum()),
                              int((got != want).sum()))
        err = float((got.float() - want.float()).abs().max())
        ms = graph_ms(lambda: banded_checkerboard_sweeps(n, lat, 100, bands,
                                                         **kw), reps=2)
        route = ik.checkerboard_route(n, 100)
        whole_ms = graph_ms(lambda: ik.checkerboard_sweeps(n, lat, 100, **kw),
                            reps=20 if route[1] else 5)
        bound_ms, by = checkerboard_bound(n, 100)
        emit("parallel", kernel="checkerboard_sweeps_band", n=n, bands=bands,
             sweeps=100, launches=launched, mismatched_vs_whole=vs_whole,
             mismatched_vs_plain=vs_plain,
             changed_sites=int((want != lat).sum()), max_abs_err=err, ms=ms,
             whole_lattice_ms=whole_ms, whole_lattice_route=list(route),
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
             share=bound_ms / ms)
        if vs_whole or vs_plain or launched != 2 * 100 * bands:
            raise AssertionError(f"banded sampler n={n}: {vs_whole} / "
                                 f"{vs_plain} sites differ, {launched} "
                                 "launches")
        if n == 1024:
            summary = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=by)
    return launches, summary


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    smi = phase_build(ck)
    summary = phase_kernels(ck, dev)
    launches = {"main": phase_main(ck, dev)}
    img = torch.as_tensor(synthetic_image(7), dtype=torch.float32,
                          device=dev)
    phase_image(dev, img)
    launches["tensor"] = phase_tensor(ck, dev, img)
    launches["ising"] = phase_ising(ck, dev)
    launches["stack"] = phase_stack(ck, dev)
    launches["video"] = phase_video(ck, dev)
    launches["network"], summary["chain_move"] = phase_network(ck, dev)
    launches["surfaces"] = phase_surfaces(ck, dev)
    launches["parallel"], summary["checkerboard_sweeps_band"] = (
        phase_parallel(ck, dev, torch.Generator().manual_seed(15)))
    emit("done", seconds=time.perf_counter() - t0)
    # library_ms: no single PyTorch call computes any of these functions
    # (each is a loop: Gauss-Seidel sweeps, FISTA or column BCD with a
    # per-tile stop, a Philox heat-bath sampler, whole or in bands, a
    # Glauber or pivot move of a chain; the grouping's plain version is
    # itself a sort, a run length, a segment sum and a scatter; the
    # overlap average's two folds, a copy and a division)
    kernels = [{"name": name, "route": "cuda", "source": CSRC + src,
                "replaces": replaces,
                "launches": launches[path][name],
                "max_abs_err": summary[name]["max_abs_err"],
                "ms": summary[name]["ms"],
                "plain_ms": summary[name]["plain_ms"],
                "bound_ms": summary[name]["bound_ms"],
                "bound_by": summary[name]["bound_by"],
                "library_ms": None}
               for name, (src, replaces, path) in KERNELS.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

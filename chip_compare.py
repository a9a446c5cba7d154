"""Device times of the port's coder, FISTA, dictionary and sampler kernels
at the paths' shapes, for comparing two versions of the package on one
card.

    python3 chip_compare.py [ROOT] [TAG] [KERNEL ...]

ROOT (default: this checkout) holds the ``onmf_ontf_ndl_tpu_torch``
package to time, e.g. another commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists; TAG labels its lines; KERNEL names
(``dict``, ``coder``, ``fista``, ``checker``) keep the run to those tables
(``checker`` is the checkerboard sampler at ``PATH_SHAPES``, by the
wrapper's own route and, where the package has the resident kernels, by
every other route that holds the lattice). The other tables come only
when named: ``routes`` times every route of the sampler on a grid of
(n, sweeps) around the crossovers of ``checkerboard_route``; ``iter`` is
FISTA's cost per iteration (from calls of 1 and 21 iterations, fixed and
with a stop of 0 that never converges) beside the call's fixed cost; ``bf16`` is no time but the error
of ten fixed bf16 FISTA iterations against the plain version, with the
columns past ``chip_smoke.py``'s ``BF16_TOL`` counted and the worst one
traced to the iteration and the rounding where it parted. ``ws`` times the
coders past their shared-memory ranks at ``chip_smoke.py``'s
``LARGE_RANK_SHAPES``: the early stop and the fixed sweeps where their
route there is the workspace (the wide Gauss-Seidel kernel; a package from
before it runs its one thread per column kernels), and FISTA in each mode
whose route is the workspace (the wide FISTA kernel) beside them; a CUDA
graph of 3 calls, replayed twice, the lesser mean kept. ``dp`` joins a
one-rank NCCL group and prints host ms a step of ``dp_train_dict`` beside
``train_dict`` at the headline shape (50 steps, fixed sweeps and the stop,
the least of 3 runs), and the Ising learner at ``chip_smoke.py``'s
``ISING_RUN`` with the group and without (the least of 3). ``step`` is
host ms a training step (``chip_smoke.py``'s ``step_ms``: 50 synchronised
steps, the least of 3 runs after a first one, which captures; that one's
ms too) on the headline data
(``headline_data``) for the three coders at batch 16384 and 128, on each
route the package has: eager, and captured where ``_train_loop`` takes
``capture=``. ``chain`` is chain steps per second (``chip_smoke.py``'s
``chain_rate``, the most of 3 runs, each after one of the same length) at
``NETWORK_RUNS``' chain shapes: each configuration's training round (its
chains and moves a round) and its reconstruction (its chains and every
move), eager and, where ``run_chains`` takes ``capture=``, captured;
where it takes ``backend=``, the moves are the chain kernel's on those two
routes, and ``captured_plain`` is the plain moves captured
(``backend="torch"``), the kernel's column beside them.
``cpu`` needs no card: host ms a step of ``train_dict`` on
the CPU (the eager route that CPU and gloo runs take), d = 300, r = 25 on
a pool of 16,384 columns, the three coders at batch 128 and 1024, 20
steps, the least of 3 runs after a first one; it runs alone.
The shapes, the modes, the inputs and the timer are ``chip_smoke.py``'s
(``PATH_SHAPES``, ``FISTA_MODES``, ``gram_inputs``, ``graph_ms``): each
kernel is timed as a CUDA graph of 20 calls (5 of the sampler's longer
ones), replayed three times; the least mean is kept. Inputs come from one seed, so two versions time the
same work. To compare versions, run them in turns in one call
(A, B, B, A). Prints one JSON line per shape. Needs one CUDA device.
"""

import json
import math
import time
import sys
from pathlib import Path

import torch

from chip_smoke import (BF16_TOL, FISTA_MODES, LARGE_RANK_SHAPES,
                        PATH_SHAPES, TOL, gram_inputs, graph_ms)

# one warp's worth of rows (d = 32) before the paths' (d, r)
DICT_SHAPES = [(32, 25)] + PATH_SHAPES["dict_update_sweep"]
ITER_SHAPES = [(25, 16384), (25, 131072 + 37), (100, 100)]
# every thread count of the tiled kernel (64 to 512), at a few tiles and at
# many with a ragged last one; r = 8, where one rounding moves a column the
# furthest, also at the headline n
BF16_SHAPES = [(r, n) for r in (1, 8, 25, 33, 100, 128)
               for n in (500, 4133)] + [(8, 131072 + 37)]


# the workspace table's FISTA modes: ten iterations (fixed, the 0.01 stop,
# the bf16 product) and one bf16 iteration, as chip_smoke.py's
# large_rank_kernels runs them
WS_MODES = {"fixed": dict(sub_iter=10, use_stopping=False),
            "stop": dict(sub_iter=10),
            "bf16": dict(sub_iter=10, use_stopping=False, bf16_matmul=True),
            "bf16_one_iteration": dict(sub_iter=1, use_stopping=False,
                                       bf16_matmul=True)}


def ws_times(ck, tag, dev, gen):
    """Device ms of the coders past their shared ranks at
    LARGE_RANK_SHAPES (see the module docstring)."""
    for r, n in LARGE_RANK_SHAPES:
        A, B, H0 = gram_inputs(r, n, gen, dev)
        line = {"version": tag, "table": "ws", "r": r, "n": n}
        for mode, kw in WS_MODES.items():
            name = "fista_sweeps_stop" if mode == "stop" else "fista_sweeps"
            if ck.kernel_route(name, r) == "workspace":
                line[f"fista_{mode}_ms"] = graph_ms(
                    lambda: ck.fista_sweeps(A, B, H0, 0.1, 0.01, **kw),
                    reps=3, replays=2)
        if ck.kernel_route("coder_sweeps_earlystop", r) == "workspace":
            line["coder_sweeps_earlystop_ms"] = graph_ms(
                lambda: ck.coder_sweeps_earlystop(A, B, H0, 0.1, 0.01),
                reps=3, replays=2)
        if ck.kernel_route("coder_sweeps", r) == "workspace":
            line["coder_sweeps_ms"] = graph_ms(
                lambda: ck.coder_sweeps(A, B, H0, 0.1), reps=3, replays=2)
        print(json.dumps(line), flush=True)


def bf16_errors(ck, tag, r, n, A, B, H0):
    """Ten fixed bf16 iterations, kernel against plain. Both round the same
    A and Y to bf16 and sum in f32, in another order: a Y within that
    rounding of a bf16 boundary rounds to the other side in one of them,
    and the column parts by inv_L |A[:, j]| times one bf16 step of Y from
    there on. The line counts the elements and columns past BF16_TOL,
    follows the worst column to the first iteration where it leaves the
    f32 tolerance, and rebuilds the Y that entered that iteration from both
    sides' outputs to show the entries that round apart. For scale: the
    plain version against itself with the rank's rows permuted."""
    kw = dict(use_stopping=False, bf16_matmul=True)
    args = (A, B, H0, 0.1, 0.01)
    got = [H0] + [ck.fista_sweeps(*args, sub_iter=k, **kw)
                  for k in range(1, 11)]
    want = [H0] + [ck.fista_sweeps_plain(*args, sub_iter=k, **kw)
                   for k in range(1, 11)]
    diff = (got[10] - want[10]).abs()
    over = diff > BF16_TOL["atol"]
    inv_L = ck._inv_lipschitz(A)
    line = {"version": tag, "kernel": "fista_sweeps", "table": "bf16",
            "r": r, "n": n, "max_abs_err": float(diff.max()),
            "atol": BF16_TOL["atol"], "elements_over": int(over.sum()),
            "columns_over": int(over.any(0).sum()),
            "one_iteration_max_abs_err": float(
                (got[1] - want[1]).abs().max()),
            "one_iteration_within_f32_tol": bool(
                torch.allclose(got[1], want[1], **TOL))}
    # the plain version on the rank's rows in another order: the same
    # function, its float32 sums in another order
    perm = torch.randperm(r, generator=torch.Generator().manual_seed(r)).to(
        A.device)
    again = ck.fista_sweeps_plain(
        A[perm][:, perm].contiguous(), B[perm].contiguous(),
        H0[perm].contiguous(), 0.1, 0.01, sub_iter=10, **kw)
    resum = (again - want[10][perm]).abs()
    line["plain_reordered_max_abs_err"] = float(resum.max())
    line["plain_reordered_columns_over"] = int(
        (resum > BF16_TOL["atol"]).any(0).sum())
    # the worst column, iteration by iteration
    c = int(diff.max(0).values.argmax())
    errs = [float((g[:, c] - w[:, c]).abs().max())
            for g, w in zip(got, want)]
    line["worst_column_err_by_iteration"] = errs[1:]
    parted = next((k for k in range(1, 11) if not torch.allclose(
        got[k][:, c], want[k][:, c], **TOL)), None)
    line["worst_column_parts_at_iteration"] = parted
    if parted is not None and parted >= 2:
        # Y after iteration m is H_m + mom_m (H_m - H_{m-1})
        tt = 1.0
        for _ in range(parted - 1):
            tn = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * tt * tt))
            mom, tt = (tt - 1.0) / tn, tn
        Yk, Yp = (h[parted - 1][:, c] + mom * (
            h[parted - 1][:, c] - h[parted - 2][:, c]) for h in (got, want))
        apart = Yk.bfloat16() != Yp.bfloat16()
        step = (Yk.bfloat16().float() - Yp.bfloat16().float()).abs()
        line["entries_rounding_apart"] = int(apart.sum())
        line["their_f32_difference"] = float((Yk - Yp).abs()[apart].max()) \
            if bool(apart.any()) else None
        line["their_bf16_difference"] = float(step.max())
        line["one_step_moves_h_by"] = float(
            inv_L * (A.abs() @ step).max())
    print(json.dumps(line), flush=True)


# lattices from one warp's worth of sites to past the cluster's reach, and
# calls from one sweep to many: where the routes of the sampler cross
ROUTE_SHAPES = [(n, sweeps) for n in (16, 32, 64, 96, 128, 160, 200, 224,
                                      256, 384, 512)
                for sweeps in (1, 4, 16, 64)]


def checkerboard_times(tag, dev, gen, timed, shapes=None):
    """The sampler at PATH_SHAPES (T = 2.5, a seeded random lattice): the
    wrapper's own call, and for a package with ``checkerboard_route`` the
    kernels of every route that can hold the lattice, run in place (a call
    of the wrapper also clones the lattice)."""
    import ctypes

    from onmf_ontf_ndl_tpu_torch.ops.kernels import ising_kernel as ik

    for n, sweeps in shapes or PATH_SHAPES["checkerboard_sweeps"]:
        lat = (1 - 2 * torch.randint(0, 2, (n, n), generator=gen)).to(
            torch.int8).to(dev)
        reps = 20 if n * n * sweeps <= 200 * 200 * 100 else 5
        line = {"version": tag, "kernel": "checkerboard_sweeps", "n": n,
                "sweeps": sweeps, "ms": graph_ms(
                    lambda: ik.checkerboard_sweeps(n, lat, sweeps, T=2.5),
                    reps=reps, replays=3)}
        if hasattr(ik, "checkerboard_route"):
            line["route"] = list(ik.checkerboard_route(n, sweeps))
            thr = (ctypes.c_uint * 10)(*ik.acceptance_thresholds(
                1.0, 0.0, 2.5))
            work = lat.clone()
            for ctas in (0, 1, 2, 4, 8):
                if ctas == 0 or (ik._resident_fits(n, ctas)
                                 and n * n * sweeps / ctas <= 1 << 25):
                    line[f"ctas_{ctas}_ms"] = graph_ms(
                        lambda: ik._launch(work, n, sweeps, n, thr, ctas),
                        reps=reps, replays=3)
        print(json.dumps(line), flush=True)


def dp_times(tag, dev):
    """The data-parallel path on one NCCL rank against the one-process
    path: host time around synchronised runs (the group's collectives cost
    the host, not the card)."""
    import socket
    import time

    import onmf_ontf_ndl_tpu_torch as lib
    from chip_smoke import ISING_RUN, headline_data
    from onmf_ontf_ndl_tpu_torch.apps.ising import IsingReconstructor
    from onmf_ontf_ndl_tpu_torch.parallel import dp, multihost

    def seconds(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=1, process_id=0)
    try:
        X = headline_data(dev)
        steps = 50

        def state():
            return lib.init_state(2, 300, 25, device=dev)

        dp.dp_train_dict(state(), X, iterations=2,
                         batch_size_per_device=16384)   # NCCL's set-up
        for stop in (None, 0.01):
            kw = dict(iterations=steps + 1, stopping_diff=stop)
            runs = {"dp_step_ms": lambda: dp.dp_train_dict(
                        state(), X, batch_size_per_device=16384, **kw),
                    "train_dict_step_ms": lambda: lib.train_dict(
                        state(), X, batch_size=16384, track_code=False,
                        **kw)}
            line = {"version": tag, "table": "dp", "stopping_diff": stop,
                    "steps": steps}
            for name, fn in runs.items():
                line[name] = 1e3 * min(seconds(fn) for _ in range(3)) / steps
            print(json.dumps(line), flush=True)

        def ising(group):
            rec = IsingReconstructor(**ISING_RUN, device=dev)
            if not group:
                return rec.ising_mcmc_learning()
            return dp.dp_ising_learning(
                rec.state, rec.lattice[None], rec.gen,
                ising_iterations=rec.ising_iterations,
                nsteps=rec.ising_subsampling_steps,
                num_patches_per_device=rec.num_patches,
                inner_iterations=rec.sub_iterations,
                batch_size=rec.batch_size, patch_size=rec.patch_size,
                T=rec.temperature, beta=rec.beta)

        print(json.dumps({"version": tag, "table": "dp", "run": "ising",
                          "group_seconds": min(seconds(lambda: ising(True))
                                               for _ in range(3)),
                          "seconds": min(seconds(lambda: ising(False))
                                         for _ in range(3))}), flush=True)
    finally:
        multihost.shutdown()


def step_times(tag, dev):
    """Host ms a training step on every route of the package (see the
    module docstring)."""
    import inspect

    from chip_smoke import CODERS, headline_data, step_ms
    from onmf_ontf_ndl_tpu_torch.models import onmf

    X = headline_data(dev)
    routes = {"eager": {}}
    if "capture" in inspect.signature(onmf._train_loop).parameters:
        routes = {"eager": dict(capture=False),
                  "captured": dict(capture=True)}
    for batch in (16384, 128):
        for coder, stop in CODERS:
            for route, kw in routes.items():
                print(json.dumps({
                    "version": tag, "table": "step", "route": route,
                    "coder": coder, "stopping_diff": stop, "batch": batch,
                    "steps": 50, **step_ms(X, batch, 50, coder, stop,
                                           **kw)}), flush=True)


def chain_times(tag, dev):
    """Chain steps per second at the network runs' chain shapes, on every
    route of the package (see the module docstring)."""
    import inspect

    from chip_smoke import NETWORK_RUNS, chain_rate
    from onmf_ontf_ndl_tpu_torch.data import graphs
    from onmf_ontf_ndl_tpu_torch.samplers import motif

    routes = {"eager": {}}
    params = inspect.signature(motif.run_chains).parameters
    if "capture" in params:
        routes = {"eager": dict(capture=False),
                  "captured": dict(capture=True)}
    if "backend" in params:     # the kernel's routes, and the plain moves
        routes["captured_plain"] = dict(backend="torch")
    build = {"dense": graphs.graph_from_edgelist,
             "csr": graphs.csr_graph_from_edges}
    for tag_run, (edges, kind, conf, recon) in NETWORK_RUNS.items():
        g = build[kind](edges(), device=dev)
        B = motif.path_adj(conf["k1"], conf["k2"])
        parts = {"train": (conf["num_chains"], -(-conf["sample_size"]
                                                 // conf["num_chains"]),
                           conf.get("is_glauber_dict", True)),
                 "recon": (recon["num_chains"], -(-recon["recons_iter"]
                                                  // recon["num_chains"]),
                           conf.get("is_glauber_recons", True))}
        for part, (chains, steps, glauber) in parts.items():
            for route, kw in routes.items():
                rates = [chain_rate(g, B, chains, steps, glauber, dev, **kw)
                         for _ in range(3)]
                print(json.dumps({
                    "version": tag, "table": "chain", "config": tag_run,
                    "part": part, "route": route, "chains": chains,
                    "steps": steps, "glauber": glauber,
                    "steps_per_s": max(rates),
                    "seconds": steps / max(rates)}), flush=True)


def cpu_step_times(tag):
    """Host ms a training step on the CPU (see the module docstring)."""
    import onmf_ontf_ndl_tpu_torch as lib
    from chip_smoke import CODERS, headline_data

    torch.manual_seed(0)
    X = headline_data("cpu", n=16384)
    steps = 20
    for batch in (128, 1024):
        for coder, stop in CODERS:
            runs = []
            for _ in range(4):
                st = lib.init_state(3, 300, 25, device="cpu")
                t0 = time.perf_counter()
                lib.train_dict(st, X, iterations=steps + 1, batch_size=batch,
                               stopping_diff=stop, coder=coder)
                runs.append(1e3 * (time.perf_counter() - t0))
            print(json.dumps({
                "version": tag, "table": "cpu_step", "coder": coder,
                "stopping_diff": stop, "batch": batch, "steps": steps,
                "threads": torch.get_num_threads(),
                "step_ms": min(runs[1:]) / steps}), flush=True)


def main():
    root = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
    tag = sys.argv[2] if len(sys.argv) > 2 else root.name
    only = sys.argv[3:] or ["dict", "coder", "fista", "checker"]
    sys.path.insert(0, str(root))
    from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck

    if not Path(ck.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ck.__file__}, not from {root}")
    if only == ["cpu"]:
        cpu_step_times(tag)
        return
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        sys.exit(1)
    ck.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def timed(fn):
        return graph_ms(fn, replays=3)

    for d, r in DICT_SHAPES if "dict" in only else []:
        W = torch.rand((d, r), generator=gen).to(dev)
        A = torch.rand((r, r), generator=gen).to(dev)
        B = torch.rand((r, d), generator=gen).to(dev)
        print(json.dumps({"version": tag, "kernel": "dict_update_sweep",
                          "d": d, "r": r, "ms": timed(
                              lambda: ck.dict_update_sweep(W, A, B))}),
              flush=True)
    for r, n in PATH_SHAPES["coder_sweeps"] if "coder" in only else []:
        A, B, H0 = gram_inputs(r, n, gen, dev)
        line = {"version": tag, "r": r, "n": n}
        line["coder_sweeps_earlystop"] = timed(
            lambda: ck.coder_sweeps_earlystop(A, B, H0, 0.1, 0.01))
        line["coder_sweeps"] = timed(lambda: ck.coder_sweeps(A, B, H0, 0.1))
        print(json.dumps(line), flush=True)
    for r, n, mode in PATH_SHAPES["fista_sweeps"] if "fista" in only else []:
        A, B, H0 = gram_inputs(r, n, gen, dev)
        print(json.dumps({
            "version": tag, "kernel": "fista_sweeps", "mode": mode, "r": r,
            "n": n, "ms": timed(lambda: ck.fista_sweeps(
                A, B, H0, 0.1, 0.01, **FISTA_MODES[mode]))}), flush=True)
    if "checker" in only:
        checkerboard_times(tag, dev, gen, timed)
    if "routes" in only:
        checkerboard_times(tag, dev, gen, timed, ROUTE_SHAPES)
    for r, n in ITER_SHAPES if "iter" in only else []:
        A, B, H0 = gram_inputs(r, n, gen, dev)
        line = {"version": tag, "kernel": "fista_sweeps", "per": "iteration",
                "r": r, "n": n}
        for mode, stop in (("fixed", False), ("stop", True)):
            one, many = (timed(lambda: ck.fista_sweeps(
                A, B, H0, 0.1, 0.0, sub_iter=it, use_stopping=stop))
                for it in (1, 21))
            line[mode + "_one_iteration_ms"] = one
            line[mode + "_us_per_iteration"] = 1e3 * (many - one) / 20
        print(json.dumps(line), flush=True)
    for r, n in BF16_SHAPES if "bf16" in only else []:
        bf16_errors(ck, tag, r, n, *gram_inputs(r, n, gen, dev))
    if "ws" in only:
        ws_times(ck, tag, dev, gen)
    if "dp" in only:
        dp_times(tag, dev)
    if "step" in only:
        step_times(tag, dev)
    if "chain" in only:
        chain_times(tag, dev)


if __name__ == "__main__":
    main()

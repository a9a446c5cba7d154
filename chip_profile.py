"""Where the device time goes in the port's drivers.

    python3 chip_profile.py [ROOT] [RUN ...]

Runs each driver at the configuration of its ``chip_smoke.py`` phase
(tensor, ising, stack, video, network (a) and (b), training and
reconstruction) and the headline training step (``step``: 50 steps of each
coder at batch 16384 and 128 on ``headline_data``), once to build, warm up
and capture, three times timed on the host clock (synchronised; the least
is ``wall_s``, all three ``walls_s``), and once under ``torch.profiler``.
ROOT (a directory; default: this checkout) holds the
``onmf_ontf_ndl_tpu_torch`` package to profile, e.g. another commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists,
as for ``chip_compare.py``; its name tags the lines. RUN names
(``tensor``, ``ising``, ``stack``, ``video``, ``network``, ``step``) keep
the run to those; ``capture`` (never run unnamed) measures what a round
graph costs against the inner steps it holds (``capture_runs``). Prints one JSON
line per run: wall seconds, device kernel seconds, the busy share (device
kernel time over the profiled wall time), the device kernels launched
(those of replayed CUDA graphs included) and the kernels with the most
device time (name, calls, milliseconds), and the card's name and power
limit. Each line also counts the host's launches: the CUDA graphs
(``host_graph_launches``: one a round where an app's rounds replay a
round graph, one a step or chain block on the per-round route) and the
kernels launched one at a time (``host_kernel_launches``). Needs one CUDA
device.
"""

import json
import os
import sys
import time
from pathlib import Path

import torch


def profiled(fn):
    """(wall seconds of each of three timed calls, wall seconds under the
    profiler, {kernel: (calls, device ms)}, {"graph": CUDA graphs launched,
    "kernel": kernels launched from the host}) of ``fn``, after one
    warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    kernels, host = {}, {"graph": 0, "kernel": 0}
    for ev in prof.key_averages():
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if ms > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = (ev.count, ms)
        elif ev.key == "cudaGraphLaunch":
            host["graph"] += ev.count
        elif ev.key.startswith("cudaLaunchKernel"):
            host["kernel"] += ev.count
    return walls, wall_prof, kernels, host


VERSION = {"tag": "."}


def report(run, walls, wall_prof, kernels, host):
    busy = sum(ms for _, ms in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    print(json.dumps({
        "version": VERSION["tag"], "run": run, "wall_s": min(walls),
        "walls_s": walls, "profiled_wall_s": wall_prof,
        "device_kernel_s": busy, "busy_share": busy / wall_prof,
        "launches": sum(c for c, _ in kernels.values()),
        "host_graph_launches": host["graph"],
        "host_kernel_launches": host["kernel"],
        "top": [{"kernel": k[:80], "calls": c, "ms": ms}
                for k, (c, ms) in top]}), flush=True)


def tensor_runs(dev):
    from chip_smoke import synthetic_image
    from onmf_ontf_ndl_tpu_torch.apps.image_tensor import (
        ImageReconstructorTensor)

    img = torch.as_tensor(synthetic_image(7), dtype=torch.float32,
                          device=dev)
    tensor_kw = dict(data=img, n_components=100, iterations=20,
                     sub_iterations=2, batch_size=100, block_iterations=4,
                     num_patches=100, patch_size=20, device=dev, seed=3)
    rec = ImageReconstructorTensor(**tensor_kw)

    def tensor_train():
        ImageReconstructorTensor(**tensor_kw).train_dict(
            mode=2, learn_joint_dict=True)

    rec.train_dict(mode=2, learn_joint_dict=True)
    report("tensor training (20 steps)", *profiled(tensor_train))
    report("tensor colour recon (252,004 patches)", *profiled(
        lambda: rec.reconstruct_image_color(data=img, recons_resolution=2)))


def ising_runs(dev):
    from chip_smoke import ISING_RUN
    from onmf_ontf_ndl_tpu_torch.apps.ising import IsingReconstructor

    report("Ising learning (21 x 19 steps)", *profiled(
        lambda: IsingReconstructor(**ISING_RUN,
                                   device=dev).ising_mcmc_learning()))


def stack_runs(dev):
    from onmf_ontf_ndl_tpu_torch.apps.image import ImageReconstructor
    from onmf_ontf_ndl_tpu_torch.models.state import make_generator
    from onmf_ontf_ndl_tpu_torch.samplers.ising import (checkerboard_sweeps,
                                                        init_lattice)

    lat = init_lattice(make_generator(9, dev), 200)
    lats = []
    for i in range(8):
        lat = checkerboard_sweeps(100 + i, lat, 16, T=2.5)
        lats.append(lat)
    stack = (torch.stack(lats).float() + 1.0) / 2.0
    kw = dict(data=stack, is_stack=True, n_components=25, iterations=16,
              sub_iterations=10, num_patches=1000, patch_size=10,
              downscale_factor=1, device=dev, seed=2)
    report("stack training (2 x 8 x 9 steps)", *profiled(
        lambda: ImageReconstructor(**kw).train_dict()))


def video_runs(dev):
    from chip_smoke import synthetic_frames
    from onmf_ontf_ndl_tpu_torch import VideoDictionaryLearner

    frames = synthetic_frames(dev)
    report("video training (16 x 9 steps)", *profiled(
        lambda: VideoDictionaryLearner(frames=frames, device=dev,
                                       seed=8).train_dict(epochs=1)))
    rec = VideoDictionaryLearner(frames=frames, device=dev, seed=8)
    rec.train_dict(epochs=1)
    report("video frame recon (62,001 patches)", *profiled(
        lambda: rec.reconstruct_frame(8)))


def network_runs(dev):
    from chip_smoke import NETWORK_RUNS
    from onmf_ontf_ndl_tpu_torch.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu_torch.data.graphs import (csr_graph_from_edges,
                                                     graph_from_edgelist)

    build = {"dense": graph_from_edgelist, "csr": csr_graph_from_edges}
    for tag, (edges, kind, conf, recon) in NETWORK_RUNS.items():
        g = build[kind](edges(), device=dev)
        report(f"network ({tag}) training", *profiled(
            lambda: NetworkReconstructor(source=g, device=dev,
                                         **conf).train_dict()))
        rec = NetworkReconstructor(source=g, device=dev, **conf)
        rec.train_dict()
        report(f"network ({tag}) recon", *profiled(
            lambda: rec.reconstruct_network(**recon)))


def step_runs(dev):
    from chip_smoke import CODERS, headline_data, train_loop
    from onmf_ontf_ndl_tpu_torch.models.state import init_state

    X = headline_data(dev)
    st = init_state(3, 300, 25, device=dev)
    for batch in (16384, 128):
        for coder, stop in CODERS:
            report(f"step ({coder}, stop {stop}, batch {batch}, 50 steps)",
                   *profiled(lambda: train_loop(st, X, batch, 50, coder,
                                                stop)))


# The inner iterations of capture_runs' rounds: the smoke's network (b)
# (30), NetworkReconstructor's default (100) and past it.
CAPTURE_ITERATIONS = (30, 100, 200, 400, 800, 1600)


def capture_runs(dev):
    """What a round graph costs against the steps it holds:
    ``NetworkReconstructor`` at its defaults (n_components 100, 1000
    samples of one chain, batch 10), 8 rounds on NETWORK_RUNS (a)'s graph,
    at each of ``CAPTURE_ITERATIONS`` inner iterations, with the bound on a
    round's steps lifted. One line each: the steps and chain blocks a round
    holds; in the run that captures, the round cache's ``capture_step``
    (its eager first round, the recording and the instantiation) and the
    instantiation alone (``capture_end``) on the host clock, the device
    memory reserved and the host memory resident that the run added; the
    wall of a run that replays and of one on the per-round route (its
    steps a step graph replayed; least of three each, after one that
    captures); the device operations of a replay under
    ``torch.profiler``."""
    from chip_smoke import NETWORK_RUNS
    from onmf_ontf_ndl_tpu_torch.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu_torch.data.graphs import graph_from_edgelist
    from onmf_ontf_ndl_tpu_torch.models import onmf
    from onmf_ontf_ndl_tpu_torch.utils import capture as graphs
    from torch.profiler import ProfilerActivity, profile

    g = graph_from_edgelist(NETWORK_RUNS["a"][0](), device=dev)
    rounds, timed = 8, {"capture_s": 0.0, "instantiate_s": 0.0}

    def train(sub):
        NetworkReconstructor(source=g, device=dev, MCMC_iterations=rounds,
                             sub_iterations=sub).train_dict()
        torch.cuda.synchronize()

    def least(fn):
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return min(walls)

    class Graph(torch.cuda.CUDAGraph):      # times its instantiation
        def capture_end(self):
            t0 = time.perf_counter()
            super().capture_end()
            timed["instantiate_s"] += time.perf_counter() - t0

    def capture_step(*args, cache="step"):
        t0 = time.perf_counter()
        out = capture(*args, cache=cache)
        torch.cuda.synchronize()
        if cache == "round":
            timed["capture_s"] += time.perf_counter() - t0
        return out

    def resident():
        return int(Path("/proc/self/statm").read_text().split()[1]) \
            * os.sysconf("SC_PAGE_SIZE")

    capture, route, bound = graphs.capture_step, onmf._round_route, \
        onmf._MAX_ROUND_STEPS
    graph_class, steps = torch.cuda.CUDAGraph, []
    onmf._MAX_ROUND_STEPS = 1 << 30

    def spy(*args, **kw):
        steps.append(args[6])
        return route(*args, **kw)

    onmf._round_route, graphs.capture_step = spy, capture_step
    torch.cuda.CUDAGraph = Graph
    try:
        for sub in CAPTURE_ITERATIONS:
            onmf._clear_graphs()
            torch.cuda.empty_cache()
            timed.update(capture_s=0.0, instantiate_s=0.0)
            steps.clear()
            reserved, rss = torch.cuda.memory_reserved(dev), resident()
            t0 = time.perf_counter()
            train(sub)
            first = time.perf_counter() - t0
            out = dict(timed, round_steps_and_blocks=steps[0],
                       first_run_s=first,
                       reserved_bytes=torch.cuda.memory_reserved(dev)
                       - reserved, resident_bytes=resident() - rss)
            out["captured_route"] = len(onmf._ROUND_GRAPHS) == 1
            out["replay_run_s"] = least(lambda: train(sub))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                train(sub)
            out["device_operations_per_round"] = sum(
                ev.count for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA) / rounds
            onmf._round_route = lambda *a, **k: "per_round"
            try:
                train(sub)
                out["per_round_run_s"] = least(lambda: train(sub))
            finally:
                onmf._round_route = spy
            print(json.dumps({"version": VERSION["tag"],
                              "run": f"network round graph at "
                              f"sub_iterations={sub}, {rounds} rounds",
                              **out}), flush=True)
    finally:
        onmf._round_route, graphs.capture_step = route, capture
        onmf._MAX_ROUND_STEPS = bound
        torch.cuda.CUDAGraph = graph_class
        onmf._clear_graphs()


RUNS = {"tensor": tensor_runs, "ising": ising_runs, "stack": stack_runs,
        "video": video_runs, "network": network_runs, "step": step_runs,
        "capture": capture_runs}
# the runs made without RUN names
DEFAULT_RUNS = ("tensor", "ising", "stack", "video", "network", "step")


def main():
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import subprocess

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    args = sys.argv[1:]
    if args and Path(args[0]).is_dir():
        root = Path(args.pop(0)).resolve()
        VERSION["tag"] = root.name
        sys.path.insert(0, str(root))
        import onmf_ontf_ndl_tpu_torch

        if not Path(onmf_ontf_ndl_tpu_torch.__file__).resolve(
                ).is_relative_to(root):
            raise RuntimeError(f"imported {onmf_ontf_ndl_tpu_torch.__file__}"
                               f", not from {root}")
    for name in args or DEFAULT_RUNS:
        RUNS[name](dev)


if __name__ == "__main__":
    main()

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
the run to those. Prints one JSON
line per run: wall seconds, device kernel seconds, the busy share (device
kernel time over the profiled wall time), the device kernels launched
(those of replayed CUDA graphs included) and the kernels with the most
device time (name, calls, milliseconds), and the card's name and power
limit. Needs one CUDA device.
"""

import json
import sys
import time
from pathlib import Path

import torch


def profiled(fn):
    """(wall seconds of each of three timed calls, wall seconds under the
    profiler, {kernel: (calls, device ms)}) of ``fn``, after one warm-up
    call."""
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
    kernels = {}
    for ev in prof.key_averages():
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if ms > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = (ev.count, ms)
    return walls, wall_prof, kernels


VERSION = {"tag": "."}


def report(run, walls, wall_prof, kernels):
    busy = sum(ms for _, ms in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    print(json.dumps({
        "version": VERSION["tag"], "run": run, "wall_s": min(walls),
        "walls_s": walls, "profiled_wall_s": wall_prof,
        "device_kernel_s": busy, "busy_share": busy / wall_prof,
        "launches": sum(c for c, _ in kernels.values()),
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


RUNS = {"tensor": tensor_runs, "ising": ising_runs, "stack": stack_runs,
        "video": video_runs, "network": network_runs, "step": step_runs}


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
    for name in args or RUNS:
        RUNS[name](dev)


if __name__ == "__main__":
    main()

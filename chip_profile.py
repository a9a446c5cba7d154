"""Where the device time goes in the port's tensor and Ising drivers.

    python3 chip_profile.py

Runs each driver at the configuration of ``chip_smoke.py``'s phases 5 and
6 (``benchmarks/run_all.py``'s), once to build and warm up, once timed on
the host clock (synchronised), and once under ``torch.profiler``. Prints
one JSON line per run: wall seconds, device kernel seconds, the busy share
(device kernel time over the profiled wall time) and the kernels with the
most device time (name, calls, milliseconds). Needs one CUDA device.
"""

import json
import sys
import time

import torch


def profiled(fn):
    """(wall seconds, wall seconds under the profiler, {kernel: (calls,
    device ms)}) of ``fn``, after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
    return wall, wall_prof, kernels


def report(run, wall, wall_prof, kernels):
    busy = sum(ms for _, ms in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    print(json.dumps({
        "run": run, "wall_s": wall, "profiled_wall_s": wall_prof,
        "device_kernel_s": busy, "busy_share": busy / wall_prof,
        "top": [{"kernel": k[:80], "calls": c, "ms": ms}
                for k, (c, ms) in top]}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import synthetic_image
    from onmf_ontf_ndl_tpu_torch.apps.image_tensor import (
        ImageReconstructorTensor)
    from onmf_ontf_ndl_tpu_torch.apps.ising import IsingReconstructor

    dev = torch.device("cuda", 0)
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

    def ising():
        IsingReconstructor(
            n_components=100, lattice_size=200, ising_iterations=20,
            temperature=5.0, ising_subsampling_steps=40000,
            sub_iterations=20, batch_size=50, num_patches=1000,
            patch_size=20, beta=1.0, device=dev,
            seed=5).ising_mcmc_learning()

    report("Ising learning (21 x 19 steps)", *profiled(ising))


if __name__ == "__main__":
    main()

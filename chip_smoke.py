"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its findings on a line of its own:

1. build   - nvcc builds the three sweep kernels from ``csrc/`` (sm_90a);
             the card's name and power limit.
2. kernels - each kernel against its plain PyTorch version on the card at
             the slice's shapes (r in {25, 100}; n in {TN, 131072 + 37};
             d = 300), rtol 2e-4 / atol 2e-5, with CUDA-event times of both.
3. main    - ``OnlineNMF(...).train_dict()`` on synthetic sparse-dictionary
             data (trained W within 10% of the ground-truth W's score),
             then ``init_state`` + ``train_dict`` at d = 300, r = 25,
             batch 16384 (patches/s, fixed sweeps and early stop). Every
             kernel must have launched in this phase. Then a short run
             against the same run on the CPU in float64 with the same draws.
4. image   - ``ImageReconstructor`` on a 1024x1024x3 synthetic image, colour
             reconstruction, and a checkpoint written and resumed.

The last two lines are the kernels' JSON summary and the result line.
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

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
SOURCE = "onmf_ontf_ndl_tpu_torch/ops/kernels/csrc/onmf_kernels.cu"
REPLACES = {
    "coder_sweeps": "onmf_ontf_ndl_tpu/ops/pallas/coder_kernel.py:192",
    "coder_sweeps_earlystop":
        "onmf_ontf_ndl_tpu/ops/pallas/coder_kernel.py:455",
    "dict_update_sweep": "onmf_ontf_ndl_tpu/ops/pallas/coder_kernel.py:629",
}
HEADLINE_N = 131072 + 37   # a ragged last tile


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


def compare(name, got, want):
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(got, want, **TOL, msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max())


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
    summary = {name: {"max_abs_err": 0.0} for name in REPLACES}
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
            cases = {
                "coder_sweeps": (ck.coder_sweeps, ck.coder_sweeps_plain,
                                 (A, B, H0, 0.1)),
                "coder_sweeps_earlystop": (
                    ck.coder_sweeps_earlystop,
                    ck.coder_sweeps_earlystop_plain, (A, B, H0, 0.1, 0.01)),
                "dict_update_sweep": (ck.dict_update_sweep,
                                      ck.dict_update_sweep_plain,
                                      (W, A_agg, B_agg)),
            }
            for name, (kernel, plain, args) in cases.items():
                err = compare(f"{name} r={r} n={n}", kernel(*args),
                              plain(*args))
                ms = cuda_ms(lambda: kernel(*args), 20)
                plain_ms = cuda_ms(lambda: plain(*args), 3)
                s = summary[name]
                s["max_abs_err"] = max(s["max_abs_err"], err)
                if r == 25 and n == HEADLINE_N:
                    s.update(ms=ms, plain_ms=plain_ms)
                emit("kernels", kernel=name, r=r, n=n, d=d, max_abs_err=err,
                     ms=ms, plain_ms=plain_ms)
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
    return summary


def sparse_dictionary_data(rng, d, r, n):
    Wt = np.abs(rng.standard_normal((d, r)))
    Wt /= np.linalg.norm(Wt, axis=0)
    codes = np.abs(rng.standard_normal((r, n))) * (rng.random((r, n)) < .3)
    return Wt, Wt @ codes + .01 * rng.random((d, n))


def phase_main(ck, dev):
    import onmf_ontf_ndl_tpu_torch as lib

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
    gen = torch.Generator(device=dev).manual_seed(1)
    Wt = torch.rand((d, r), generator=gen, device=dev)
    Wt = Wt / Wt.norm(dim=0)
    codes = torch.rand((r, 131072), generator=gen, device=dev)
    codes = codes * (torch.rand(codes.shape, generator=gen, device=dev) < .3)
    X = Wt @ codes + .01 * torch.rand((d, 131072), generator=gen,
                                      device=dev)
    for stop in (None, 0.01):
        st = lib.init_state(2, d, r, device=dev)
        st, _ = lib.train_dict(st, X, iterations=3, batch_size=batch,
                               stopping_diff=stop)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, code = lib.train_dict(st, X, iterations=steps + 1,
                                  batch_size=batch, stopping_diff=stop)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not (torch.isfinite(st.W).all() and torch.isfinite(code).all()
                and (st.W >= 0).all()):
            raise AssertionError("non-finite or negative training state")
        emit("main", check="throughput", stopping_diff=stop, d=d, r=r,
             batch=batch, steps=steps, step_ms=1e3 * dt / steps,
             patches_per_s=steps * batch / dt)
    # eager per-step overhead: a batch so small that the card is idle
    st = lib.init_state(3, d, r, device=dev)
    lib.train_dict(st, X, iterations=3, batch_size=128, stopping_diff=None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lib.train_dict(st, X, iterations=101, batch_size=128, stopping_diff=None)
    torch.cuda.synchronize()
    emit("main", check="eager_step_overhead", batch=128,
         step_ms=1e3 * (time.perf_counter() - t0) / 100)
    launches = dict(ck.LAUNCHES)
    emit("main", launches=launches)
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")

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
    rel = [float((a - b).norm() / b.norm())
           for a, b in zip(out[dev], out["cpu"])]
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


def phase_image(dev):
    from onmf_ontf_ndl_tpu_torch.apps.image import (ImageReconstructor,
                                                    reconstruct)
    from onmf_ontf_ndl_tpu_torch.models.state import make_generator

    img = torch.as_tensor(synthetic_image(7), dtype=torch.float32,
                          device=dev)
    kw = dict(data=img, device=dev, patch_size=10, n_components=25,
              num_patches=16384, sub_iterations=10, seed=4)
    rec = ImageReconstructor(iterations=5, **kw)
    W0 = rec.state.W.clone()
    t0 = time.perf_counter()
    rec.train_dict()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = rec.reconstruct_image_color(data=img, recons_resolution=2)
    torch.cuda.synchronize()
    recon_s = time.perf_counter() - t0
    out0 = reconstruct(img, W0 / W0.norm(dim=0).clamp_min(1.0),
                       make_generator(17, dev), patch_size=10, stride=2)

    def err(o):
        mask = o.sum(dim=-1) > 0
        return float(torch.linalg.norm((o - img)[mask])
                     / torch.linalg.norm(img[mask]))

    if tuple(out.shape) != tuple(img.shape) or not torch.isfinite(out).all():
        raise AssertionError("bad reconstruction")
    emit("image", train_seconds=train_s, recon_seconds=recon_s,
         recon_err=err(out), recon_err_initial_w=err(out0),
         history=rec.state.t)
    if not err(out) < err(out0):
        raise AssertionError("training did not lower the recon error")

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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_build(ck)
    summary = phase_kernels(ck, dev)
    launches = phase_main(ck, dev)
    phase_image(dev)
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"]} for name, s in summary.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

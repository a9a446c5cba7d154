"""The benchmark's colour tensor cells (``benchport/``) on the CPU: the
plain reference's FISTA equals the port's plain per-tile FISTA
(``fista_sweeps_plain``) iteration for iteration, the reference's mode-2
unfolding equals a hand-built index map, the port's tensor training and
colour reconstruction agree with the reference at a toy size, FISTA's
roofline counts are pinned, toy ``tensor-recon`` runs through the harness
are correct, and not correct under each planted fault, and the cell's
FISTA roofline reader returns what made-up traces give by hand, and None
where there is nothing to read. The toy runs go through a
fresh interpreter: the harness refuses to run where JAX is loaded, as it
is in this test process.

On the card (``-m cuda``; this file imports no JAX, so it runs there with
``--noconftest``): FISTA's own counts (``fista.column_iters``,
``fista.columns``) against the plain FISTA's iterations a tile, in both
modes and both kernels, with the Gauss-Seidel coders' counts left at 0.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchport import harness, inputs, peaks_fista, spans
from benchport.reference import onmf as ref_onmf
from benchport.reference import tensor as ref
from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck

REPO = Path(__file__).resolve().parents[1]
CFG = json.loads((REPO / "benchport" / "configs" / "tensor-r100.json")
                 .read_text())
TOY = {**CFG, **json.loads((REPO / "benchport" / "tests" / "toys" /
                            "tensor-r100.json").read_text())}


def _coder_inputs(d, r, n, seed, device="cpu"):
    """Gram-form inputs of patch-like data: X close to W times a sparse
    nonnegative code."""
    rng = np.random.default_rng(seed)
    W = rng.random((d, r)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0)
    code = rng.random((r, n)) * (rng.random((r, n)) < 0.2)
    X = (W @ code + 0.01 * rng.random((d, n))).astype(np.float32)
    H0 = rng.random((r, n)).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (W.T @ W, W.T @ X, H0))


@pytest.mark.parametrize("stop", [None, 0.01, 0.05])
@pytest.mark.parametrize("r, n", [(5, 40), (12, 300), (100, 100)])
def test_reference_fista_equals_the_ports_plain_fista(r, n, stop):
    """The same iterations a tile, and the code within float32 sums taken
    in another order (1e-5 of the code's largest entry: the reference's
    step and extrapolation are the plain version's operations, its
    products the same shapes)."""
    G, P, H0 = _coder_inputs(3 * r, r, n, seed=r + n)
    got, iters = ck.fista_sweeps_plain(
        G, P, H0, 2.0, 0.0 if stop is None else stop, sub_iter=60,
        use_stopping=stop is not None, with_sweeps=True)
    want, ran = ref.fista(G, P, H0, 2.0, 60, stop, ck.TN, ref_onmf.Prec(),
                          with_iters=True)
    assert torch.equal(iters, ran)
    if stop is not None:
        assert int(ran.min()) < 60       # the stop fired on some tile
    assert ref_onmf.gap(got, want) <= 1e-5


def test_reference_step_size_equals_the_ports():
    G, _, _ = _coder_inputs(1200, 100, 10, seed=3)
    assert float(ref.step_size(G, ref_onmf.Prec())) == pytest.approx(
        float(ck._inv_lipschitz(G, 16)), rel=1e-6)


def test_reference_turns_tf32_off(monkeypatch):
    """The reference's entry points run their products in true float32
    on the card, whoever called them."""
    for flag in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flag, "allow_tf32", True)
    img = inputs.images(3, 1, TOY["height"], TOY["width"], "cpu")[0]
    st = ref.train(img, 3, TOY, 1, ref_onmf.Prec())
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    ref.reconstruct(img, st.W, TOY, ref_onmf.Prec())
    assert not torch.backends.cuda.matmul.allow_tf32


def test_reference_unfolding_equals_a_hand_built_index_map():
    """Column m of the mode-2 unfolding, transposed, is patch m's pixels
    in the order (di * k + dj) * 3 + c: the port's patch matrix."""
    from onmf_ontf_ndl_tpu_torch.ops.patches import extract_patches

    k, n = 3, 7
    img = torch.rand((11, 9, 3), generator=torch.Generator().manual_seed(5))
    rows = torch.tensor([0, 7, 3, 1, 5, 2, 6])
    cols = torch.tensor([5, 0, 2, 4, 1, 3, 5])
    T = ref.patch_tensor(img, rows, cols, k)
    assert T.shape == (k * k, 3, n)
    X = ref.unfold_joint(T, 2)
    want = torch.empty((3 * k * k, n))
    for m in range(n):
        for di in range(k):
            for dj in range(k):
                for c in range(3):
                    want[(di * k + dj) * 3 + c, m] = \
                        img[rows[m] + di, cols[m] + dj, c]
    assert torch.equal(X, want)
    assert torch.equal(X, extract_patches(img, (rows, cols), k))


def _reconstructor(img, seed):
    from onmf_ontf_ndl_tpu_torch.apps.image_tensor import (
        ImageReconstructorTensor)

    return ImageReconstructorTensor(
        data=img, n_components=TOY["n_components"],
        iterations=TOY["rounds_per_call"],
        sub_iterations=TOY["sub_iterations"], batch_size=TOY["batch_size"],
        block_iterations=TOY["block_iterations"],
        num_patches=TOY["num_patches"], patch_size=TOY["patch_size"],
        learn_joint_dict=True, alpha=TOY["alpha"], fast=TOY["fast"],
        seed=seed, device="cpu")


@pytest.mark.parametrize("seed", [1, 77, 2**45 + 11])
def test_port_training_and_reconstruction_equal_the_reference(seed):
    """The port's ``_train_tensor`` (through ``train_dict(mode=2,
    learn_joint_dict=True)``) and ``reconstruct_image_color`` on the CPU
    against the reference at the toy size. W, A and B within 1e-4 of
    their largest entries: float32 sums in another order over 2 rounds;
    the port's plain coder decides its stop on exact eigenvalues, the
    reference as the kernel does, which agree away from the threshold
    (at most 7e-6 on these seeds). The image within 1e-4: each job codes
    from the program's own W (at most 7.3e-6)."""
    img = inputs.images(seed, 1, TOY["height"], TOY["width"], "cpu")[0]
    rec = _reconstructor(img, seed)
    rec.train_dict(mode=2, learn_joint_dict=True)
    st = ref.train(img, seed, TOY, TOY["rounds_per_call"], ref_onmf.Prec())
    for got, want in ((rec.state.W, st.W), (rec.state.A, st.A),
                      (rec.state.B, st.B)):
        assert ref_onmf.gap(got, want) <= 1e-4
    out = rec.reconstruct_image_color(
        data=img, recons_resolution=TOY["recons_stride"],
        alpha=TOY["recons_alpha"])
    want = ref.reconstruct(img, st.W, TOY, ref_onmf.Prec())
    assert out.shape == img.shape
    assert ref_onmf.gap(out, want) <= 1e-4


def test_fista_bound_counts_are_pinned():
    r = 100
    # a training step: 100 columns, 40 iterations
    seconds, by = peaks_fista.fista_bound(r, 100, 4000, 1)
    ops = 4000 * (2 * r * r + 8 * r) + 17 * 2 * r * r
    assert by == "operations"
    assert seconds == pytest.approx(ops / 67e12, rel=1e-12)
    # a reconstruction: 252,004 columns, 100 fixed iterations, one call
    n = 252_004
    seconds, by = peaks_fista.fista_bound(r, n, 100 * n, 1)
    assert by == "operations"
    assert seconds == pytest.approx(
        (100 * n * (2 * r * r + 8 * r) + 17 * 2 * r * r) / 67e12, rel=1e-12)
    assert round(seconds * 1e3, 3) == 7.823
    # bytes: G once a call, P and the start read and the code written
    seconds, by = peaks_fista.fista_bound(4, 10**9, 10**9, 3)
    assert by == "bytes"
    assert seconds == pytest.approx(4 * (3 * 16 + 12 * 10**9) / 3.35e12,
                                    rel=1e-12)


MS = 1_000_000           # ns


def _ctx(device, unit="job"):
    trace = SimpleNamespace(device=[(n, s * MS, e * MS) for n, s, e in device],
                            units=40, calls=2, host={})
    return SimpleNamespace(unit=unit, trace=trace, counts=dict(
        d=1200, r=100, n=100, sub_iter=100, fixed=True))


def _metric(name):
    return harness.load_metric(REPO / "benchport", name)


CALLS = [SimpleNamespace(name="recon.job", start_ns=0, end_ns=300 * MS,
                         device_ms=None)]
COUNTS = {"fista.column_iters": 160_000, "fista.columns": 4000,
          "fista_sweeps": 40}
KERNELS = [("void (anonymous namespace)::fista_tiled_kernel<false>", 0, 2),
           ("void (anonymous namespace)::fista_step_size_kernel", 2, 3),
           ("void (anonymous namespace)::dict_update_kernel<true>", 3, 50)]


def _fake(monkeypatch, counts):
    monkeypatch.setattr(spans, "record", lambda: (CALLS, counts))


def test_fista_readers_read_the_counted_work(monkeypatch):
    """40 calls of 100 columns, 40 iterations a column, in 3 ms of the
    FISTA kernels (the dictionary kernel not among them); a unit other
    than a job has nothing to read."""
    _fake(monkeypatch, COUNTS)
    least, _ = peaks_fista.fista_bound(100, 4000, 160_000, 40)
    assert _metric("fista_roofline.recon").read(_ctx(KERNELS)) == \
        pytest.approx(100.0 * least / 3e-3, rel=1e-9)
    assert _metric("fista_roofline.recon").read(
        _ctx(KERNELS, unit="round")) is None


@pytest.mark.parametrize("counts, device", [
    ({}, KERNELS),                                    # a program without
    ({"fista.column_iters": 0, "fista.columns": 0,    # no FISTA ran
      "fista_sweeps": 0}, KERNELS[2:]),
    (COUNTS, KERNELS[2:]),                            # no FISTA kernel traced
    (None, KERNELS)])                                 # no record at all
def test_fista_readers_read_nothing_where_nothing_is_there(monkeypatch,
                                                           counts, device):
    if counts is None:
        monkeypatch.setattr(spans, "record", lambda: None)
    else:
        _fake(monkeypatch, counts)
    ctx = _ctx(device)
    assert _metric("fista_roofline.recon").read(ctx) is None
    ctx.trace = None
    assert _metric("fista_roofline.recon").read(ctx) is None


TOY_RUN = """
import json, sys
from pathlib import Path
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
import pytest
from toy_root import make_toy
from benchport import harness
import faults.tensor
tmp = Path({tmp!r})
spec = make_toy(tmp)
with pytest.MonkeyPatch.context() as mp:
    if {fault!r}:
        getattr(faults.tensor, {fault!r})(mp)
    out = harness.run(spec=spec, workload={cell!r}, seed=2**45 + 11,
                      seconds=0.3, trace=False, device="cpu", root=tmp,
                      log=lambda *a, **k: 0)
print(json.dumps(out))
"""


def _toy_run(tmp_path, cell: str, fault: str) -> dict:
    code = TOY_RUN.format(tests=str(REPO / "benchport" / "tests"),
                          repo=str(REPO), tmp=str(tmp_path), cell=cell,
                          fault=fault)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell, metrics", [
    ("tensor-recon", {"recon_ms", "recon_p95_ms", "setup_s"})])
def test_toy_tensor_cell_is_correct(tmp_path, cell, metrics):
    out = _toy_run(tmp_path, cell, "")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == metrics


@pytest.mark.parametrize("cell, fault", [
    ("tensor-recon", f) for f in ("one_iteration_fewer", "stop_loosened",
                                  "wrong_alpha", "unchanged_state",
                                  "half_batch")])
def test_toy_tensor_cell_with_a_fault_is_not_correct(tmp_path, cell, fault):
    out = _toy_run(tmp_path, cell, fault)
    assert not out["correct"], out["checks"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stop", [None, 0.0, 0.05])
@pytest.mark.parametrize("r, n", [(100, 100), (100, 3 * ck.TN + 37),
                                  (25, 2 * ck.TN + 5), (160, ck.TN + 9)])
def test_cuda_fista_counts_its_own_iterations(cuda, r, n, stop):
    """FISTA's own counts on the card equal the plain FISTA's iterations a
    tile times its columns (with the stop; a tile within rounding of the
    threshold may stop an iteration apart, so the stop of 0.05 on these
    inputs is away from it) and its columns, on the shared-memory kernel
    and past it on the wide one, with the stop and with fixed
    iterations; the Gauss-Seidel coders' counts stay at 0. A replay from
    a CUDA graph counts as a launch does."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib

    G, P, H0 = _coder_inputs(3 * r, r, n, seed=r + n, device=cuda)
    kw = dict(sub_iter=30, use_stopping=stop is not None)
    _, iters = ck.fista_sweeps_plain(G, P, H0, 2.0, stop or 0.0, **kw,
                                     with_sweeps=True)
    cols = torch.full_like(iters, ck.TN)
    cols[-1] = n - ck.TN * (len(cols) - 1)
    want = (int((iters * cols).sum()), n)
    if stop:
        assert int(iters.min()) < 30

    def counted(fn, times=1):
        _lib.reset_launches()
        fn()
        runs = _lib.device_runs()
        assert (runs["coder_es.column_sweeps"], runs["coder_es.columns"],
                runs["coder_es.cluster_columns"]) == (0, 0, 0)
        assert runs["fista_sweeps"] == times
        return runs["fista.column_iters"], runs["fista.columns"]

    def call():
        return ck.fista_sweeps(G, P, H0, 2.0, stop or 0.0, **kw)

    assert counted(call) == want
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()

    def replays():
        for _ in range(2):
            graph.replay()

    assert counted(replays, 2) == (2 * want[0], 2 * want[1])

"""Hand-written CUDA kernels for the sequential sweeps of online NMF.

Counterpart of ``onmf_ontf_ndl_tpu/ops/pallas/coder_kernel.py``. The
sources are ``csrc/onmf_kernels.cu``; :func:`build` compiles them with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface
(under ``_build/``, keyed by a hash of the sources) and binds it with
ctypes. Nothing is built or loaded at import.

- :func:`coder_sweeps` replaces the TPU ``coder_sweeps`` (``:192``):
  exactly ``sub_iter`` Gauss-Seidel nonnegative-LASSO row sweeps from Gram
  form. One thread per column of H; the column lives in shared memory and
  A in shared memory, read by every thread as a broadcast. What bounds it
  on the card: the ``sub_iter * r^2`` dependent multiply-adds per column,
  each with a shared-memory load (the B/H0/H traffic is ~39 MB per call at
  n = 131072, r = 25: ~12 us at HBM speed). Columns are independent, so
  the design needs no barrier after the load and keeps thousands of
  threads in flight to hide the shared-memory latency. r <= 128.
- :func:`coder_sweeps_earlystop` replaces ``coder_sweeps_earlystop``
  (``:455``): the same sweeps with the reference's relative spectral-change
  stop decided per column tile of **TN = 128 columns** (one thread block).
  After each sweep the block forms the (r, r) Grams of the sweep delta and
  of the old iterate in shared memory, and one warp decides with certified
  bounds first (Rayleigh lower bound after one warm power step;
  min(trace, Gershgorin) upper bound) and ``pi_iters`` warm power steps only
  in the band between them. A converged tile leaves its loop. The tile is
  part of the semantics (PARITY.md deviation #8): the TPU kernel's tile is
  up to 13056 columns, this one is 128, so on a batch wider than 128
  columns the two freeze different column sets. What bounds it: the same
  sweep chain plus the Gram products (about the sweep's cost again) and
  the per-sweep barriers; shared memory (3 r^2 + 2 r (TN + 1) floats)
  limits it to r <= 100 and to one block per SM at r = 100.
- :func:`dict_update_sweep` replaces ``dict_update_sweep`` (``:629``): one
  column-BCD pass over W in a single block, sequential over the r columns,
  threads over the d rows, one block reduction per column norm. It reads
  ``A[:, j]`` by column, so no transpose is needed to match
  :func:`~onmf_ontf_ndl_tpu_torch.ops.dict_update.dict_update_bcd`. What
  bounds it: the r dependent column steps (2 barriers each); the work is
  d * r^2 FMAs, tiny at d = 300. Any d works (rows loop over the threads).

The TPU blocking (``block_rows``/``_block_corr``, the (8, 128) padding of
``_tile_plan``, SMEM staging) is not carried over.

Each wrapper runs its plain PyTorch version (``*_plain``, the same function)
only for a CPU tensor. For a CUDA tensor it launches the kernel or raises,
and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["coder_sweeps", "coder_sweeps_earlystop", "dict_update_sweep",
           "coder_sweeps_plain", "coder_sweeps_earlystop_plain",
           "dict_update_sweep_plain", "build", "LAUNCHES", "reset_launches",
           "TN", "MAX_RANK", "MAX_RANK_EARLYSTOP"]

TN = 128                  # early-stop tile: columns per thread block
MAX_RANK = 128            # coder_sweeps: A + the (r, TN) tile in shared memory
MAX_RANK_EARLYSTOP = 100  # 3 r^2 + 2 r (TN + 1) floats within 227 KB

_CSRC = Path(__file__).parent / "csrc"
_BUILD = Path(__file__).parent / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Launches of each kernel since the last reset_launches(). Only the
# wrappers' kernel branch adds to it.
LAUNCHES = {"coder_sweeps": 0, "coder_sweeps_earlystop": 0,
            "dict_update_sweep": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------------ build
def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.cache
def build() -> dict:
    """Compile (once per source hash) and load the kernel library.

    Returns ``{"lib": ctypes.CDLL, "path": str, "seconds": float,
    "compiled": bool}``; ``seconds`` is the nvcc time (0 when the library
    for these sources was already built).
    """
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = _BUILD / f"libonmf_kernels_{digest.hexdigest()[:16]}.so"
    seconds, compiled = 0.0, False
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in sources if s.suffix == ".cu"]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent build loads either copy
        compiled = True
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.onmf_coder_sweeps.argtypes = [p, p, p, p, i, i, f, i, p]
    lib.onmf_coder_sweeps_earlystop.argtypes = [p, p, p, p, i, i, f, f, i,
                                                i, p]
    lib.onmf_dict_update_sweep.argtypes = [p, p, p, p, i, i, p]
    for fn in (lib.onmf_coder_sweeps, lib.onmf_coder_sweeps_earlystop,
               lib.onmf_dict_update_sweep, lib.onmf_tile_columns):
        fn.restype = ctypes.c_int
    lib.onmf_tile_columns.argtypes = []
    lib.onmf_error_string.argtypes = [i]
    lib.onmf_error_string.restype = ctypes.c_char_p
    if lib.onmf_tile_columns() != TN:
        raise RuntimeError(
            f"kernel tile {lib.onmf_tile_columns()} != TN={TN}")
    return {"lib": lib, "path": str(so), "seconds": seconds,
            "compiled": compiled}


# --------------------------------------------------------------- launches
def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU (the plain path); raises on a
    mix of devices or on a device that is neither CPU nor CUDA."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


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


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        msg = build()["lib"].onmf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def coder_sweeps(A: torch.Tensor, B: torch.Tensor, H0: torch.Tensor,
                 alpha: float = 0.0, *, sub_iter: int = 10) -> torch.Tensor:
    """Exactly ``sub_iter`` nonnegative sparse-coding sweeps from Gram form.

    Args:
      A: (r, r) = W^T W.   B: (r, n) = W^T X.   H0: (r, n) start iterate.
    Returns the (r, n) code.
    """
    if _on_cpu(A, B, H0):
        return coder_sweeps_plain(A, B, H0, alpha, sub_iter=sub_iter)
    r, n = _check_coder("coder_sweeps", A, B, H0, MAX_RANK)
    out = torch.empty_like(B)
    if n == 0:
        return out
    lib = build()["lib"]
    with torch.cuda.device(B.device):
        err = lib.onmf_coder_sweeps(
            A.data_ptr(), B.data_ptr(), H0.data_ptr(), out.data_ptr(), r, n,
            float(alpha), int(sub_iter), _stream(B))
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
    r, n = _check_coder("coder_sweeps_earlystop", A, B, H0,
                        MAX_RANK_EARLYSTOP)
    out = torch.empty_like(B)
    if n == 0:
        return out
    lib = build()["lib"]
    with torch.cuda.device(B.device):
        err = lib.onmf_coder_sweeps_earlystop(
            A.data_ptr(), B.data_ptr(), H0.data_ptr(), out.data_ptr(), r, n,
            float(alpha), float(stopping_diff), int(sub_iter),
            int(pi_iters), _stream(B))
    _raise_on_error("coder_sweeps_earlystop", err)
    LAUNCHES["coder_sweeps_earlystop"] += 1
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
    with torch.cuda.device(W.device):
        err = lib.onmf_dict_update_sweep(
            W.data_ptr(), A.data_ptr(), B.data_ptr(), out.data_ptr(), d, r,
            _stream(W))
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


def coder_sweeps_earlystop_plain(A, B, H0, alpha=0.0, stopping_diff=0.01, *,
                                 sub_iter: int = 10, pi_iters: int = 12):
    """Plain PyTorch :func:`coder_sweeps_earlystop`: the same per-tile rule
    at the same tile width :data:`TN`, all tiles batched."""
    from onmf_ontf_ndl_tpu_torch.ops.coder import _sweep

    r, n = B.shape
    tiles = -(-n // TN)
    N = tiles * TN
    H = torch.zeros((r, N), dtype=B.dtype, device=B.device)
    Bp = torch.zeros_like(H)
    H[:, :n] = H0
    Bp[:, :n] = B
    pad = torch.arange(N, device=B.device) >= n
    stop2 = torch.tensor(stopping_diff, dtype=B.dtype) ** 2
    v0 = _fixed_start(r, B.dtype, B.device)
    vd = v0.expand(tiles, r).clone()
    vh = v0.expand(tiles, r).clone()
    conv = torch.zeros(tiles, dtype=torch.bool, device=B.device)
    for i in range(sub_iter):
        if bool(conv.all()):
            break
        H_old = H.clone()
        _sweep(H, A, Bp, alpha, 1.0 / math.sqrt(i + 10.0))
        H = torch.where(conv.repeat_interleave(TN) | pad, H_old, H)
        Ht = H.view(r, tiles, TN).transpose(0, 1)
        Ot = H_old.view(r, tiles, TN).transpose(0, 1)
        D = Ht - Ot
        Gd = D @ D.transpose(1, 2)
        Gh = Ot @ Ot.transpose(1, 2)
        lb_d, lb_h, vd1, vh1 = _warm_pair(Gd, Gh, vd + 0.05 * v0,
                                          vh + 0.05 * v0, 1)
        ub_d, ub_h = _psd_lambda_ub(Gd), _psd_lambda_ub(Gh)
        conv_certain = ub_d <= stop2 * lb_h
        band = ~(conv_certain | (lb_d > stop2 * ub_h))
        now = conv_certain
        if bool(band.any()):
            num, den, vd2, vh2 = _warm_pair(Gd, Gh, vd1, vh1, pi_iters)
            now = torch.where(band, num <= stop2 * den, conv_certain)
            vd1 = torch.where(band[:, None], vd2, vd1)
            vh1 = torch.where(band[:, None], vh2, vh1)
        live = ~conv
        vd = torch.where(live[:, None], vd1, vd)
        vh = torch.where(live[:, None], vh1, vh)
        conv = conv | (live & now)
    return H[:, :n].contiguous()

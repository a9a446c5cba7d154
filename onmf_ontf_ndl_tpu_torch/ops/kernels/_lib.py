"""The kernel library shared by ``coder_kernel.py``, ``ising_kernel.py``,
``motif_kernel.py``, ``group_kernel.py`` and ``patch_kernel.py``: its
build, its launch counts and the launch helpers of the wrappers.

The sources are ``csrc/*.cu``. :func:`build` compiles each source with its
own ``nvcc`` for ``sm_90a``, all at once, links them into one shared
library with a plain C interface (under ``_build/``, keyed by a hash of the
sources) and binds it with ctypes. Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["build", "LAUNCHES", "reset_launches", "TN", "ES_MAX_CLUSTER",
           "launch_counts",
           "captured_launches", "add_launches", "RUN_KERNELS",
           "SNAPSHOT_COUNTS", "DEVICE_COUNTS", "device_runs",
           "snapshot_runs"]

TN = 128                  # early-stop tile: columns per thread block
ES_MAX_CLUSTER = 8        # the early-stop coder's cluster form: most CTAs a tile


def _es_cluster_min(r: int) -> int:
    """The fewest CTAs of a tile in the early-stop coder's cluster form at
    rank ``r`` (csrc ``es_cluster_min``): 4, and 8 past r = 64; 0 where the
    form is not built, up to r = 32 and past r = 100. :func:`build` checks
    it and :data:`ES_MAX_CLUSTER` against the library."""
    return 0 if r <= 32 or r > 100 else 4 if r <= 64 else 8

_CSRC = Path(__file__).parent / "csrc"
_BUILD = Path(__file__).parent / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]

# Launches of each kernel since the last reset_launches(), for every kernel
# of the library. Only the wrappers' kernel branch adds to it.
LAUNCHES = {"coder_sweeps": 0, "coder_sweeps_earlystop": 0,
            "fista_sweeps": 0, "dict_update_sweep": 0,
            "checkerboard_sweeps": 0, "checkerboard_sweeps_band": 0,
            "chain_move": 0, "group_pairs": 0, "overlap_average": 0}


# The kernels whose main CUDA kernel also counts its own runs on the device
# (``onmf_read_runs`` for the first four, in the library's order;
# ``onmf_chain_read_runs`` for the chain's move, whose source keeps its own
# counter): a check of the counts above, replayed graphs included.
RUN_KERNELS = ("coder_sweeps", "coder_sweeps_earlystop", "fista_sweeps",
               "dict_update_sweep", "chain_move")

# Every count the kernels keep on the device: those of the library's
# array (``onmf_read_runs``; :func:`snapshot_runs` copies them), the runs
# of the first four kernels above, then the work of the Gauss-Seidel
# coders with the stop, shared-memory and wide (replays included):
# ``coder_es.column_sweeps``, each tile's sweeps times its columns, and
# ``coder_es.columns``, the columns coded; ``coder_es.cluster_columns``,
# the columns the early-stop coder coded in its cluster form (a tile on a
# cluster of CTAs); then the dictionary update's ``dict.columns``, the
# columns its column step ran, and ``dict.panel_updates``, the rank-k
# updates of G that its panel form applied (one after each panel of k
# columns but the last); then FISTA's work in both of its kernels, with
# the stop and with fixed iterations: ``fista.column_iters``, each tile's
# iterations times its columns, and ``fista.columns``, the columns coded;
# last the chain's move. The column sweeps (iterations) over the columns
# are the mean sweeps (iterations) a column.
SNAPSHOT_COUNTS = RUN_KERNELS[:4] + ("coder_es.column_sweeps",
                                     "coder_es.columns",
                                     "coder_es.cluster_columns",
                                     "dict.columns", "dict.panel_updates",
                                     "fista.column_iters", "fista.columns")
DEVICE_COUNTS = SNAPSHOT_COUNTS + ("chain_move",)


def reset_launches() -> None:
    """Zero the counts, and the device's (:func:`device_runs`) where the
    library is loaded on a CUDA device."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    if build.cache_info().currsize and torch.cuda.is_initialized():
        lib = build()["lib"]
        _raise_on_error("onmf_reset_runs", lib.onmf_reset_runs())
        _raise_on_error("onmf_chain_reset_runs", lib.onmf_chain_reset_runs())


def device_runs() -> dict:
    """Each count of :data:`DEVICE_COUNTS` on the current CUDA device since
    the last :func:`reset_launches`, as the kernels count themselves: the
    runs of each kernel of :data:`RUN_KERNELS` and the work of the coders
    and the dictionary update; what a graph replays counts too.
    Synchronises the device."""
    lib = build()["lib"]
    out = (ctypes.c_ulonglong * len(DEVICE_COUNTS))()
    _raise_on_error("onmf_read_runs", lib.onmf_read_runs(out))
    chain = ctypes.c_ulonglong()
    _raise_on_error("onmf_chain_read_runs",
                    lib.onmf_chain_read_runs(ctypes.byref(chain)))
    out[-1] = chain.value
    return dict(zip(DEVICE_COUNTS, map(int, out)))


def snapshot_runs(device: torch.device, address: int, stream: int) -> bool:
    """Queue a copy of the counts of :data:`SNAPSHOT_COUNTS` on ``device``
    to ``address`` (pinned host memory, as many int64) on ``stream`` (a
    raw ``cudaStream_t`` of the device), with no synchronise: they are
    there once the stream has passed this point. False, and nothing
    queued, where the library is not loaded (its counts are then all
    zero)."""
    if not build.cache_info().currsize:
        return False
    lib = build()["lib"]
    if device.index == torch.cuda.current_device():
        err = lib.onmf_snapshot_runs(address, stream)
    else:
        with torch.cuda.device(device):
            err = lib.onmf_snapshot_runs(address, stream)
    _raise_on_error("onmf_snapshot_runs", err)
    return True


# A CUDA graph's capture calls the wrappers, which count, but launches
# nothing; each replay launches without calling them. So a capture takes
# back what it counted, and each replay adds it again.
def launch_counts() -> dict:
    """A copy of the counts, taken before a capture."""
    return dict(LAUNCHES)


def captured_launches(before: dict) -> dict:
    """The launches counted since ``before`` (a :func:`launch_counts`
    taken just before a capture), which are what one replay of the graph
    launches. The counts go back to ``before``."""
    added = {name: LAUNCHES[name] - before[name] for name in LAUNCHES}
    LAUNCHES.update(before)
    return added


def add_launches(counts: dict, replays: int) -> None:
    """Count ``replays`` replays of a graph that launches ``counts``."""
    for name, count in counts.items():
        LAUNCHES[name] += count * replays


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


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the output of the first that
    fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def build() -> dict:
    """Compile (once per source hash) and load the kernel library: one
    ``nvcc -c`` per source, all started together, then one link.

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
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        cus = [s for s in sources if s.suffix == ".cu"]
        objs = [_BUILD / f"{s.stem}.{tag}.o" for s in cus]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        _run_all([[nvcc, *_NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                  for s, o in zip(cus, objs)])
        _run_all([[nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink()
        os.replace(tmp, so)   # atomic: a concurrent build loads either copy
        compiled = True
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.onmf_coder_sweeps.argtypes = [p, p, p, p, i, i, f, i, p, i, p]
    lib.onmf_coder_sweeps_earlystop.argtypes = [p, p, p, p, i, i, f, f, i,
                                                i, i, p, i, p]
    lib.onmf_coder_es_cluster_min.argtypes = [i]
    lib.onmf_coder_es_max_cluster.argtypes = []
    lib.onmf_fista_sweeps.argtypes = [p, p, p, p, i, i, f, p, i, f, i, i, i,
                                      i, p, i, p]
    lib.onmf_dict_update_sweep.argtypes = [p, p, p, p, i, i, i, p]
    lib.onmf_checkerboard_sweeps.argtypes = [p, i, i, ctypes.c_uint, p, i,
                                             p]
    lib.onmf_checkerboard_sweeps_at.argtypes = [p, i, i, p, p, i, p]
    u = ctypes.c_uint
    lib.onmf_checkerboard_band_half.argtypes = [p, p, p, i, i, i, u, u, u, p,
                                                p]
    ll = ctypes.c_longlong
    graph = [i, ll, p, p, ll, p, p, p, p, ll, p]   # GraphView, the stream
    lib.onmf_chain_glauber.argtypes = [p, i, i, i, p, p, p, p, i, p, i, i,
                                       *graph]
    lib.onmf_chain_pivot.argtypes = [p, i, i, i, i, i, i, i, p, p, p, p, p,
                                     p, p, i, *graph]
    sz = ctypes.c_size_t
    lib.onmf_group_sort_bytes.argtypes = [ll, i, i, ctypes.POINTER(sz)]
    lib.onmf_group_sort.argtypes = [p, p, ll, i, i, ll, i, i, p, p, p, p, p,
                                    sz, ctypes.POINTER(i), p]
    lib.onmf_group_heads.argtypes = [p, ll, i, p, p, p]
    lib.onmf_group_sum.argtypes = [p, p, ll, i, ll, p, p, p, p, p, p, p, p,
                                   p]
    lib.onmf_group_tile.argtypes = []
    lib.onmf_overlap_average.argtypes = [p, p, i, i, i, i, i, i, i, p]
    lib.onmf_read_runs.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.onmf_chain_read_runs.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.onmf_snapshot_runs.argtypes = [p, p]
    lib.onmf_reset_runs.argtypes = []
    lib.onmf_chain_reset_runs.argtypes = []
    for fn in (lib.onmf_coder_sweeps, lib.onmf_coder_sweeps_earlystop,
               lib.onmf_coder_es_cluster_min, lib.onmf_coder_es_max_cluster,
               lib.onmf_fista_sweeps, lib.onmf_dict_update_sweep,
               lib.onmf_checkerboard_sweeps, lib.onmf_checkerboard_sweeps_at,
               lib.onmf_checkerboard_band_half,
               lib.onmf_chain_glauber, lib.onmf_chain_pivot,
               lib.onmf_tile_columns, lib.onmf_read_runs,
               lib.onmf_reset_runs, lib.onmf_chain_read_runs,
               lib.onmf_chain_reset_runs, lib.onmf_snapshot_runs,
               lib.onmf_run_slots, lib.onmf_group_sort_bytes,
               lib.onmf_group_sort, lib.onmf_group_heads, lib.onmf_group_sum,
               lib.onmf_group_tile, lib.onmf_overlap_average):
        fn.restype = ctypes.c_int
    lib.onmf_tile_columns.argtypes = []
    lib.onmf_run_slots.argtypes = []
    for fn, args in ((lib.onmf_dict_smem_floats, [i, i]),
                     (lib.onmf_coder_sweeps_smem, [i]),
                     (lib.onmf_fista_sweeps_smem, [i, i]),
                     (lib.onmf_fista_head_floats, [i]),
                     (lib.onmf_fista_slice_floats, [i, i]),
                     (lib.onmf_checkerboard_smem, [i, i])):
        fn.argtypes = args
        fn.restype = ctypes.c_size_t
    for fn in (lib.onmf_fista_wide_config, lib.onmf_coder_wide_config):
        fn.argtypes = [i, i, ctypes.POINTER(i)]
        fn.restype = None
    lib.onmf_error_string.argtypes = [i]
    lib.onmf_error_string.restype = ctypes.c_char_p
    if lib.onmf_tile_columns() != TN:
        raise RuntimeError(
            f"kernel tile {lib.onmf_tile_columns()} != TN={TN}")
    if lib.onmf_run_slots() != len(SNAPSHOT_COUNTS):
        raise RuntimeError(f"kernel counts {lib.onmf_run_slots()} != "
                           f"{len(SNAPSHOT_COUNTS)} of SNAPSHOT_COUNTS")
    if lib.onmf_coder_es_max_cluster() != ES_MAX_CLUSTER or any(
            lib.onmf_coder_es_cluster_min(r) != _es_cluster_min(r)
            for r in range(1, 257)):
        raise RuntimeError("the early-stop coder's cluster sizes differ "
                           "from the kernel library's")
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


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        msg = build()["lib"].onmf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _sm_count(device: torch.device) -> int:
    """The SMs of ``device``, queried once."""
    return torch.cuda.get_device_properties(device).multi_processor_count

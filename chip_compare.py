"""Device times of the port's coder and dictionary kernels at the paths'
shapes, for comparing two versions of the package on one card.

    python3 chip_compare.py [ROOT] [TAG]

ROOT (default: this checkout) holds the ``onmf_ontf_ndl_tpu_torch``
package to time, e.g. another commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists; TAG labels its lines. Each kernel is
timed as a CUDA graph of 20 calls, replayed three times; the least mean is
kept. Inputs come from one seed, so two versions time the same work. To
compare versions, run them in turns in one call (A, B, B, A). Prints one
JSON line per shape. Needs one CUDA device.
"""

import json
import sys
from pathlib import Path

import torch

# (d, r) of the dictionary update: one warp's worth of rows (d = 32), then
# the main path and image app, network (a), Ising and tensor paths
DICT_SHAPES = [(32, 25), (300, 25), (441, 25), (400, 100), (1200, 100)]
# (r, n) of the coders: the main path's batch and headline n, Ising
CODER_SHAPES = [(25, 16384), (25, 131072 + 37), (100, 1000)]


def graph_ms(fn, reps=20, replays=3):
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


def main():
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        sys.exit(1)
    root = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
    tag = sys.argv[2] if len(sys.argv) > 2 else root.name
    sys.path.insert(0, str(root))
    from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck

    if not Path(ck.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ck.__file__}, not from {root}")
    ck.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    for d, r in DICT_SHAPES:
        W = torch.rand((d, r), generator=gen).to(dev)
        A = torch.rand((r, r), generator=gen).to(dev)
        B = torch.rand((r, d), generator=gen).to(dev)
        print(json.dumps({"version": tag, "kernel": "dict_update_sweep",
                          "d": d, "r": r, "ms": graph_ms(
                              lambda: ck.dict_update_sweep(W, A, B))}),
              flush=True)
    for r, n in CODER_SHAPES:
        W = torch.rand((300, r), generator=gen)
        W = (W / W.norm(dim=0)).to(dev)
        X = torch.rand((300, n), generator=gen).to(dev)
        H0 = torch.rand((r, n), generator=gen).to(dev)
        A, B = W.T @ W, W.T @ X
        line = {"version": tag, "r": r, "n": n}
        line["coder_sweeps_earlystop"] = graph_ms(
            lambda: ck.coder_sweeps_earlystop(A, B, H0, 0.1, 0.01))
        line["coder_sweeps"] = graph_ms(lambda: ck.coder_sweeps(A, B, H0, 0.1))
        line["fista_sweeps"] = graph_ms(lambda: ck.fista_sweeps(
            A, B, H0, 0.1, 0.01, sub_iter=10, use_stopping=False))
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

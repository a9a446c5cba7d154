"""Run one cell of the port's benchmark once and print its result line.

    python3 benchport/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks`` (each number
compared with the plain reference, beside its limit; the same on the last
lines of standard error). Needs as many CUDA devices as the cell asks
for, and exits non-zero without a result where they are missing, or
where JAX or the JAX package was loaded.

``--control 1`` runs no window: it prints the control's readings (the
reference in TF32 in the program's place) for the seed, one JSON line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# Every build and kernel cache at a fixed path inside the checkout, so
# that only a checkout's first run builds.
CACHE = REPO / "_benchport_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from benchport import harness

    spec = harness.load_json(REPO / "BENCHMARK.json")
    if a.control:
        print(json.dumps(harness.control(spec=spec, workload=a.workload,
                                         seed=a.seed)), flush=True)
        return 0
    out = harness.run(spec=spec, workload=a.workload, seed=a.seed,
                      seconds=a.seconds, trace=bool(a.trace),
                      t_start=T_START)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

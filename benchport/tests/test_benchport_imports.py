"""What the benchmark may load: no JAX and nothing of the JAX package in
anything it runs (top-level module names compared whole, so the port,
whose name begins with the JAX package's, does not match), and nothing of
the port in the plain reference."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from toy_root import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "onmf_ontf_ndl_tpu"}


def imported_tops(path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "onmf_ontf_ndl_tpu_torch" not in imported_tops(path)


def test_top_level_names_are_compared_whole():
    sys.path.insert(0, str(REPO))
    from benchport import harness

    sys.modules.setdefault("onmf_ontf_ndl_tpu_torch_probe", sys)
    try:
        assert "onmf_ontf_ndl_tpu_torch_probe" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["onmf_ontf_ndl_tpu_torch_probe"]


def test_module_loaded_after_the_window_withholds_the_result(toy):
    """A metric's reader that loads a module named ``jax`` after the
    window (a dynamic import no look at the sources sees): the run exits
    without a result."""
    from benchport import harness

    spec, root = toy
    (root / "metrics" / "extra.loads_jax.py").write_text(
        "import sys, types\n"
        "def read(ctx):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n"
        "    return 1.0\n")
    spec["end_to_end"].append({"name": "extra.loads_jax", "unit": "x",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["image-train"]})
    assert "jax" not in sys.modules
    try:
        with pytest.raises(SystemExit, match="jax"):
            harness.run(spec=spec, workload="image-train", seed=2**40 + 5,
                        seconds=0.2, trace=False, device="cpu", root=root,
                        log=lambda *a, **k: None)
    finally:
        sys.modules.pop("jax", None)


DRY_RUN = """
import json, sys
from pathlib import Path
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
from toy_root import make_toy
from benchport import harness
tmp = Path({tmp!r})
spec = make_toy(tmp)
for w in [c["name"] for c in spec["workloads"]]:
    harness.run(spec=spec, workload=w, seed=2**40 + 3, seconds=0.3,
                trace=False, device="cpu", root=tmp, log=lambda *a, **k: 0)
print(json.dumps(sorted(sys.modules)))
"""


def test_cpu_dry_run_loads_no_jax(tmp_path):
    """Every cell's whole run on the CPU, in a fresh interpreter: no
    module of JAX or the JAX package is loaded after it."""
    code = DRY_RUN.format(tests=str(BENCH / "tests"), repo=str(REPO),
                          tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "onmf_ontf_ndl_tpu_torch" in mods
    assert not {m.split(".")[0] for m in mods} & FORBIDDEN


def test_reference_loads_nothing_of_the_port(tmp_path):
    code = (f"import sys, json; sys.path.insert(0, {str(REPO)!r}); "
            "import benchport.reference.image, benchport.reference.network; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert not any(m.split(".")[0] == "onmf_ontf_ndl_tpu_torch"
                   for m in mods)


@pytest.mark.cuda
def test_cuda_run_loads_no_jax(card):
    """A short run of a cell on the card, through the command: a result
    line, correct, and no JAX."""
    out = subprocess.run(
        [sys.executable, "benchport/run.py", "--workload", "image-train",
         "--seed", str(2**33 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"

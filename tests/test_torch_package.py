"""Package-level properties of the PyTorch port."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend

torch.set_num_threads(1)

_PROBE = """
import sys, torch
import onmf_ontf_ndl_tpu_torch as p
import onmf_ontf_ndl_tpu_torch.apps.image
import onmf_ontf_ndl_tpu_torch.apps.image_tensor
import onmf_ontf_ndl_tpu_torch.apps.ising
import onmf_ontf_ndl_tpu_torch.apps.network
import onmf_ontf_ndl_tpu_torch.apps.video
import onmf_ontf_ndl_tpu_torch.data.video
import onmf_ontf_ndl_tpu_torch.ops.patches
import onmf_ontf_ndl_tpu_torch.data.graphs
import onmf_ontf_ndl_tpu_torch.data.native as native
import onmf_ontf_ndl_tpu_torch.models.ontf
import onmf_ontf_ndl_tpu_torch.ops.unfold
import onmf_ontf_ndl_tpu_torch.samplers.ising
import onmf_ontf_ndl_tpu_torch.samplers.motif
import onmf_ontf_ndl_tpu_torch.utils
import onmf_ontf_ndl_tpu_torch.cli
import onmf_ontf_ndl_tpu_torch.utils.config
import onmf_ontf_ndl_tpu_torch.utils.debug
import onmf_ontf_ndl_tpu_torch.utils.profiling
import onmf_ontf_ndl_tpu_torch.utils.viz
import onmf_ontf_ndl_tpu_torch.parallel.auto
import onmf_ontf_ndl_tpu_torch.parallel.dp
import onmf_ontf_ndl_tpu_torch.parallel.ising_sharded
import onmf_ontf_ndl_tpu_torch.parallel.mesh
import onmf_ontf_ndl_tpu_torch.parallel.multihost
from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel, ising_kernel
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not any(m.startswith("onmf_ontf_ndl_tpu.") or m == "onmf_ontf_ndl_tpu"
               for m in sys.modules)
assert coder_kernel.build.cache_info().currsize == 0   # nothing built
assert native._get_lib.cache_info().currsize == 0      # nor the loader
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
assert "triton" not in sys.modules
assert p.IsingReconstructor.__name__ == "IsingReconstructor"
assert p.ImageReconstructorTensor.__name__ == "ImageReconstructorTensor"
assert p.NetworkReconstructor.__name__ == "NetworkReconstructor"
assert p.VideoDictionaryLearner.__name__ == "VideoDictionaryLearner"
assert "VideoDictionaryLearner" in p.__all__
assert "PIL" not in sys.modules      # the loaders import it when called
assert "matplotlib" not in sys.modules   # viz imports it when called
assert coder_kernel.build.cache_info().currsize == 0   # still nothing built
print("ok", p.ImageReconstructor.__name__)
"""


def test_port_imports_without_jax_and_builds_nothing():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok ImageReconstructor"


def _entry_points(tmp_path):
    """Each entry point with small arguments, called without a device."""
    import numpy as np

    import onmf_ontf_ndl_tpu_torch as p
    from onmf_ontf_ndl_tpu_torch.apps.image import ImageReconstructor
    from onmf_ontf_ndl_tpu_torch.apps.image_tensor import (
        ImageReconstructorTensor)
    from onmf_ontf_ndl_tpu_torch.apps.ising import IsingReconstructor
    from onmf_ontf_ndl_tpu_torch.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu_torch.apps.video import VideoDictionaryLearner
    from onmf_ontf_ndl_tpu_torch.data import graphs, images, video
    from onmf_ontf_ndl_tpu_torch.ops import patches
    from onmf_ontf_ndl_tpu_torch.models.ontf import OnlineNTF
    from onmf_ontf_ndl_tpu_torch.models.state import (init_state,
                                                      state_from_numpy)
    from onmf_ontf_ndl_tpu_torch.parallel import (auto, dp, ising_sharded,
                                                  multihost)
    from onmf_ontf_ndl_tpu_torch.utils import config
    from onmf_ontf_ndl_tpu_torch.utils.checkpoint import load_state

    def cpu_state(track_xxt=False):
        return init_state(0, 4, 2, device="cpu", track_xxt=track_xxt)

    rng = np.random.default_rng(0)
    img = rng.random((16, 16, 3))
    ring = np.roll(np.eye(6), 1, axis=1)
    W, A, B = rng.random((4, 2)), np.eye(2), rng.random((2, 4))
    edges = np.array([[0, 1], [1, 2], [2, 0]])
    edge_file = tmp_path / "edges.txt"
    np.savetxt(edge_file, edges, fmt="%d", delimiter=",")
    np.save(tmp_path / "spins.npy", np.sign(rng.random((8, 8)) - 0.5))
    spins = str(tmp_path / "spins.npy")
    from PIL import Image

    gif = str(tmp_path / "clip.gif")
    stills = [Image.fromarray((rng.random((8, 8, 3)) * 255).astype(np.uint8))
              for _ in range(2)]
    stills[0].save(gif, save_all=True, append_images=stills[1:])
    stills[0].save(tmp_path / "img.png")
    return {
        p.OnlineNMF: lambda **kw: p.OnlineNMF(rng.random((4, 10)),
                                              n_components=2, **kw),
        OnlineNTF: lambda **kw: OnlineNTF(rng.random((4, 5, 3)),
                                          n_components=2, **kw),
        ImageReconstructor: lambda **kw: ImageReconstructor(
            data=img, n_components=2, patch_size=4, **kw),
        ImageReconstructorTensor: lambda **kw: ImageReconstructorTensor(
            data=img, n_components=2, patch_size=4, **kw),
        IsingReconstructor: lambda **kw: IsingReconstructor(
            n_components=2, lattice_size=8, patch_size=4, **kw),
        NetworkReconstructor: lambda **kw: NetworkReconstructor(
            adjacency=ring + ring.T, n_components=2, k1=0, k2=2, **kw),
        init_state: lambda **kw: init_state(0, 4, 2, **kw),
        state_from_numpy: lambda **kw: state_from_numpy(W, A, B, None, 0.0,
                                                        **kw),
        load_state: lambda **kw: load_state(str(tmp_path / "none.npz"),
                                            **kw),
        # the makers of the port's inputs: graphs and images
        graphs.graph_from_edgelist: lambda **kw: graphs.graph_from_edgelist(
            edges, **kw),
        graphs.graph_from_adjacency: lambda **kw: graphs.graph_from_adjacency(
            ring + ring.T, **kw),
        graphs.load_edgelist: lambda **kw: graphs.load_edgelist(
            str(edge_file), **kw),
        graphs.load_edgelist_csr: lambda **kw: graphs.load_edgelist_csr(
            str(edge_file), **kw),
        graphs.load_edgelist_bitset: lambda **kw: graphs.load_edgelist_bitset(
            str(edge_file), **kw),
        graphs.csr_graph_from_edges: lambda **kw: graphs.csr_graph_from_edges(
            edges, **kw),
        graphs.bitset_graph_from_edges:
            lambda **kw: graphs.bitset_graph_from_edges(edges, **kw),
        images.load_image: lambda **kw: images.load_image(
            spins, is_matrix=True, **kw),
        video.load_video_frames: lambda **kw: video.load_video_frames(
            gif, **kw),
        VideoDictionaryLearner: lambda **kw: VideoDictionaryLearner(
            frames=rng.random((2, 8, 8, 3)), n_components=2, patch_size=4,
            **kw),
        patches.grid_patch_corners: lambda **kw: patches.grid_patch_corners(
            (8, 8), 4, 2, **kw),
        patches.all_patch_corners: lambda **kw: patches.all_patch_corners(
            (8, 8), 4, **kw),
        # the configs build their app on the card by default
        config.ImageConfig: lambda **kw: config.ImageConfig(
            path=spins, is_matrix=True, is_color=False, patch_size=4,
            **kw).build(),
        config.TensorConfig: lambda **kw: config.TensorConfig(
            path=str(tmp_path / "img.png"), patch_size=4, **kw).build(),
        config.IsingConfig: lambda **kw: config.IsingConfig(
            lattice_size=8, patch_size=4, n_components=2, **kw).build(),
        config.NetworkConfig: lambda **kw: config.NetworkConfig(
            source=str(edge_file), k2=2, n_components=2,
            representation="csr", **kw).build(),
        config.VideoConfig: lambda **kw: config.VideoConfig(
            path=gif, patch_size=4, n_components=2, **kw).build(),
        # the data-parallel and sharded entry points (a one-rank gloo group)
        dp.shard_batch: lambda **kw: dp.shard_batch(rng.random((4, 6)), **kw),
        dp.dp_onmf_step: lambda **kw: dp.dp_onmf_step(
            cpu_state(), rng.random((4, 6)), **kw),
        dp.dp_train_dict: lambda **kw: dp.dp_train_dict(
            cpu_state(), rng.random((4, 6)), iterations=2,
            batch_size_per_device=3, **kw),
        auto.auto_train_dict: lambda **kw: auto.auto_train_dict(
            cpu_state(), rng.random((4, 6)), iterations=2, batch_size=3,
            **kw),
        dp.dp_train_image_dict: lambda **kw: dp.dp_train_image_dict(
            cpu_state(), rng.random((6, 6)), outer_iterations=1,
            num_patches_per_device=3, inner_iterations=2,
            batch_size_per_device=3, patch_size=2, **kw),
        dp.dp_train_tensor_dict: lambda **kw: dp.dp_train_tensor_dict(
            cpu_state(), rng.random((4, 3, 2)), mode=0, iterations=2,
            batch_size_per_device=3, sub_iterations=1, **kw),
        dp.dp_ising_learning: lambda **kw: dp.dp_ising_learning(
            cpu_state(track_xxt=True), np.ones((1, 8, 8), np.int8),
            torch.Generator(), ising_iterations=1, nsteps=1,
            num_patches_per_device=3, inner_iterations=2, batch_size=3,
            patch_size=2, **kw),
        dp.dp_ndl_train: lambda **kw: dp.dp_ndl_train(
            init_state(0, 9, 2, device="cpu"), graphs.graph_from_adjacency(
                ring + ring.T, device="cpu"), np.arange(3)[None],
            np.eye(3, k=1, dtype=int), mcmc_iterations=1,
            sample_size_per_device=4, inner_iterations=2, batch_size=2,
            **kw),
        dp.dp_reconstruct_network_sparse:
            lambda **kw: dp.dp_reconstruct_network_sparse(
                init_state(0, 9, 2, device="cpu").W,
                graphs.graph_from_adjacency(ring + ring.T, device="cpu"),
                torch.Generator(), np.eye(3, k=1, dtype=int),
                recons_iter_per_device=4, **kw),
        ising_sharded.sharded_checkerboard_sweeps:
            lambda **kw: ising_sharded.sharded_checkerboard_sweeps(
                1, np.ones((8, 8), np.int8), 1, **kw),
        multihost.initialize: lambda **kw: multihost.initialize(**kw),
    }


@pytest.mark.parametrize("name", [
    "OnlineNMF", "OnlineNTF", "ImageReconstructor", "ImageReconstructorTensor",
    "IsingReconstructor", "NetworkReconstructor", "init_state",
    "state_from_numpy", "load_state", "graph_from_edgelist",
    "graph_from_adjacency", "load_edgelist", "load_edgelist_csr",
    "load_edgelist_bitset", "csr_graph_from_edges",
    "bitset_graph_from_edges", "load_image", "load_video_frames",
    "VideoDictionaryLearner", "grid_patch_corners", "all_patch_corners",
    "ImageConfig", "TensorConfig", "IsingConfig", "NetworkConfig",
    "VideoConfig", "shard_batch", "dp_onmf_step", "dp_train_dict",
    "auto_train_dict",
    "dp_train_image_dict", "dp_train_tensor_dict", "dp_ising_learning",
    "dp_ndl_train", "dp_reconstruct_network_sparse",
    "sharded_checkerboard_sweeps", "initialize"])
def test_entry_point_defaults_to_the_card(name, tmp_path, monkeypatch):
    # the entry point defaults to device="cuda"; without CUDA a call that
    # names no device raises rather than running on the CPU, and the same
    # call with device="cpu" runs (load_state: up to the missing file;
    # the data-parallel entry points in a one-rank gloo group)
    import inspect

    import torch.distributed as dist

    fn, call = next((fn, call) for fn, call in _entry_points(tmp_path).items()
                    if fn.__name__ == name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    if name == "load_state":
        with pytest.raises(FileNotFoundError):
            call(device="cpu")
        return
    grouped = name.startswith(("dp_", "shard", "auto_")) \
        or name == "initialize"
    if grouped:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                world_size=1, rank=0)
    try:
        out = call(device="cpu")
    finally:
        if grouped:
            dist.destroy_process_group()
    if name in ("load_image", "load_video_frames"):
        assert out.device.type == "cpu"
    elif name == "csr_graph_from_edges":
        assert out.offsets.device.type == "cpu"
    elif name.endswith("patch_corners"):
        assert out[0].device.type == out[1].device.type == "cpu"


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    # --device is the config's field: "cuda" unless given; without CUDA
    # the run raises before it writes anything, with --device cpu it runs
    from onmf_ontf_ndl_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["ising", "--lattice-size", "8", "--patch-size", "4",
            "--n-components", "2", "--ising-iterations", "1",
            "--ising-subsampling-steps", "64", "--sub-iterations", "2",
            "--num-patches", "4", "--batch-size", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--out-dir", str(tmp_path / "card")] + args)
    assert not (tmp_path / "card" / "run.json").exists()
    assert cli.main(["--out-dir", str(tmp_path / "cpu")] + args
                    + ["--device", "cpu"]) == 0


def test_random_patch_corners_follow_the_generator():
    # the corners take their device from the generator, not from a default
    # of their own: a path on the card stays there, a CPU generator stays
    # on the CPU
    import inspect

    from onmf_ontf_ndl_tpu_torch.ops.patches import random_patch_corners

    assert inspect.signature(random_patch_corners).parameters[
        "device"].default is None
    a, b = random_patch_corners(torch.Generator().manual_seed(0), (16, 16),
                                4, 5)
    assert a.device.type == b.device.type == "cpu" and a.shape == (5,)
    assert int(a.max()) < 12 and int(b.max()) < 12


def test_resolve_backend_by_tensor_device():
    x = torch.zeros(3)
    assert resolve_backend("auto", x) == "torch"
    assert resolve_backend("torch", x) == "torch"
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        resolve_backend("cuda", x)
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas", x)


@pytest.mark.parametrize("mode", ["fixed", "stop", "bf16"])
def test_smoke_bound_takes_the_peak_of_the_operand_type(mode):
    # chip_smoke.py's bound of a FISTA call: the f32 product and the Grams
    # at the float32 peak, a bf16 product at the tensor cores' bf16 peak
    import chip_smoke as cs

    r, n, iterations = 100, 100, 38
    kw = cs.FISTA_MODES[mode]
    ms, by = cs.coder_bound("fista_sweeps", r, n, None, kw,
                            sweeps=torch.tensor([iterations]))
    column_sweeps = n * (iterations if kw.get("use_stopping", True)
                         else kw["sub_iter"])
    product = 2 * r * r * column_sweeps
    grams = 2 * r * (r + 1) * column_sweeps * kw.get("use_stopping", True)
    want = {"fixed": product / 67e12, "stop": (product + grams) / 67e12,
            "bf16": product / 989e12 + grams / 67e12}[mode]
    assert by == "operations"
    assert ms == pytest.approx(1e3 * want, rel=1e-12)
    assert cs.bound(3.35e12, 0) == (1e3, "bytes")


# ----------------------------------------------- __all__ against the JAX one
_ROOT = Path(__file__).resolve().parent.parent
_JAX = _ROOT / "onmf_ontf_ndl_tpu"
# the port's deliberate differences: names it adds to a package, and the
# JAX name each port name stands for
_PACKAGE_EXTRAS = {"": {"state_to_numpy", "state_from_numpy"}}
_RENAMED = {"checkerboard_sweeps_pallas": "checkerboard_sweeps"}


def _jax_all(path: Path):
    """The literal ``__all__`` of a JAX package file, read without
    importing it (None where it has none)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


def _port_module(rel: Path) -> str:
    """The port's module of a JAX file, ``ops/pallas`` as ``ops/kernels``."""
    parts = [p for p in rel.with_suffix("").parts if p != "__init__"]
    dotted = ".".join(parts).replace("ops.pallas", "ops.kernels")
    return "onmf_ontf_ndl_tpu_torch" + (f".{dotted}" if dotted else "")


_JAX_FILES = sorted(p.relative_to(_JAX) for p in _JAX.rglob("*.py"))


@pytest.mark.parametrize(
    "rel", [r for r in _JAX_FILES if r.name == "__init__.py"], ids=str)
def test_package_all_pins_the_jax_package(rel):
    """Each port package lists what its JAX package lists, plus the named
    extras, and has each name: a missing re-export fails here."""
    want = _jax_all(_JAX / rel)
    mod = importlib.import_module(_port_module(rel))
    if want is None:
        assert not hasattr(mod, "__all__")
        return
    extras = _PACKAGE_EXTRAS.get(str(rel.parent).strip("."), set())
    assert set(mod.__all__) == {_RENAMED.get(n, n) for n in want} | extras
    for name in mod.__all__:
        assert hasattr(mod, name), name


@pytest.mark.parametrize(
    "rel", [r for r in _JAX_FILES if r.name != "__init__.py"
            and _jax_all(_JAX / r) is not None], ids=str)
def test_module_all_holds_every_jax_name(rel):
    mod = importlib.import_module(_port_module(rel))
    names = {_RENAMED.get(n, n) for n in _jax_all(_JAX / rel)}
    assert names <= set(mod.__all__), names - set(mod.__all__)
    for name in mod.__all__:
        assert hasattr(mod, name), name

"""The port's surfaces against the JAX package's: configs, viz, debug,
profiling and the CLI (CPU, matplotlib's Agg backend).

- The config dataclasses have the JAX fields, types and defaults, plus
  ``device``.
- ``_grid_dims`` and every viz function's figures: each axis shows the
  same array as the JAX function's on the same numpy input (the port's
  given a tensor); each writes its file. The display methods write theirs.
- ``check_state`` raises on the same bad states with the same text.
- ``debug_nans`` names the step at which a NaN enters; ``trace`` writes a
  trace; ``Throughput`` reports a rate.
- The CLI: each subcommand's flags are the JAX CLI's plus ``--device``;
  a tiny ``--device cpu`` run of each writes the JAX CLI's artifacts, and
  without matplotlib ``dict.npy`` in place of ``dict.png``.
"""

import dataclasses
import json
import re
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from onmf_ontf_ndl_tpu.models.state import OnmfState as JState
from onmf_ontf_ndl_tpu.utils import config as jcfg
from onmf_ontf_ndl_tpu.utils import debug as jdebug
from onmf_ontf_ndl_tpu.utils import viz as jviz
from onmf_ontf_ndl_tpu_torch.models.state import OnmfState, init_state
from onmf_ontf_ndl_tpu_torch.utils import config as tcfg
from onmf_ontf_ndl_tpu_torch.utils import debug as tdebug
from onmf_ontf_ndl_tpu_torch.utils import profiling
from onmf_ontf_ndl_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)

CONFIGS = ["ImageConfig", "TensorConfig", "IsingConfig", "NetworkConfig",
           "VideoConfig"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_match_jax_plus_device(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [(f.name, f.type, f.default) for f in tf[:-1]] == \
        [(f.name, f.type, f.default) for f in jf]
    assert (tf[-1].name, tf[-1].type, tf[-1].default) == \
        ("device", "str", "cuda")
    assert getattr(tcfg, name).__dataclass_params__.frozen


def test_grid_dims_match_jax():
    for r in range(1, 131):
        assert tviz._grid_dims(r) == jviz._grid_dims(r)
    assert tviz._grid_dims(7, (2, 4)) == jviz._grid_dims(7, (2, 4))


@pytest.fixture
def shown(monkeypatch):
    """The arrays of every figure closed: per axis, its images' arrays and
    its lines' data."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    figures = []
    close = plt.close

    def record(fig=None):
        figures.append([
            ([np.asarray(im.get_array()) for im in ax.get_images()],
             [np.asarray(line.get_xydata()) for line in ax.get_lines()])
            for ax in fig.axes])
        close(fig)

    monkeypatch.setattr(plt, "close", record)
    return figures


def _viz_cases():
    rng = np.random.default_rng(0)
    k = 3
    Wc, Wg = rng.random((3 * k * k, 7)), rng.random((k * k, 5))
    return {
        "show_array": ((rng.random((6, 5)),), dict(cmap="gray")),
        "display_dictionary": ((Wc, k), dict(grid_shape=(2, 4))),
        "display_dictionary_grey": ((Wg, k), dict(is_color=False)),
        "display_network_dictionary": ((Wg, k), dict(title="motifs")),
        "display_recons_panel": (
            ([Wc, Wg], [rng.random((8, 8, 3)), rng.random((8, 8))],
             [rng.random((8, 8, 3)), rng.random((8, 8, 3))], k),
            dict(title="panel")),
        "display_second_dictionary": ((rng.random((3, 5)), k), {}),
        "display_errors_comparison": (
            ({"a": rng.random(6), "b": rng.random(4)},),
            dict(total_updates=500.0, normalize=40.0, xlabel="x",
                 ylabel="y")),
        "display_dictionary_color_combine": ((Wg, rng.random((3, 5)), k),
                                             {}),
    }


def _to_torch(x):
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x)
    if isinstance(x, list):
        return [_to_torch(v) for v in x]
    if isinstance(x, dict):
        return {key: _to_torch(v) for key, v in x.items()}
    return x


@pytest.mark.parametrize("case", list(_viz_cases()))
def test_viz_shows_what_jax_shows(case, shown, tmp_path):
    args, kw = _viz_cases()[case]
    fn = case.replace("_grey", "")
    path = str(tmp_path / f"{case}.png")
    assert getattr(tviz, fn)(*_to_torch(list(args)), save_path=path,
                             **kw) == path
    assert (tmp_path / f"{case}.png").stat().st_size > 0
    getattr(jviz, fn)(*args, **kw)
    got, want = shown
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert len(gi) == len(wi) and len(gl) == len(wl)
        for g, w in zip(gi + gl, wi + wl):
            np.testing.assert_array_equal(g, w)


def test_display_methods_write_their_files(tmp_path):
    from onmf_ontf_ndl_tpu_torch.apps.image import ImageReconstructor
    from onmf_ontf_ndl_tpu_torch.apps.image_tensor import (
        ImageReconstructorTensor)
    from onmf_ontf_ndl_tpu_torch.apps.ising import display_errors
    from onmf_ontf_ndl_tpu_torch.apps.network import NetworkReconstructor

    img = np.random.default_rng(1).random((12, 12, 3))
    ring = np.roll(np.eye(6), 1, axis=1)
    np.save(tmp_path / "errors.npy", np.linspace(2.0, 1.0, 5))
    paths = [
        ImageReconstructor(data=img, n_components=4, patch_size=3,
                           device="cpu").display_dictionary(
            save_path=str(tmp_path / "image.png")),
        ImageReconstructorTensor(data=img, n_components=4, patch_size=3,
                                 device="cpu").display_second_dictionary(
            torch.rand(3, 4), save_path=str(tmp_path / "second.png")),
        NetworkReconstructor(adjacency=ring + ring.T, n_components=4, k1=0,
                             k2=2, device="cpu").display_dict(
            title="ring", save_filename=str(tmp_path / "net.png")),
        display_errors({"file": str(tmp_path / "errors.npy"),
                        "tensor": torch.linspace(3.0, 1.0, 7)},
                       save_path=str(tmp_path / "errors.png")),
    ]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _bad_states():
    rng = np.random.default_rng(2)
    d, r = 6, 3
    W = rng.random((d, r))
    W /= np.linalg.norm(W, axis=0)
    A = rng.random((r, r))
    A = A + A.T
    B = rng.random((r, d))

    def with_(**kw):
        base = dict(W=W, A=A, B=B, C=np.zeros((0, 0)), t=3.0)
        base.update(kw)
        return base

    nanB = B.copy()
    nanB[0, 1] = np.nan
    asym = A.copy()
    asym[0, 1] += 1.0
    negd = A.copy()
    negd[1, 1] = -1.0
    infA = A.copy()
    infA[0, 2] = infA[2, 0] = np.inf
    nanW = W.copy()
    nanW[2, 0] = np.nan
    return [with_(), with_(W=-W), with_(B=nanB), with_(W=2 * W),
            with_(A=asym), with_(A=negd), with_(A=infA), with_(W=nanW),
            with_(t=np.nan), with_(C=np.full((d, d), np.inf)),
            with_(W=-2 * W, A=negd, B=nanB)]


@pytest.mark.parametrize("case", range(11))
def test_check_state_matches_jax(case):
    s = _bad_states()[case]
    jst = JState(W=jnp.asarray(s["W"]), A=jnp.asarray(s["A"]),
                 B=jnp.asarray(s["B"]), C=jnp.asarray(s["C"]),
                 t=jnp.asarray(s["t"]), key=jax.random.key(0))
    tst = OnmfState(W=torch.as_tensor(s["W"]), A=torch.as_tensor(s["A"]),
                    B=torch.as_tensor(s["B"]), C=torch.as_tensor(s["C"]),
                    t=float(s["t"]), gen=torch.Generator())
    try:
        jdebug.check_state(jst, name="st")
        want = None
    except FloatingPointError as e:
        want = str(e)
    try:
        tdebug.check_state(tst, name="st")
        got = None
    except FloatingPointError as e:
        got = str(e)
    assert got == want
    assert (want is None) == (case == 0)


def test_debug_nans_names_the_step():
    from onmf_ontf_ndl_tpu_torch.models import onmf
    from onmf_ontf_ndl_tpu_torch.models.onmf import train_dict

    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.random((8, 20)))
    draws = [(None, torch.as_tensor(rng.random((3, 20)))) for _ in range(5)]
    draws[2][1][1, 4] = np.nan              # enters at the third step, t = 3

    def run():
        st = init_state(0, 8, 3, device="cpu", dtype=torch.float64)
        return train_dict(st, X, iterations=6, batch_size=20,
                          stopping_diff=None, draws=draws)

    st, _ = run()                           # off: the NaN passes silently
    assert not torch.isfinite(st.W).all()
    # the stale update takes the pre-step aggregates: W turns at step 4
    with pytest.raises(FloatingPointError, match=r"^step t=3: non-finite "
                                                 r"code, A, B$"):
        with tdebug.debug_nans():
            run()
    assert onmf._DEBUG_NANS is False        # restored on the way out
    with tdebug.debug_nans(False):
        run()


def test_trace_and_throughput(tmp_path):
    X = torch.rand(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (X @ X).sum()
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1 and json.loads(files[0].read_text())
    assert prof.key_averages()
    tp = profiling.Throughput()
    st = init_state(0, 8, 3, device="cpu")
    with tp.measure(items=1000):
        Y = X @ X
        assert tp.fence((Y, st, {"x": [Y]})) is not None
    assert tp.items_per_sec > 0 and tp.elapsed > 0


def _flags(main, cmd, capsys):
    with pytest.raises(SystemExit) as e:
        main([cmd, "--help"])
    assert e.value.code == 0
    return set(re.findall(r"--[a-z0-9-]+", capsys.readouterr().out))


@pytest.mark.parametrize("cmd", ["image", "tensor", "ising", "network",
                                 "video"])
def test_cli_flags_are_jax_flags_plus_device(cmd, capsys):
    from onmf_ontf_ndl_tpu import cli as jcli
    from onmf_ontf_ndl_tpu_torch import cli as tcli

    # the JAX CLI points jax's compilation cache at the home directory
    # before it parses: put this process's settings back afterwards
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    try:
        want = _flags(jcli.main, cmd, capsys)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
    assert _flags(tcli.main, cmd, capsys) == want | {"--device"}


def _cli_inputs(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    img = tmp_path / "img.png"
    Image.fromarray((rng.random((16, 16, 3)) * 255).astype(np.uint8)).save(img)
    gif = tmp_path / "clip.gif"
    frames = [Image.fromarray((rng.random((10, 10, 3)) * 255).astype(
        np.uint8)) for _ in range(2)]
    frames[0].save(gif, save_all=True, append_images=frames[1:])
    edges = tmp_path / "edges.txt"
    ring = np.stack([np.arange(12), (np.arange(12) + 1) % 12], axis=1)
    chords = np.stack([np.arange(0, 12, 3), (np.arange(0, 12, 3) + 5) % 12],
                      axis=1)
    np.savetxt(edges, np.concatenate([ring, chords]), fmt="%d", delimiter=",")
    small = ["--n-components", "2", "--device", "cpu"]
    return {
        "image": (["--path", str(img), "--iterations", "2", "--patch-size",
                   "3", "--num-patches", "8", "--recons-resolution", "4"]
                  + small, {"dict.png", "recons.npy", "state.npz"}),
        "tensor": (["--path", str(img), "--iterations", "2",
                    "--sub-iterations", "2", "--patch-size", "3",
                    "--num-patches", "6", "--batch-size", "6",
                    "--block-iterations", "1"] + small,
                   {"dict.png", "state.npz"}),
        "ising": (["--lattice-size", "8", "--ising-iterations", "1",
                   "--ising-subsampling-steps", "64", "--sub-iterations",
                   "2", "--num-patches", "6", "--batch-size", "3",
                   "--patch-size", "4"] + small,
                  {"dict.png", "dict_stack.npy", "errors.npy", "state.npz"}),
        "network": (["--source", str(edges), "--k2", "2",
                     "--mcmc-iterations", "2", "--sub-iterations", "2",
                     "--sample-size", "6", "--recons-iter", "40"] + small,
                    {"dict.png", "state.npz", "recons_adj.npy"}),
        "video": (["--path", str(gif), "--patch-size", "3", "--num-patches",
                   "6", "--sub-iterations", "2"] + small,
                  {"dict.png", "state.npz"}),
    }


@pytest.mark.parametrize("matplotlib_present", [True, False])
@pytest.mark.parametrize("cmd", ["image", "tensor", "ising", "network",
                                 "video"])
def test_cli_run_writes_jax_artifacts(cmd, matplotlib_present, tmp_path,
                                      monkeypatch, capsys):
    from onmf_ontf_ndl_tpu_torch import cli

    if not matplotlib_present:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    args, artifacts = _cli_inputs(tmp_path)[cmd]
    out = tmp_path / "out"
    assert cli.main(["--out-dir", str(out), cmd] + args) == 0
    meta = json.loads((out / "run.json").read_text())
    if not matplotlib_present:
        artifacts = artifacts - {"dict.png"} | {"dict.npy"}
        assert meta["dict_png"] == "matplotlib not installed"
        assert "matplotlib not installed" in capsys.readouterr().err
        assert np.load(out / "dict.npy").ndim == 2
    else:
        assert "dict_png" not in meta
    assert set(p.name for p in out.iterdir()) == artifacts | {"run.json"}
    assert meta["cmd"] == cmd and meta["config"]["device"] == "cpu"
    if cmd == "network":
        assert 0.0 <= meta["recons_accuracy"] <= 1.0

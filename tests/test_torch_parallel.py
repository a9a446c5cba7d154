"""The port's data-parallel layer (parallel/) on gloo ranks spawned by the
test, against the JAX functions on the virtual CPU mesh of
tests/conftest.py and against the one-process port on the concatenated
batch, in float64.

Each world size (2 and 4 ranks) spawns once: one process per rank joins a
gloo group (``parallel/multihost.py``), runs every check on inputs the
test wrote, and saves its outputs; the tests compare them.

- ``dp_onmf_step``, fixed sweeps and the shard-local stop: equal to the
  JAX ``dp_onmf_step`` on a 2- or 4-device mesh at rtol 1e-9 (the golden
  tolerance of tests/test_onmf.py); with ``H0`` drawn, equal to the
  one-process step.
- ``dp_train_dict``, ``dp_ising_learning``, ``dp_ndl_train``,
  ``dp_reconstruct_network_sparse`` on injected per-rank draws: equal to
  the one-process run on the concatenated batch at rtol 1e-10 (sums over
  ranks add in another order; counts and keys exactly).
- ``merge_recon_shards``: equal to the JAX function on the same shards,
  exactly.
- ``sharded_checkerboard_sweeps``: equal to ``checkerboard_sweeps_plain``
  site for site, for n / 2 a multiple of 4 and not; the JAX sharded
  sampler's physics check (tests/test_parallel.py) holds.
- The replicas stay equal; ``shard_state`` replicates rank 0's state;
  ``multihost`` reports rank and count; the CLI with ``--distributed``
  writes rank 1's artifacts under ``proc1/``.
- Two axes: each world also builds the named mesh ``{"dp": world / 2,
  "tp": 2}`` (``multihost.global_mesh``). ``shard_state(..., tp_axis=)``
  puts on each rank the W columns and B rows that JAX puts on the device
  at the same mesh coordinate, exactly; ``auto_train_dict`` on the JAX
  key's draws equals JAX's ``auto_train_dict`` on the JAX mesh of the same
  shape (state rtol 1e-8, code rtol 1e-8 / atol 1e-12, as
  tests/test_torch_onmf.py holds ``train_dict``) and the port's
  one-process ``train_dict`` at rtol 1e-12 (tests/test_parallel.py's
  tolerance for JAX's), at fixed sweeps and with the 0.01 stop, on a batch
  of 16 (one tile: the first dp rank codes no column) and of 300 (tiles
  dealt 128 / 172 over dp = 2).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from onmf_ontf_ndl_tpu.models.state import init_state as jinit_state
from onmf_ontf_ndl_tpu.parallel import auto as jauto
from onmf_ontf_ndl_tpu.parallel import dp as jdp
from onmf_ontf_ndl_tpu.parallel.mesh import make_mesh as jmake_mesh
from onmf_ontf_ndl_tpu_torch.apps import network as tnet
from onmf_ontf_ndl_tpu_torch.apps.ising import ising_trajectory_learning
from onmf_ontf_ndl_tpu_torch.data.graphs import graph_from_adjacency
from onmf_ontf_ndl_tpu_torch.models.onmf import onmf_step, train_dict
from onmf_ontf_ndl_tpu_torch.models.state import init_state, state_from_numpy
from onmf_ontf_ndl_tpu_torch.ops.kernels.ising_kernel import (
    checkerboard_sweeps_plain)
from onmf_ontf_ndl_tpu_torch.parallel.dp import merge_recon_shards
from onmf_ontf_ndl_tpu_torch.samplers.motif import path_adj
from test_torch_onmf import assert_state_close, replay_draws

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
SIZES = dict(d=12, r=4, m=8, steps=3, b=5, L=12, k=4, R=3, num=6,
             rounds=3, inner=3, S=8, M=10, N=10, ring_r=3)
# the two-axis runs: a (d, TP_N) batch pool, rank r split over tp = 2,
# TP_ITERS iterations on global batches of TP_BATCHES columns
TP_N, TP_ITERS, TP_BATCHES, TP_SEED = 200, 4, (16, 300), 7
TP_MODES = {"fixed": None, "stop": 0.01}

WORKER = r"""
import sys

import numpy as np
import torch

torch.set_num_threads(1)
rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                             sys.argv[4])
from onmf_ontf_ndl_tpu_torch.data.graphs import graph_from_adjacency
from onmf_ontf_ndl_tpu_torch.models.state import init_state, state_from_numpy
from onmf_ontf_ndl_tpu_torch.parallel import auto, dp, ising_sharded, multihost
from onmf_ontf_ndl_tpu_torch.samplers.motif import path_adj

multihost.initialize(coordinator_address="127.0.0.1:" + port,
                     num_processes=world, process_id=rank, device="cpu")
inp = dict(np.load(outdir + "/inputs.npz"))
F64 = torch.float64
out = {"count": multihost.process_count(), "index": multihost.process_index(),
       "backend": str(torch.distributed.get_backend())}


def state(W, track=False, seed=0):
    d, r = W.shape
    return state_from_numpy(W, np.zeros((r, r)), np.zeros((r, d)),
                            np.zeros((d, d)) if track else None, 0.0,
                            seed=seed, device="cpu", dtype=F64)


def t(a):
    return torch.as_tensor(a)


for mode, sd in (("fixed", None), ("stop", 0.01)):
    st, H = dp.dp_onmf_step(state(inp["step_W"]), inp["step_X"], t=2.0,
                            H0=inp["step_H0"], alpha=0.4, beta=0.9,
                            stopping_diff=sd, device="cpu")
    out.update({f"step_{mode}_{f}": getattr(st, f).numpy()
                for f in ("W", "A", "B")}, **{f"step_{mode}_H": H.numpy()})
st, H = dp.dp_onmf_step(state(inp["step_W"]), inp["step_X"], device="cpu")
out.update(drawn_W=st.W.numpy(), drawn_H=H.numpy())

draws = [(t(i), t(h)) for i, h in zip(inp["train_idx"][rank],
                                       inp["train_H0"][rank])]
st = dp.dp_train_dict(state(inp["train_W"]), inp["train_X"],
                      iterations=len(draws) + 1,
                      batch_size_per_device=inp["train_idx"].shape[2],
                      draws=draws, device="cpu")
out.update(train_W=st.W.numpy(), train_A=st.A.numpy(), train_B=st.B.numpy(),
           train_t=st.t)
for sampling in ("iid", "block"):
    st = dp.dp_train_dict(state(inp["train_W"]), inp["train_X"],
                          iterations=4, batch_size_per_device=4,
                          sampling=sampling, stopping_diff=0.01,
                          device="cpu")
    out[f"replica_{sampling}_W"] = st.W.numpy()
    out[f"replica_{sampling}_A"] = st.A.numpy()

draws = [((t(a[rank]), t(b[rank])), [(None, t(h[rank])) for h in hs])
         for a, b, hs in zip(inp["ising_a"], inp["ising_b"], inp["ising_H0"])]
st, stack, errors, lat = dp.dp_ising_learning(
    state(inp["ising_W"], track=True), inp["ising_lattices"],
    torch.Generator().manual_seed(1), ising_iterations=len(draws) - 1,
    nsteps=1, num_patches_per_device=inp["ising_a"].shape[2],
    inner_iterations=inp["ising_H0"].shape[1] + 1, batch_size=3,
    patch_size=int(inp["ising_k"]), update_lattice=False,
    use_stopping=False, draws=draws, device="cpu")
out.update(ising_stack=stack.numpy(), ising_errors=errors.numpy(),
           ising_C=st.C.numpy(), ising_lattice=lat.numpy())
st, _, _, lat = dp.dp_ising_learning(
    state(inp["ising_W"], track=True), inp["ising_lattices"],
    torch.Generator().manual_seed(1), ising_iterations=2, nsteps=1,
    num_patches_per_device=6, inner_iterations=3, batch_size=3,
    patch_size=int(inp["ising_k"]), device="cpu")
out.update(ising_drawn_W=st.W.numpy(), ising_drawn_lattice=lat.numpy())

g = graph_from_adjacency(inp["ring"], device="cpu")
B = path_adj(0, 2)
draws = [(t(X[rank]), [(None, t(h[rank])) for h in hs])
         for X, hs in zip(inp["ndl_X"], inp["ndl_H0"])]
st, code, emb = dp.dp_ndl_train(
    state(inp["ndl_W"]), g, inp["ndl_emb0"], B,
    mcmc_iterations=len(draws), sample_size_per_device=inp["ndl_X"].shape[3],
    inner_iterations=inp["ndl_H0"].shape[1] + 1, batch_size=4,
    use_stopping=False, draws=draws, device="cpu")
out.update(ndl_W=st.W.numpy(), ndl_A=st.A.numpy(), ndl_code=code.numpy(),
           ndl_emb=emb.numpy())

W = t(inp["recon_W"])
gen = torch.Generator().manual_seed(2)
res = dp.dp_reconstruct_network_sparse(
    W, g, gen, B, recons_iter_per_device=inp["recon_embs"].shape[1],
    embs=t(inp["recon_embs"][rank]), H0=t(inp["recon_H0"][rank]),
    device="cpu")
pi, pj, mean, cnt = dp.merge_recon_shards(*res, n=g.num_nodes)
out.update(recon_pi=pi.numpy(), recon_pj=pj.numpy(), recon_mean=mean.numpy(),
           recon_cnt=cnt.numpy())
out["recon_edges"] = dp.dp_recons_edges(
    W, g, gen, B, recons_iter_per_device=inp["recon_embs"].shape[1],
    embs=t(inp["recon_embs"][rank]), H0=t(inp["recon_H0"][rank]),
    device="cpu")

for n in (16, 12):
    lat = inp[f"lattice_{n}"]
    rows = n // world
    out[f"band_{n}"] = ising_sharded.sharded_checkerboard_sweeps(
        11, lat[rank * rows:(rank + 1) * rows], 4, J=1.0, H=0.1, T=2.3,
        device="cpu").numpy()
lat = inp["lattice_32"]
rows = 32 // world
out["band_physics"] = ising_sharded.sharded_checkerboard_sweeps(
    4, lat[rank * rows:(rank + 1) * rows], 300, T=1.5, device="cpu").numpy()

st = dp.dp_train_image_dict(
    state(inp["ising_W"]), inp["image"], outer_iterations=3,
    num_patches_per_device=10, inner_iterations=3, batch_size_per_device=5,
    patch_size=int(inp["ising_k"]), device="cpu")
out.update(image_W=st.W.numpy(), image_t=st.t)
st = dp.dp_train_tensor_dict(
    state(inp["tensor_W"]), inp["tensor_X"], mode=0, iterations=3,
    batch_size_per_device=8, sub_iterations=2, device="cpu")
out.update(tensor_W=st.W.numpy(), tensor_t=st.t)
own = init_state(rank, 6, 2, device="cpu", dtype=F64)
out["shard_state_W"] = auto.shard_state(own).W.numpy()
st, _ = auto.auto_train_dict(own, inp["train_X"][:6], iterations=3,
                             batch_size=4, device="cpu")
out["auto_W"] = st.W.numpy()

# two axes: dp over world / 2 ranks, the dictionary over tp = 2
mesh = multihost.global_mesh({"dp": world // 2, "tp": 2})
out["tp_coord"] = np.array([mesh.coordinate("dp"), mesh.coordinate("tp")])
r = inp["tp_W"].shape[1]
tp_state = state_from_numpy(inp["tp_W"], np.zeros((r, r)), inp["tp_B"],
                            None, 0.0, seed=3, device="cpu", dtype=F64)
st = auto.shard_state(tp_state, mesh, tp_axis="tp")
out.update(tp_W=st.W.numpy(), tp_B=st.B.numpy())
try:
    auto.shard_state(state(inp["tp_W"][:, :3]), mesh, tp_axis="tp")
    out["tp_odd_error"] = "no error"
except ValueError as e:
    out["tp_odd_error"] = str(e)


def tp_save(name, st, code):
    full = auto.unshard_state(st)
    out.update({f"{name}_{f}": getattr(full, f).numpy() for f in "WABC"})
    out.update({f"{name}_code": code.numpy(), f"{name}_t": st.t,
                f"{name}_shard": st.W.numpy()})


for b in (16, 300):
    draws = [(t(i), t(h)) for i, h in zip(inp[f"tp_idx_{b}"],
                                          inp[f"tp_H0_{b}"])]
    for mode, sd in (("fixed", None), ("stop", 0.01)):
        tp_save(f"tp_{b}_{mode}", *auto.auto_train_dict(
            tp_state, inp["tp_X"], mesh=mesh, dp_axis="dp", tp_axis="tp",
            iterations=len(draws) + 1, batch_size=b, stopping_diff=sd,
            draws=draws, device="cpu"))
# drawn from the replicated generator: one global batch a step
tp_save("tp_drawn", *auto.auto_train_dict(
    tp_state, inp["tp_X"], mesh=mesh, tp_axis="tp", iterations=4,
    batch_size=300, device="cpu"))

if world == 2:
    from onmf_ontf_ndl_tpu_torch import cli

    cli.main(["--distributed", "--coordinator-address", "127.0.0.1:" + port,
              "--num-processes", "2", "--process-id", str(rank),
              "--out-dir", outdir + "/cli", "ising", "--device", "cpu",
              "--n-components", "2", "--lattice-size", "8",
              "--ising-iterations", "1", "--ising-subsampling-steps", "64",
              "--sub-iterations", "2", "--num-patches", "6",
              "--batch-size", "3", "--patch-size", "4"])
np.savez(f"{outdir}/rank{rank}.npz", **out)
multihost.shutdown()
print("RANK_OK", rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(world: int) -> dict:
    z = SIZES
    rng = np.random.default_rng(100 + world)
    d, r, m, L, k, R, num = z["d"], z["r"], z["m"], z["L"], z["k"], z["R"], z["num"]
    ring = np.roll(np.eye(z["N"]), 1, axis=1)
    return dict(
        step_W=rng.random((d, r)), step_X=rng.random((d, world * m)),
        step_H0=rng.random((r, world * m)),
        train_W=rng.random((d, r)), train_X=rng.random((d, world * m)),
        train_idx=rng.integers(0, m, (world, z["steps"], z["b"])),
        train_H0=rng.random((world, z["steps"], r, z["b"])),
        ising_W=rng.random((k * k, R)), ising_k=k,
        ising_lattices=rng.choice(np.array([1, -1], np.int8),
                                  (world, L, L)),
        ising_a=rng.integers(0, L - k + 1, (z["rounds"], world, num)),
        ising_b=rng.integers(0, L - k + 1, (z["rounds"], world, num)),
        ising_H0=rng.random((z["rounds"], z["inner"] - 1, world, R, num)),
        ndl_W=rng.random((9, R)), ring=ring + ring.T,
        ndl_X=(rng.random((2, world, 9, z["S"])) < 0.4).astype(np.float64),
        ndl_H0=rng.random((2, z["inner"] - 1, world, R, z["S"])),
        ndl_emb0=np.stack([np.arange(3) + i for i in range(world)]),
        recon_W=rng.random((9, R)),
        recon_embs=rng.integers(0, z["N"], (world, z["M"], 3)),
        recon_H0=rng.random((world, R, z["M"])),
        lattice_16=rng.choice(np.array([1, -1], np.int8), (16, 16)),
        lattice_12=rng.choice(np.array([1, -1], np.int8), (12, 12)),
        lattice_32=rng.choice(np.array([1, -1], np.int8), (32, 32)),
        image=rng.random((24, 24)),
        tensor_W=rng.random((4, 2)), tensor_X=rng.random((4, 4, 3, 8)),
        tp_W=rng.random((d, r)), tp_B=rng.random((r, d)),
        tp_X=rng.random((d, TP_N)),
        **_tp_draws(d, r),
    )


def _tp_jax_state(inp, r=None):
    W = inp["tp_W"] if r is None else inp["tp_W"][:, :r]
    d, r = W.shape
    return jinit_state(jax.random.key(TP_SEED), d, r, dtype=jnp.float64,
                       W=W, B=inp["tp_B"][:r])


def _tp_draws(d, r):
    """The JAX key's draws (idx, H0) of each two-axis batch size."""
    key = jinit_state(jax.random.key(TP_SEED), d, r, dtype=jnp.float64).key
    out = {}
    for b in TP_BATCHES:
        draws = replay_draws(key, TP_N, r, TP_ITERS, b, True)
        out[f"tp_idx_{b}"] = np.stack([i.numpy() for i, _ in draws])
        out[f"tp_H0_{b}"] = np.stack([h.numpy() for _, h in draws])
    return out


_RUNS = {}


def run_world(world: int, tmp_path_factory):
    """Spawn ``world`` gloo ranks once; returns (inputs, per-rank outputs,
    the run's directory)."""
    if world not in _RUNS:
        outdir = tmp_path_factory.mktemp(f"dp{world}")
        inp = _inputs(world)
        np.savez(outdir / "inputs.npz", **inp)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(world), port,
             str(outdir)], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for rank in range(world)]
        logs = [p.communicate(timeout=240) for p in procs]
        for rank, (p, (so, se)) in enumerate(zip(procs, logs)):
            assert p.returncode == 0 and f"RANK_OK {rank}" in so, se[-3000:]
        outs = [dict(np.load(outdir / f"rank{rank}.npz"))
                for rank in range(world)]
        _RUNS[world] = (inp, outs, outdir)
    return _RUNS[world]


def _state(W, track=False, seed=0):
    d, r = W.shape
    return state_from_numpy(W, np.zeros((r, r)), np.zeros((r, d)),
                            np.zeros((d, d)) if track else None, 0.0,
                            seed=seed, device="cpu", dtype=F64)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["fixed", "stop"])
def test_dp_onmf_step_matches_jax_mesh(world, mode, tmp_path_factory):
    inp, outs, _ = run_world(world, tmp_path_factory)
    mesh = jmake_mesh({"dp": world}, jax.devices()[:world])
    d, r = inp["step_W"].shape
    st = jinit_state(jax.random.key(0), d, r, dtype=jnp.float64,
                     W=inp["step_W"])
    st1, H = jdp.dp_onmf_step(
        mesh, st, jnp.asarray(inp["step_X"]), t=2.0,
        H0=jnp.asarray(inp["step_H0"]), alpha=0.4, beta=0.9,
        stopping_diff=None if mode == "fixed" else 0.01)
    got_H = np.concatenate([o[f"step_{mode}_H"] for o in outs], axis=1)
    np.testing.assert_allclose(got_H, np.asarray(H), rtol=1e-9)
    for o in outs:
        for f in ("W", "A", "B"):
            np.testing.assert_allclose(o[f"step_{mode}_{f}"],
                                       np.asarray(getattr(st1, f)),
                                       rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_onmf_step_draws_h0_alike(world, tmp_path_factory):
    # H0 drawn from the state's generator, the same draw on every rank:
    # the step equals the one-process step from the same state
    inp, outs, _ = run_world(world, tmp_path_factory)
    st, H = onmf_step(_state(inp["step_W"]),
                      torch.as_tensor(inp["step_X"]), stopping_diff=None)
    got_H = np.concatenate([o["drawn_H"] for o in outs], axis=1)
    np.testing.assert_allclose(got_H, H.numpy(), rtol=1e-10)
    for o in outs:
        np.testing.assert_allclose(o["drawn_W"], st.W.numpy(), rtol=1e-10)


def test_merge_recon_shards_matches_jax():
    rng = np.random.default_rng(3)
    n, ndev, per = 37, 4, 50
    blocks, counts = [], []
    for dev in range(ndev):
        c = int(rng.integers(0, per))
        keys = np.sort(rng.choice(n * n, c, replace=False))
        pad = per - c
        blocks.append((np.concatenate([keys // n, np.zeros(pad, int)]),
                       np.concatenate([keys % n, np.zeros(pad, int)]),
                       np.concatenate([rng.random(c), np.zeros(pad)]),
                       np.concatenate([rng.integers(1, 9, c).astype(float),
                                       np.zeros(pad)])))
        counts.append(c)
    arrays = [np.concatenate([b[i] for b in blocks]) for i in range(4)]
    arrays = [arrays[0].astype(np.int32), arrays[1].astype(np.int32),
              arrays[2].astype(np.float32), arrays[3].astype(np.float32)]
    mesh = jmake_mesh({"dp": ndev}, jax.devices()[:ndev])
    shard = NamedSharding(mesh, P("dp"))
    want = jdp.merge_recon_shards(
        *(jax.device_put(a, shard) for a in arrays),
        jax.device_put(np.asarray(counts, np.int32), shard), n)
    got = merge_recon_shards(*arrays, np.asarray(counts), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("world", [2, 4])
def test_dp_train_dict_equals_concatenated_batch(world, tmp_path_factory):
    inp, outs, _ = run_world(world, tmp_path_factory)
    m = inp["train_X"].shape[1] // world
    draws = [(torch.as_tensor(np.concatenate(
                  [inp["train_idx"][q, s] + q * m for q in range(world)])),
              torch.as_tensor(np.concatenate(
                  [inp["train_H0"][q, s] for q in range(world)], axis=1)))
             for s in range(inp["train_idx"].shape[1])]
    st, _ = train_dict(_state(inp["train_W"]),
                       torch.as_tensor(inp["train_X"]),
                       iterations=len(draws) + 1, batch_size=0,
                       stopping_diff=None, track_code=False, draws=draws)
    for o in outs:
        assert float(o["train_t"]) == st.t
        for f in ("W", "A", "B"):
            np.testing.assert_allclose(o[f"train_{f}"],
                                       getattr(st, f).numpy(), rtol=1e-10)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_replicas_stay_equal(world, tmp_path_factory):
    # the ranks draw their own batches (the rank generators), and every
    # rank's state stays bit for bit the same
    _, outs, _ = run_world(world, tmp_path_factory)
    for key in ("replica_iid_W", "replica_iid_A", "replica_block_W",
                "image_W", "tensor_W", "auto_W", "shard_state_W",
                "ising_drawn_W"):
        for o in outs[1:]:
            np.testing.assert_array_equal(o[key], outs[0][key])
    W = outs[0]["image_W"]
    assert (W >= 0).all() and (np.linalg.norm(W, axis=0) <= 1 + 1e-9).all()
    assert float(outs[0]["image_t"]) == 9.0
    assert float(outs[0]["tensor_t"]) == 3.0
    # shard_state took rank 0's own state
    np.testing.assert_array_equal(
        outs[0]["shard_state_W"],
        init_state(0, 6, 2, device="cpu", dtype=F64).W.numpy())
    # the Ising ranks advanced different lattices
    assert not np.array_equal(outs[0]["ising_drawn_lattice"],
                              outs[1]["ising_drawn_lattice"])


@pytest.mark.parametrize("world", [2, 4])
def test_dp_ising_learning_equals_concatenated_batch(world, tmp_path_factory):
    # each rank's patches come from its own lattice: side by side, the
    # lattices make one (L, world L) lattice whose patches at shifted
    # corners are the concatenated batch
    inp, outs, _ = run_world(world, tmp_path_factory)
    L = inp["ising_lattices"].shape[1]
    lattice = torch.as_tensor(np.concatenate(list(inp["ising_lattices"]),
                                             axis=1))
    draws = []
    for a, b, hs in zip(inp["ising_a"], inp["ising_b"], inp["ising_H0"]):
        corners = (torch.as_tensor(a.reshape(-1)), torch.as_tensor(
            (b + L * np.arange(world)[:, None]).reshape(-1)))
        draws.append((corners, [(None, torch.as_tensor(
            np.concatenate(list(h), axis=1))) for h in hs]))
    st, stack, errors, _, _ = ising_trajectory_learning(
        _state(inp["ising_W"], track=True), lattice, torch.Generator(),
        ising_iterations=len(draws) - 1, nsteps=1,
        num_patches=world * inp["ising_a"].shape[2],
        inner_iterations=inp["ising_H0"].shape[1] + 1, batch_size=3,
        patch_size=int(inp["ising_k"]), update_lattice=False,
        use_stopping=False, draws=draws)
    for rank, o in enumerate(outs):
        np.testing.assert_allclose(o["ising_stack"], stack.numpy(),
                                   rtol=1e-10)
        np.testing.assert_allclose(o["ising_errors"], errors.numpy(),
                                   rtol=1e-10)
        np.testing.assert_allclose(o["ising_C"], st.C.numpy(), rtol=1e-10)
        np.testing.assert_array_equal(o["ising_lattice"],
                                      inp["ising_lattices"][rank])


@pytest.mark.parametrize("world", [2, 4])
def test_dp_ndl_train_equals_concatenated_batch(world, tmp_path_factory):
    inp, outs, _ = run_world(world, tmp_path_factory)
    S = inp["ndl_X"].shape[3]
    draws = [(torch.as_tensor(np.concatenate(list(X), axis=1)),
              [(None, torch.as_tensor(np.concatenate(list(h), axis=1)))
               for h in hs]) for X, hs in zip(inp["ndl_X"], inp["ndl_H0"])]
    g = graph_from_adjacency(inp["ring"], device="cpu")
    st, code, _ = tnet.ndl_train(
        _state(inp["ndl_W"]), g, torch.arange(3), path_adj(0, 2),
        mcmc_iterations=len(draws), sample_size=world * S,
        inner_iterations=inp["ndl_H0"].shape[1] + 1, batch_size=4,
        use_stopping=False, draws=draws)
    for rank, o in enumerate(outs):
        np.testing.assert_allclose(o["ndl_W"], st.W.numpy(), rtol=1e-10)
        np.testing.assert_allclose(o["ndl_A"], st.A.numpy(), rtol=1e-10)
        np.testing.assert_allclose(
            o["ndl_code"], code[:, rank * S:(rank + 1) * S].numpy(),
            rtol=1e-10)
        np.testing.assert_array_equal(o["ndl_emb"], inp["ndl_emb0"][rank])


@pytest.mark.parametrize("world", [2, 4])
def test_dp_reconstruct_network_sparse_equals_concatenated_batch(
        world, tmp_path_factory):
    inp, outs, _ = run_world(world, tmp_path_factory)
    g = graph_from_adjacency(inp["ring"], device="cpu")
    kw = dict(recons_iter=world * inp["recon_embs"].shape[1],
              embs=torch.as_tensor(np.concatenate(list(inp["recon_embs"]))),
              H0=torch.as_tensor(np.concatenate(list(inp["recon_H0"]),
                                                axis=1)))
    W, B = torch.as_tensor(inp["recon_W"]), path_adj(0, 2)
    ii, jj, mean, cnt = tnet.reconstruct_network_sparse(W, g, None, B, **kw)
    edges = tnet._edges_from_sparse_result(*tnet.reconstruct_network_sparse(
        W, g, None, B, include_self=False, **kw))
    for o in outs:
        np.testing.assert_array_equal(o["recon_pi"], ii.numpy())
        np.testing.assert_array_equal(o["recon_pj"], jj.numpy())
        np.testing.assert_array_equal(o["recon_cnt"], cnt.numpy())
        np.testing.assert_allclose(o["recon_mean"], mean.numpy(),
                                   rtol=1e-10)
        np.testing.assert_array_equal(o["recon_edges"], edges)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("n", [16, 12])
def test_sharded_checkerboard_equals_plain_site_for_site(world, n,
                                                         tmp_path_factory):
    # n = 16: a Philox call serves four sites of one row; n = 12 (n / 2 =
    # 6): calls straddle rows, and bands start inside a call
    inp, outs, _ = run_world(world, tmp_path_factory)
    want = checkerboard_sweeps_plain(11, torch.as_tensor(inp[f"lattice_{n}"]),
                                     4, J=1.0, H=0.1, T=2.3).numpy()
    got = np.concatenate([o[f"band_{n}"] for o in outs])
    assert (want != inp[f"lattice_{n}"]).sum() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_checkerboard_physics(world, tmp_path_factory):
    # the JAX sharded sampler's check (tests/test_parallel.py): strong
    # local order below T_c after 300 sweeps at T = 1.5
    _, outs, _ = run_world(world, tmp_path_factory)
    s = np.concatenate([o["band_physics"] for o in outs]).astype(np.float32)
    assert np.mean(s * np.roll(s, 1, 0)) > 0.85
    assert set(np.unique(s)).issubset({-1.0, 1.0})


@pytest.mark.parametrize("world", [2, 4])
def test_multihost_reports_rank_and_count(world, tmp_path_factory):
    _, outs, _ = run_world(world, tmp_path_factory)
    assert [int(o["index"]) for o in outs] == list(range(world))
    assert all(int(o["count"]) == world for o in outs)
    assert all(str(o["backend"]) == "gloo" for o in outs)


def test_cli_distributed_writes_rank_one_apart(tmp_path_factory):
    import json

    _, _, outdir = run_world(2, tmp_path_factory)
    for sub in ("cli", "cli/proc1"):
        files = sorted(os.listdir(outdir / sub))
        assert {"run.json", "state.npz", "errors.npy",
                "dict_stack.npy"} <= set(files), files
        meta = json.loads((outdir / sub / "run.json").read_text())
        assert meta["cmd"] == "ising" and meta["config"]["device"] == "cpu"
    assert not os.path.exists(outdir / "cli" / "proc0")


def _saved_state(o, name):
    return state_from_numpy(o[f"{name}_W"], o[f"{name}_A"], o[f"{name}_B"],
                            o[f"{name}_C"], float(o[f"{name}_t"]),
                            device="cpu", dtype=F64)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_state_puts_the_jax_shard_on_each_rank(world, tmp_path_factory):
    # rank i sits where JAX's device i sits in a row-major mesh: at
    # (i // 2, i % 2) of {"dp": world / 2, "tp": 2}, with the columns of
    # its tp coordinate
    inp, outs, _ = run_world(world, tmp_path_factory)
    devices = jax.devices()[:world]
    mesh = jmake_mesh({"dp": world // 2, "tp": 2}, devices)
    js = jauto.shard_state(mesh, _tp_jax_state(inp), tp_axis="tp")
    for name in ("W", "B"):
        shards = getattr(js, name).addressable_shards
        assert len(shards) == world
        for shard in shards:
            np.testing.assert_array_equal(
                outs[devices.index(shard.device)][f"tp_{name}"],
                np.asarray(shard.data))
    r_l = inp["tp_W"].shape[1] // 2
    for rank, o in enumerate(outs):
        assert tuple(o["tp_coord"]) == (rank // 2, rank % 2)
        cols = slice(rank % 2 * r_l, (rank % 2 + 1) * r_l)
        np.testing.assert_array_equal(o["tp_W"], inp["tp_W"][:, cols])
        np.testing.assert_array_equal(o["tp_B"], inp["tp_B"][cols])


@pytest.mark.parametrize("world", [2, 4])
def test_shard_state_rejects_columns_that_do_not_divide(world,
                                                        tmp_path_factory):
    inp, outs, _ = run_world(world, tmp_path_factory)
    for o in outs:
        assert "should be divisible by 2" in str(o["tp_odd_error"])
    mesh = jmake_mesh({"dp": world // 2, "tp": 2}, jax.devices()[:world])
    with pytest.raises(ValueError, match="divisible by 2"):
        jauto.shard_state(mesh, _tp_jax_state(inp, r=3), tp_axis="tp")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", sorted(TP_MODES))
def test_auto_train_dict_matches_jax_on_the_same_mesh(world, mode,
                                                      tmp_path_factory):
    inp, outs, _ = run_world(world, tmp_path_factory)
    mesh = jmake_mesh({"dp": world // 2, "tp": 2}, jax.devices()[:world])
    b = TP_BATCHES[-1]
    js, jcode = jauto.auto_train_dict(
        mesh, _tp_jax_state(inp), jnp.asarray(inp["tp_X"]), dp_axis="dp",
        tp_axis="tp", iterations=TP_ITERS, batch_size=b,
        stopping_diff=TP_MODES[mode])
    for o in outs:
        assert_state_close(_saved_state(o, f"tp_{b}_{mode}"), js)
        np.testing.assert_allclose(o[f"tp_{b}_{mode}_code"],
                                   np.asarray(jcode), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", [f"{b}_{m}" for b in TP_BATCHES
                                  for m in sorted(TP_MODES)] + ["drawn"])
def test_auto_train_dict_equals_one_process_train_dict(world, case,
                                                       tmp_path_factory):
    inp, outs, _ = run_world(world, tmp_path_factory)
    r = inp["tp_W"].shape[1]
    st = state_from_numpy(inp["tp_W"], np.zeros((r, r)), inp["tp_B"], None,
                          0.0, seed=3, device="cpu", dtype=F64)
    X = torch.as_tensor(inp["tp_X"])
    if case == "drawn":             # train_dict's defaults, its generator
        want = train_dict(st, X, iterations=4, batch_size=300)
    else:
        b, mode = case.split("_")
        draws = [(torch.as_tensor(i), torch.as_tensor(h)) for i, h in
                 zip(inp[f"tp_idx_{b}"], inp[f"tp_H0_{b}"])]
        want = train_dict(st, X, iterations=len(draws) + 1,
                          batch_size=int(b), stopping_diff=TP_MODES[mode],
                          draws=draws)
    r_l = r // 2
    for rank, o in enumerate(outs):
        name = f"tp_{case}"
        assert float(o[f"{name}_t"]) == want[0].t
        for f in "WABC":
            np.testing.assert_allclose(o[f"{name}_{f}"],
                                       getattr(want[0], f).numpy(),
                                       rtol=1e-12, err_msg=f)
        np.testing.assert_allclose(o[f"{name}_code"], want[1].numpy(),
                                   rtol=1e-12)
        # the rank holds its tp coordinate's columns of the whole W
        np.testing.assert_array_equal(
            o[f"{name}_shard"],
            o[f"{name}_W"][:, rank % 2 * r_l:(rank % 2 + 1) * r_l])

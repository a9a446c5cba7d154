"""The apps' round function on static buffers (``models/onmf.py::
_run_rounds``) on the CPU: for each of the five apps it gives what the
per-round loop before it gave (each round a call of ``_train_loop``,
frozen below as it stood), bit for bit: W, A, B, C, the code, the chains,
the lattice, the dictionary stack, the errors and the generators' final
states; on the per-round route (the CPU's: the round's steps through
``_train_loop``) and on the captured route's code with an eager stand-in
for the CUDA graph (the first round run as ``capture_step`` runs it, a
replay a call of the round on the graph's own generators; the steps on
the buffers, their weights from the run's table). And the pure functions
of the captured route: the route, the round graph's key and the weight
table (at one round the training step's); the device-seed entry of the checkerboard sampler's plain version;
the cached index tables of ``pair_matrices_T``. Exact comparisons
throughout: the same operations on the same draws. The captured route on
a CUDA graph needs a card (tests/test_torch_cuda.py)."""

import contextlib

import dataclasses

import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu_torch.apps import image as timage
from onmf_ontf_ndl_tpu_torch.apps import image_tensor as ttensor
from onmf_ontf_ndl_tpu_torch.apps import ising as tising_app
from onmf_ontf_ndl_tpu_torch.apps import network as tnet
from onmf_ontf_ndl_tpu_torch.apps import video as tvideo
from onmf_ontf_ndl_tpu_torch.data import graphs as tg
from onmf_ontf_ndl_tpu_torch.models import onmf as tonmf
from onmf_ontf_ndl_tpu_torch.models.state import init_state
from onmf_ontf_ndl_tpu_torch.ops.kernels import ising_kernel as ik
from onmf_ontf_ndl_tpu_torch.ops.patches import (extract_patches,
                                                 random_patch_corners)
from onmf_ontf_ndl_tpu_torch.ops.unfold import unfold
from onmf_ontf_ndl_tpu_torch.samplers import motif as tm
from onmf_ontf_ndl_tpu_torch.samplers.ising import (checkerboard_sweeps,
                                                    init_lattice,
                                                    metropolis_chain)
from onmf_ontf_ndl_tpu_torch.utils import capture
from onmf_ontf_ndl_tpu_torch.utils.metrics import surrogate_error

torch.set_num_threads(1)

RNG = np.random.default_rng(15)
F64 = torch.float64
ROUTES = ("captured", "per_round")


class EagerGraph:
    """A stand-in for a captured round's CUDA graph on the CPU: a replay
    calls the round on the graph's own generators."""

    def __init__(self, step, owns):
        self.step, self.owns = step, owns

    def replay(self):
        self.step(*self.owns)


def eager_capture(step, gens, device, cache="step"):
    """``capture_step`` with an :class:`EagerGraph`: the first round run
    from ``gens``, nothing recorded, no launches."""
    owns = tuple(torch.Generator(device=device) for _ in gens)
    step(*gens)
    return EagerGraph(step, owns), owns, {}


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """Run ``_run_rounds`` on one route: "per_round" is the CPU's own;
    "captured" runs the captured route's code with
    :func:`eager_capture` in place of the graph cache's capture, on an
    empty cache."""
    name = request.param
    if name == "captured":
        graphs = tonmf._ROUND_GRAPHS
        monkeypatch.setattr(tonmf, "_round_route", lambda *a, **k: name)
        monkeypatch.setattr(capture, "capture_step", eager_capture)
        monkeypatch.setattr(tonmf, "_ROUND_GRAPHS", capture.GraphCache(
            graphs.name, graphs.size, graphs.spans))
        monkeypatch.setattr(torch.cuda, "device",
                            lambda dev: contextlib.nullcontext())
    return name


def assert_states_equal(got, want):
    for f in "WABC":
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.t == want.t
    assert torch.equal(got.gen.get_state(), want.gen.get_state())


def twin_states(d, r, dtype, track_xxt=False, seed=4):
    return [init_state(seed, d, r, device="cpu", dtype=dtype,
                       track_xxt=track_xxt) for _ in range(2)]


# ---------------------------------- the per-round loops as they stood
# (each round one _train_loop; the apps' code before the rounds' port)

def old_image(state, img, *, outer_iterations, num_patches, inner_iterations,
              batch_size, patch_size, alpha, beta, stop, subsample, coder):
    k = patch_size
    for _ in range(outer_iterations):
        corners = random_patch_corners(state.gen, img.shape[:2], k,
                                       num_patches, device=img.device)
        X = extract_patches(img, corners, k)
        state, _, _ = tonmf._train_loop(
            state, X, None, alpha, beta, stop, inner_iterations, batch_size,
            subsample, 10, False, "stale", backend="torch", coder=coder)
    return state


def old_tensor(state, img, *, outer_iterations, num_patches,
               inner_iterations, batch_size, patch_size, mode, joint, alpha,
               beta, sub_iter, stop, subsample, coder):
    k = patch_size
    for _ in range(outer_iterations):
        corners = random_patch_corners(state.gen, img.shape[:2], k,
                                       num_patches, device=img.device)
        X = extract_patches(img, corners, k)
        if img.dim() == 3:
            T = torch.movedim(X.T.reshape(num_patches, k * k, 3), 0, 2)
        else:
            T = X[:, :, None]
        Xu = unfold(T, mode)
        if joint:
            Xu = Xu.T
        state, _, _ = tonmf._train_loop(
            state, Xu, None, alpha, beta, stop, inner_iterations,
            batch_size, subsample, sub_iter, False, "stale",
            backend="torch", coder=coder)
    return state


def old_video(state, frames, *, num_patches, inner_iterations, batch_size,
              patch_size, epochs, alpha, beta, stop, subsample):
    k = patch_size
    for f in [f for _ in range(epochs) for f in range(frames.shape[0])]:
        corners = random_patch_corners(state.gen, frames.shape[1:3], k,
                                       num_patches, device=frames.device)
        X = extract_patches(frames[f], corners, k)
        state, _, _ = tonmf._train_loop(
            state, X, None, alpha, beta, stop, inner_iterations, batch_size,
            subsample, 10, False, "stale", backend="torch")
    return state


def old_ising(state, lattice, gen, *, ising_iterations, nsteps, num_patches,
              inner_iterations, batch_size, patch_size, T, beta, stop,
              sampler, update_lattice, keep_trajectory, subsample):
    k, n = patch_size, lattice.shape[0]

    def train_round(st, lat):
        corners = random_patch_corners(gen, lat.shape, k, num_patches,
                                       device=lat.device)
        X = extract_patches(lat.to(st.W.dtype), corners, k)
        st, _, _ = tonmf._train_loop(
            st, X, None, 0.0, beta, stop, inner_iterations, batch_size,
            subsample, 10, False, "stale", backend="torch")
        return st

    def advance(lat):
        if not update_lattice:
            return lat
        if sampler == "exact":
            return metropolis_chain(gen, lat, nsteps, 1.0, 0.0, T)[0]
        nsweeps = max(1, -(-nsteps // (n * n)))
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                                 device=gen.device))
        return checkerboard_sweeps(seed, lat, nsweeps, 1.0, 0.0, T)

    state = train_round(state, lattice)
    Ws = [state.W]
    errors = [surrogate_error(state.W, state.A, state.B, state.C)]
    traj = []
    for _ in range(ising_iterations):
        lattice = advance(lattice)
        state = train_round(state, lattice)
        Ws.append(state.W)
        errors.append(surrogate_error(state.W, state.A, state.B, state.C))
        if keep_trajectory:
            traj.append(lattice)
    trajectory = (torch.stack(traj) if traj else
                  lattice.new_zeros((ising_iterations, 0, 0)))
    return state, torch.stack(Ws), torch.stack(errors), lattice, trajectory


def old_pair_matrices_T(g, embs):
    """``pair_matrices_T`` as it stood, its index tables made from numpy
    at every call (unweighted)."""
    M, k = embs.shape
    eT = embs.T
    iu, ju = np.triu_indices(k, 1)
    P = len(iu)
    mem = tm._has_edges(g, eT[torch.as_tensor(iu)], eT[torch.as_tensor(ju)])
    stacked = torch.cat([mem.float(),
                         mem.new_zeros((1, M), dtype=torch.float32)])
    pairidx = np.full((k, k), P, np.int64)
    pairidx[iu, ju] = np.arange(P)
    pairidx[ju, iu] = np.arange(P)
    return stacked[torch.as_tensor(pairidx.reshape(-1))]


def old_ndl(state, g, emb0, B, *, mcmc_iterations, sample_size,
            inner_iterations, batch_size, alpha, beta, stop, use_glauber,
            num_chains, subsample, discard_first):
    k = B.shape[0]
    chains = emb0.reshape(-1, k)
    per = sample_size
    if num_chains > 1:
        per = -(-sample_size // num_chains)
        sample_size = per * num_chains
    dtype = state.W.dtype
    code = torch.zeros((state.r, sample_size), dtype=dtype)
    for i in range(mcmc_iterations):
        trail = tm.run_chains(state.gen, g, chains, B, per,
                              use_glauber=use_glauber, capture=False)
        X, chains = old_pair_matrices_T(g, trail.reshape(-1, k)), trail[:, -1]
        state, code, _ = tonmf._train_loop(
            state, X.to(dtype), code, alpha, beta, stop, inner_iterations,
            batch_size, subsample, 10, not (discard_first and i == 0),
            "stale", backend="torch")
    return state, code, chains.reshape(emb0.shape)


# ------------------------------------------- each app: new == per-round

@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("subsample,stop,coder", [
    (False, 0.01, "bcd"), (True, None, "bcd"), (True, 0.01, "fista")])
def test_image_rounds_equal_the_per_round_loop(route, dtype, subsample,
                                               stop, coder):
    img = torch.from_numpy(RNG.random((40, 44, 3))).to(dtype)
    kw = dict(outer_iterations=3, num_patches=30, inner_iterations=4,
              batch_size=12, patch_size=5, alpha=0.1, beta=0.8,
              subsample=subsample, coder=coder)
    new, old = twin_states(75, 6, dtype)
    got = timage.train_image_dict(new, img, use_stopping=stop is not None,
                                  stopping_diff=stop or 0.01, **kw)
    assert_states_equal(got, old_image(old, img, stop=stop, **kw))


@pytest.mark.parametrize("mode,joint,grey", [(2, True, False),
                                             (0, False, False),
                                             (1, False, False),
                                             (0, False, True)])
def test_tensor_rounds_equal_the_per_round_loop(route, mode, joint, grey):
    img = torch.from_numpy(RNG.random((30, 32) if grey else (30, 32, 3)))
    k, num = 4, 20
    d = ttensor.unfolded_dim(k, num, mode, joint, 1 if grey else 3)
    kw = dict(outer_iterations=3, num_patches=num, inner_iterations=3,
              batch_size=8, patch_size=k, mode=mode, joint=joint, alpha=0.5,
              beta=1.0, sub_iter=12, subsample=True, coder="fista")
    new, old = twin_states(d, 4, F64)
    got = ttensor._train_tensor(new, img, use_stopping=True, **kw)
    assert_states_equal(got, old_tensor(old, img, stop=0.01, **kw))


@pytest.mark.parametrize("colour", [True, False])
@pytest.mark.parametrize("epochs", [1, 2])
def test_video_rounds_equal_the_per_round_loop(route, colour, epochs):
    frames = torch.from_numpy(RNG.random((3, 24, 26, 3) if colour
                                         else (3, 24, 26)))
    kw = dict(num_patches=25, inner_iterations=4, batch_size=10,
              patch_size=4, epochs=epochs, alpha=0.1, beta=1.0,
              subsample=True)
    new, old = twin_states((3 if colour else 1) * 16, 5, F64)
    got = tvideo.train_video_dict(new, frames, use_stopping=True, **kw)
    assert_states_equal(got, old_video(old, frames, stop=0.01, **kw))


@pytest.mark.parametrize("sampler,update,keep", [
    ("checkerboard", True, True), ("checkerboard", True, False),
    ("exact", True, True), ("checkerboard", False, True)])
def test_ising_rounds_equal_the_per_round_loop(route, sampler, update, keep):
    n = 12
    lattice = init_lattice(torch.Generator().manual_seed(1), n)
    kw = dict(ising_iterations=3, nsteps=300, num_patches=40,
              inner_iterations=5, batch_size=10, patch_size=4, T=2.5,
              beta=1.0, sampler=sampler, update_lattice=update,
              keep_trajectory=keep, subsample=True)
    new, old = twin_states(16, 5, torch.float32, track_xxt=True)
    gens = [torch.Generator().manual_seed(7) for _ in range(2)]
    got = tising_app.ising_trajectory_learning(
        new, lattice, gens[0], stopping_diff=0.01, use_stopping=True, **kw)
    want = old_ising(old, lattice, gens[1], stop=0.01, **kw)
    assert_states_equal(got[0], want[0])
    assert got[1].shape == (4, 16, 5) and got[2].shape == (4,)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.parametrize("rep", ["dense", "csr", "bitset"])
@pytest.mark.parametrize("num_chains,use_glauber,k2", [
    (1, True, 2), (4, True, 2), (4, False, 3), (3, True, 0)])
@pytest.mark.parametrize("discard_first", [True, False])
def test_network_rounds_equal_the_per_round_loop(route, rep, num_chains,
                                                 use_glauber, k2,
                                                 discard_first):
    m = 6
    u = np.arange(m * m).reshape(m, m)
    edges = np.concatenate([
        np.stack([u.ravel(), np.roll(u, -1, 0).ravel()], 1),
        np.stack([u.ravel(), np.roll(u, -1, 1).ravel()], 1)])
    g = {"dense": tg.graph_from_edgelist, "csr": tg.csr_graph_from_edges,
         "bitset": tg.bitset_graph_from_edges}[rep](edges, device="cpu")
    B = tm.path_adj(0, k2)
    k = k2 + 1
    emb0 = tm.tree_sample(torch.Generator().manual_seed(3),
                          tm.tree_parents(B), g, torch.arange(num_chains))
    emb0 = emb0 if num_chains > 1 else emb0[0]
    kw = dict(mcmc_iterations=3, sample_size=22, inner_iterations=4,
              batch_size=8, alpha=0.1, beta=1.0, use_glauber=use_glauber,
              num_chains=num_chains, subsample=True,
              discard_first=discard_first)
    new, old = twin_states(k * k, 4, F64)
    got = tnet.ndl_train(new, g, emb0, B, stopping_diff=0.01, **kw)
    want = old_ndl(old, g, emb0, B, stop=0.01, **kw)
    assert_states_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert got[2].dtype == want[2].dtype and torch.equal(got[2], want[2])


# ---------------------------------------------- the captured route's parts

@pytest.mark.parametrize("rounds", [1, 6])
@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("t0,beta,iterations", [
    (0.0, 1.0, 5), (3.0, 0.7, 20), (1234.0, 0.5, 30), (7.5, 2.3, 2),
    (0.1, 0.9, 3), (0.0, 1.0, 41), (3.0, 0.7, 41), (1234.0, 0.5, 41),
    (7.5, 2.3, 41)])
def test_round_weights_match_the_python_scalar_arithmetic(dtype, t0, beta,
                                                          iterations,
                                                          rounds):
    """The weight table of a run of rounds, and at one round the training
    step's (``_train_loop``'s captured route): each entry, as a (1,) and
    as a 0-d tensor, gives the products and the in-place blend that the
    Python floats of the eager route give."""
    steps = iterations - 1
    w, omw = tonmf._round_weights(t0, rounds, iterations, steps, beta, dtype)
    assert w.dtype == omw.dtype == dtype and w.shape == (rounds * steps,)
    M = torch.from_numpy(RNG.random((5, 7))).to(dtype)
    S = torch.from_numpy(RNG.random((5, 7))).to(dtype)
    t = t0
    for j in range(rounds):
        for i in range(1, steps + 1):
            w_t = (t + i) ** (-float(beta))        # as _step_inner has it
            at = j * steps + i - 1
            eager = (1.0 - w_t) * M + w_t * S
            for wi, oi in ((w[at:at + 1], omw[at:at + 1]), (w[at], omw[at]),
                           (w_t, 1.0 - w_t)):
                assert torch.equal(oi * M + wi * S, eager)
                blended = M.clone()          # as _step_math blends in place
                torch.mul(blended, oi, out=blended).add_(S.clone().mul_(wi))
                assert torch.equal(blended, eager)
        t = t + float(iterations)        # as _train_loop leaves the counter
    # row j is the one-round table from the counter after j rounds
    t = t0
    for j in range(rounds):
        row = tonmf._round_weights(t, 1, iterations, steps, beta, dtype)
        assert torch.equal(w[j * steps:(j + 1) * steps], row[0])
        assert torch.equal(omw[j * steps:(j + 1) * steps], row[1])
        t = t + float(iterations)


def test_round_capacity_is_a_power_of_two_at_least_the_rounds():
    assert [tonmf._round_capacity(r) for r in (1, 2, 3, 4, 5, 20, 32, 33)] \
        == [1, 2, 4, 4, 8, 32, 32, 64]


M_MAX = tonmf._MAX_ROUND_STEPS


@pytest.mark.parametrize("args,route", [
    (("cuda", "cuda", None, 1, 25, False, 19, False), "captured"),
    (("cuda", "cuda", "nccl", 1, 25, False, 29, False), "captured"),
    (("cuda", "cuda", None, 1, 1248, False, M_MAX, False), "captured"),
    (("cuda", "cuda", None, 1, 25, False, M_MAX + 1, False), "per_round"),
    (("cuda", "cuda", None, 1, 25, False, 9, True), "per_round"),   # host
    (("cuda", "cuda", "nccl", 2, 25, False, 9, False), "per_round"),
    (("cuda", "cuda", None, 1, 25, True, 9, False), "per_round"),   # nans
    (("cuda", "torch", None, 1, 25, False, 9, False), "per_round"),
    (("cuda", "cuda", None, 1, 1249, False, 9, False), "per_round"),
    (("cuda", "cuda", "gloo", 1, 25, False, 9, False), "per_round"),
    (("cpu", "torch", None, 1, 25, False, 9, False), "per_round"),
    (("cpu", "cuda", None, 1, 25, False, 9, False), "per_round"),
    (("cpu", "torch", "gloo", 2, 25, False, 9, False), "per_round"),
])
def test_round_route(args, route):
    assert tonmf._round_route(*args) == route
    assert tonmf._round_route(*args, capture=False) == "per_round"


def _graph(rep="csr", m=8):
    u = np.arange(m * m).reshape(m, m)
    edges = np.concatenate([
        np.stack([u.ravel(), np.roll(u, -1, 0).ravel()], 1),
        np.stack([u.ravel(), np.roll(u, -1, 1).ravel()], 1)])
    return {"dense": tg.graph_from_edgelist, "csr": tg.csr_graph_from_edges,
            "bitset": tg.bitset_graph_from_edges}[rep](edges, device="cpu")


@pytest.mark.parametrize("glauber", [True, False])
def test_network_defaults_take_the_captured_route(monkeypatch, glauber):
    """``NetworkReconstructor`` at its own defaults (100 inner iterations,
    1000 samples of one chain; the rounds cut to one, the rank to 4, which
    the route does not read) hands ``_round_route`` a round that the card
    captures."""
    seen = []
    route = tonmf._round_route

    def spy(*args, **kw):
        seen.append(args)
        return route(*args, **kw)

    monkeypatch.setattr(tonmf, "_round_route", spy)
    rec = tnet.NetworkReconstructor(source=_graph(), MCMC_iterations=1,
                                    n_components=4, device="cpu",
                                    is_glauber_dict=glauber)
    rec.train_dict()
    (args,) = seen
    assert args[6] >= rec.sub_iterations - 1
    assert route("cuda", "cuda", *args[2:]) == "captured"


SPEC = tonmf._round_spec(30, 10, 12, True, 0.1, 10, 0.01, False, "stale",
                         "cuda", "bcd")
# another value for each field of the spec
BAKED = dict(batch=13, steps=10, alpha=0.2, sub_iter=11, stopping_diff=None,
             dict_from="fresh", backend="torch", coder="fista", draws="idx",
             subsample=False, sampling="block", track_code=True,
             track_metrics=True, group=object(), tp=object(),
             cols=(0, 128))


def test_round_key_changes_with_each_baked_argument_only():
    st = init_state(0, 16, 5, device="cpu", dtype=F64)
    img = torch.rand((20, 20, 3), dtype=F64)
    lat = torch.ones((12, 12), dtype=torch.int8)
    base = dict(state=st, code=None, spec=SPEC, app=("image", 4, 30),
                reads=(img,), carry={"lattice": lat},
                outs={"W": ((16, 5), F64)}, cap=4, generators=1)
    key = tonmf._round_key(**base)
    hash(key)
    # new values of the state, the carried tensors and another t or
    # generator: the same key
    other = init_state(1, 16, 5, device="cpu", dtype=F64, t=7.0)
    assert tonmf._round_key(**dict(
        base, state=other, carry={"lattice": -lat})) == key
    # a view of the same address, shape and strides is the same tensor
    assert tonmf._round_key(**dict(base, reads=(img[:],))) == key
    assert set(BAKED) == {f.name for f in dataclasses.fields(SPEC)}
    variants = [dict(spec=dataclasses.replace(SPEC, **{name: value}))
                for name, value in BAKED.items()]
    variants += [
        dict(app=("image", 5, 30)), dict(app=("video", 4, 30)),
        dict(reads=(img.clone(),)),                           # address
        dict(reads=(img[:, :19],)),                           # shape
        dict(reads=(img.transpose(0, 1),)),                   # strides
        dict(reads=(img.float(),)),                           # dtype
        dict(reads=(img, img)),
        dict(carry={"lattice": lat[:10, :10]}),
        dict(carry={"lattice": lat.long()}),
        dict(carry={"chains": lat}),
        dict(outs={"W": ((16, 5), torch.float32)}),
        dict(outs={"W": ((16, 5), F64), "errors": ((), F64)}),
        dict(cap=8), dict(generators=2),
        dict(code=torch.zeros((5, 30), dtype=F64)),
        dict(state=init_state(0, 16, 6, device="cpu", dtype=F64)),
        dict(state=init_state(0, 17, 5, device="cpu", dtype=F64)),
        dict(state=init_state(0, 16, 5, device="cpu", dtype=torch.float32)),
        dict(state=init_state(0, 16, 5, device="cpu", dtype=F64,
                              track_xxt=True)),
    ]
    keys = {key} | {tonmf._round_key(**dict(base, **v)) for v in variants}
    assert len(keys) == 1 + len(variants)


def test_round_keys_of_the_apps_hold_their_baked_tensors(monkeypatch):
    """Each app hands ``_run_rounds`` the tensors its round reads in place
    (the image, the frames, the graph's tensors and the motif's table) and
    its round parameters; the rounds' number is not among them."""
    seen = []
    run = tonmf._run_rounds

    def spy(state, code, spec, **kw):
        seen.append(kw)
        return run(state, code, spec, **kw)

    for mod in (timage, tvideo, tnet):
        monkeypatch.setattr(mod, "_run_rounds", spy)
    img = torch.rand((20, 22, 3), dtype=F64)
    st = init_state(0, 48, 4, device="cpu", dtype=F64)
    timage.train_image_dict(st, img, outer_iterations=2, num_patches=9,
                            inner_iterations=3, batch_size=4, patch_size=4)
    frames = torch.rand((3, 20, 22, 3), dtype=F64)
    tvideo.train_video_dict(st, frames, num_patches=9, inner_iterations=3,
                            batch_size=4, patch_size=4, epochs=2)
    g = tg.csr_graph_from_edges(np.array([[0, 1], [1, 2], [2, 3], [3, 0]]),
                                device="cpu")
    B = tm.path_adj(0, 2)
    tnet.ndl_train(init_state(0, 9, 4, device="cpu", dtype=F64), g,
                   torch.tensor([0, 1, 2]), B, mcmc_iterations=2,
                   sample_size=6, inner_iterations=3, batch_size=4)
    (im, vid, net) = seen
    assert im["reads"] == (img,) and im["rounds"] == 2
    assert vid["reads"] == (frames,) and vid["rounds"] == 6
    assert net["reads"][:3] == tm._graph_tensors(g)
    assert torch.equal(net["reads"][3], tm._neighbor_table_on(B, "cpu"))
    tables = tm._pair_tables(3, torch.device("cpu"))
    assert len(net["reads"]) == 7
    assert all(a is b for a, b in zip(net["reads"][4:], tables))
    assert net["blocks"] == 1 and net["app"][0] == "network"


def test_network_round_key_holds_the_pair_tables(monkeypatch):
    """A network round graph reads ``pair_matrices_T``'s cached index
    tables in place: its reads hold them (so that the cache cannot free
    them under it) and its key changes with their addresses, as when the
    cache has dropped them and made them anew."""
    seen = []
    run = tonmf._run_rounds

    def spy(state, code, spec, **kw):
        seen.append(tonmf._round_key(state, code, spec, kw["app"],
                                     kw["reads"], kw["carry"], {}, 4, 1))
        return run(state, code, spec, **kw)

    monkeypatch.setattr(tnet, "_run_rounds", spy)
    g = _graph()
    B = tm.path_adj(0, 2)

    def train():
        tnet.ndl_train(init_state(0, 9, 4, device="cpu", dtype=F64), g,
                       torch.tensor([0, 1, 2]), B, mcmc_iterations=2,
                       sample_size=6, inner_iterations=3, batch_size=4)

    held = tm._pair_tables(3, torch.device("cpu"))
    train()
    train()
    assert seen[0] == seen[1]
    tm._pair_tables.cache_clear()       # made anew at other addresses
    train()
    assert seen[2] != seen[0]
    addresses = {t.data_ptr() for t in held}
    assert addresses <= {part[0] for part in seen[0][7]}
    assert not addresses & {part[0] for part in seen[2][7]}


# ----------------------------------------- the sampler's device seed

@pytest.mark.parametrize("n,sweeps", [(6, 1), (12, 3), (16, 2)])
def test_tensor_seed_equals_the_int_seed(n, sweeps):
    lat = torch.from_numpy(RNG.choice(np.array([1, -1], np.int8), (n, n)))
    for seed in (0, 17, 2**31 - 2, 2**32 - 1):
        want = ik.checkerboard_sweeps_plain(seed, lat, sweeps, 1.0, 0.2, 2.0)
        for s in (torch.tensor([seed]), torch.tensor(seed)):
            assert torch.equal(ik.checkerboard_sweeps_plain(
                s, lat, sweeps, 1.0, 0.2, 2.0), want)
            assert torch.equal(ik.checkerboard_sweeps(
                s, lat, sweeps, 1.0, 0.2, 2.0), want)
            assert torch.equal(checkerboard_sweeps(
                s, lat, sweeps, 1.0, 0.2, 2.0), want)
    with pytest.raises(ValueError, match="32-bit"):
        ik.checkerboard_sweeps_plain(torch.tensor([2**32]), lat, 1)


# ----------------------------------------- pair_matrices_T's tables

@pytest.mark.parametrize("rep", ["dense", "csr", "bitset"])
@pytest.mark.parametrize("k", [1, 2, 3, 21])
def test_cached_pair_tables_give_the_same_matrix(rep, k):
    edges = np.array([[i, (i + d) % 30] for i in range(30) for d in (1, 4)])
    g = {"dense": tg.graph_from_edgelist, "csr": tg.csr_graph_from_edges,
         "bitset": tg.bitset_graph_from_edges}[rep](edges, device="cpu")
    embs = torch.from_numpy(RNG.integers(0, 30, (50, k)))
    for _ in range(2):                  # made, then taken from the cache
        assert torch.equal(tm.pair_matrices_T(g, embs),
                           old_pair_matrices_T(g, embs))
    assert tm._pair_tables(k, torch.device("cpu")) is tm._pair_tables(
        k, torch.device("cpu"))

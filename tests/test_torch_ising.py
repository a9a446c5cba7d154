"""The port's Ising path (samplers/ising.py, ops/kernels/ising_kernel.py's
plain version, apps/ising.py) against the JAX package and the Boltzmann
distribution, on the CPU.

The Metropolis chains and the trajectory learner replay JAX's draws and
must agree exactly (chains) or to float64 rounding (learner, rtol 1e-8).
The checkerboard sampler draws from its own counter-based stream, so it is
held to the physics: the exact 2x2 Boltzmann distribution and ordering
below the critical temperature.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from onmf_ontf_ndl_tpu.apps import ising as japp
from onmf_ontf_ndl_tpu.models.state import init_state as jinit_state
from onmf_ontf_ndl_tpu.ops import patches as jpatches
from onmf_ontf_ndl_tpu.samplers import ising as jising
from onmf_ontf_ndl_tpu_torch.apps import ising as tapp
from onmf_ontf_ndl_tpu_torch.models.state import init_state
from onmf_ontf_ndl_tpu_torch.ops.kernels import ising_kernel as ik
from onmf_ontf_ndl_tpu_torch.samplers import ising as tising
from test_ising import boltzmann_2x2, ensemble_counts, tv_distance

torch.set_num_threads(1)

RNG = np.random.default_rng(36)
F64 = torch.float64


def _t(a):
    return torch.from_numpy(np.array(a))


def random_lattice(n, batch=()):
    return RNG.choice(np.array([1, -1], np.int8), size=batch + (n, n))


@pytest.mark.parametrize("J,H", [(1.0, 0.0), (1.0, 0.5), (-0.5, 0.25)])
def test_hamiltonian_and_delta_e_equal_jax(J, H):
    lat = random_lattice(12)
    got = tising.hamiltonian(_t(lat), J, H)
    want = jising.hamiltonian(jnp.asarray(lat), J, H)
    assert got.dtype == torch.float32
    assert float(got) == float(want)
    s0 = np.array([-1.0, 1.0], np.float32)[:, None]
    sn = np.array([-4.0, -2.0, 0.0, 2.0, 4.0], np.float32)[None, :]
    np.testing.assert_array_equal(
        tising.delta_e(_t(s0), _t(sn), J, H).numpy(),
        np.asarray(jising.delta_e(jnp.asarray(s0), jnp.asarray(sn), J, H)))


def replay_chain_draws(key, n, nsteps):
    """The JAX chain's per-step (i, j, u) draws."""
    def one(k):
        ki, kj, ku = jax.random.split(k, 3)
        return (jax.random.randint(ki, (), 0, n),
                jax.random.randint(kj, (), 0, n), jax.random.uniform(ku, ()))

    return tuple(_t(v) for v in jax.vmap(one)(jax.random.split(key, nsteps)))


@pytest.mark.parametrize("J,H,T", [(1.0, 0.0, 2.0), (1.0, 0.3, 0.8)])
def test_metropolis_chain_equals_jax(J, H, T):
    lat, key = random_lattice(10), jax.random.key(3)
    draws = replay_chain_draws(key, 10, 500)
    want = jising.metropolis_chain(key, jnp.asarray(lat), 500, J, H, T)
    got = tising.metropolis_chain(None, _t(lat), 500, J, H, T, draws=draws)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ising_diagnostics_equals_jax():
    lat, key = random_lattice(8), jax.random.key(4)
    draws = replay_chain_draws(key, 8, 400)
    kw = dict(J=1.0, H=0.1, T=1.5, site=(2, 3), corr_r=2)
    want = jising.ising_diagnostics(key, jnp.asarray(lat), 400, **kw)
    got = tising.ising_diagnostics(None, _t(lat), 400, draws=draws, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].any()   # the tracked site did flip in this run


def test_chain_draws_from_a_generator():
    gen = torch.Generator().manual_seed(5)
    lat = _t(random_lattice(6))
    out, energies, mags = tising.metropolis_chain(gen, lat, 300, T=2.0)
    assert out.dtype == torch.int8 and set(out.unique().tolist()) <= {-1, 1}
    assert energies.shape == mags.shape == (300,)
    assert float(mags[-1]) == float(out.float().sum())
    # the energy trace follows the Hamiltonian (which counts pairs twice)
    dham = float(tising.hamiltonian(out, 1.0, 0.0)
                 - tising.hamiltonian(lat, 1.0, 0.0))
    assert dham == pytest.approx(2 * float(energies[-1]))


def test_philox_known_answers_and_thresholds():
    # Random123's known-answer vectors of Philox4x32-10
    m = 0xFFFFFFFF
    for ctr, key, want in [
            ((0, 0, 0, 0), (0, 0),
             (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((m, m, m, m), (m, m),
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
             (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]:
        assert tuple(int(w) for w in ik.philox4x32(*ctr, *key)) == want
    thr = ik.acceptance_thresholds(1.0, 0.0, 2.0)
    assert thr[2] == thr[7] == 1 << 23           # dE = 0: p = 1/2
    # sigmoid(x) + sigmoid(-x) = 1, each rounded up
    assert thr[0] + thr[4] == (1 << 24) + 1
    assert ik.acceptance_thresholds(1.0, 0.0, 1e-9)[9] == 0
    with pytest.raises(ValueError, match="temperature"):
        ik.acceptance_thresholds(1.0, 0.0, 0.0)


def test_checkerboard_matches_boltzmann_2x2():
    J, H, T = 1.0, 0.0, 4.0
    lat0 = _t(random_lattice(2, (8192,)))
    finals = ik.checkerboard_sweeps_plain(11, lat0, 200, J=J, H=H, T=T)
    assert tv_distance(ensemble_counts(finals.numpy()),
                       boltzmann_2x2(J, H, T)) < 0.03


def test_checkerboard_low_temperature_orders():
    lat = tising.init_lattice(torch.Generator().manual_seed(2), 16)
    m0 = abs(float(lat.float().sum())) / 256
    lat = tising.checkerboard_sweeps(3, lat, 200, T=1.0)
    m1 = abs(float(lat.float().sum())) / 256
    assert m1 > max(m0, 0.5)   # below Tc the lattice magnetizes


def test_checkerboard_plain_deterministic_in_seed():
    lat = _t(random_lattice(8))
    a = ik.checkerboard_sweeps_plain(7, lat, 5, T=2.0)
    assert torch.equal(a, ik.checkerboard_sweeps_plain(7, lat, 5, T=2.0))
    assert not torch.equal(a, ik.checkerboard_sweeps_plain(8, lat, 5, T=2.0))
    # a lattice is chain 0 of an ensemble, and the chains differ
    batch = torch.stack([lat, lat])
    out = ik.checkerboard_sweeps_plain(7, batch, 5, T=2.0)
    assert torch.equal(out[0], a) and not torch.equal(out[1], a)
    assert a.dtype == torch.int8
    with pytest.raises(ValueError, match="even"):
        ik.checkerboard_sweeps_plain(0, _t(random_lattice(5)), 1)
    with pytest.raises(ValueError, match="square"):
        tising.checkerboard_sweeps(0, torch.ones((4, 6), dtype=torch.int8), 1)


def replay_ising_draws(key, state_key, shape, k, r, rounds, num, inner):
    """The JAX trajectory learner's corner draws (per round) and the
    inner scans' H0 draws, with update_lattice=False."""
    key, rkey = jax.random.split(key)
    rkeys = [rkey] + [jax.random.split(s)[1]
                      for s in jax.random.split(key, rounds)]
    draws = []
    for rkey in rkeys:
        a, b = jpatches.random_patch_corners(rkey, shape, k, num)
        steps = []
        for _ in range(1, inner):
            state_key, _, hkey = jax.random.split(state_key, 3)
            steps.append((None, _t(jax.random.uniform(
                hkey, (r, num), dtype=jnp.float64))))
        draws.append(((_t(a), _t(b)), steps))
    return draws


def test_ising_trajectory_learning_matches_jax():
    n, k, r, rounds, num, inner = 12, 3, 4, 3, 20, 4
    lat = random_lattice(n)
    W = RNG.random((k * k, r))
    js = jinit_state(jax.random.key(1), k * k, r, dtype=jnp.float64,
                     track_xxt=True, W=W)
    ts = init_state(1, k * k, r, dtype=F64, track_xxt=True, W=W, device="cpu")
    kw = dict(ising_iterations=rounds, nsteps=50, num_patches=num,
              inner_iterations=inner, batch_size=5, patch_size=k, beta=0.8,
              update_lattice=False)
    key = jax.random.key(9)
    draws = replay_ising_draws(key, js.key, lat.shape, k, r, rounds, num,
                               inner)
    jst, jstack, jerr, jlat, _ = japp.ising_trajectory_learning(
        js, jnp.asarray(lat), key, **kw)
    tst, tstack, terr, tlat, traj = tapp.ising_trajectory_learning(
        ts, _t(lat), torch.Generator(), draws=draws, **kw)
    assert terr.shape == (rounds + 1,)
    assert tstack.shape == jstack.shape == (rounds + 1, k * k, r)
    np.testing.assert_allclose(tstack.numpy(), np.asarray(jstack), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-8)
    np.testing.assert_allclose(tst.C.numpy(), np.asarray(jst.C), rtol=1e-8)
    np.testing.assert_array_equal(tlat.numpy(), lat)
    assert traj.shape == (rounds, 0, 0)


@pytest.mark.parametrize("sampler", ["checkerboard", "exact"])
def test_ising_reconstructor_end_to_end(sampler):
    rec = tapp.IsingReconstructor(
        n_components=8, lattice_size=16, ising_iterations=4,
        temperature=3.0, ising_subsampling_steps=256, sub_iterations=4,
        num_patches=30, batch_size=10, patch_size=4, beta=0.8,
        sampler=sampler, dtype=F64, device="cpu")
    lat0 = rec.lattice.clone()
    traj, dict_stack, errors = rec.ising_mcmc_learning(keep_trajectory=True)
    assert dict_stack.shape == (5, 16, 8) and errors.shape == (5,)
    assert torch.isfinite(errors).all() and (rec.W >= 0).all()
    assert traj.shape == (4, 16, 16) and not torch.equal(traj[0], lat0)
    assert set(traj.unique().tolist()) <= {-1, 1}
    out = rec.reconstruct_config(rec.lattice)
    assert out.shape == (16, 16) and torch.isfinite(out).all()
    # a float lattice (the reference's saved trajectories) is accepted
    rec.ising_mcmc_learning(initial_lattice=lat0.double().numpy())
    with pytest.raises(ValueError, match="sampler"):
        tapp.IsingReconstructor(sampler="gibbs", device="cpu")

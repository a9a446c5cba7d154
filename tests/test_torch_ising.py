"""The port's Ising path (samplers/ising.py, ops/kernels/ising_kernel.py's
plain version, apps/ising.py) against the JAX package and the Boltzmann
distribution, on the CPU.

The Metropolis chains and the trajectory learner replay JAX's draws and
must agree exactly (chains) or to float64 rounding (learner, rtol 1e-8).
The checkerboard sampler draws from its own counter-based stream (one
Philox call per four sites of a colour), so it is held to the stream's
definition, to the physics (the exact 2x2 Boltzmann distribution, ordering
below the critical temperature), and to a numpy emulation of the CUDA
kernels' own order of operations: packed 8-byte words, several sites a
thread, bands of rows with halo rows read from the neighbours' copies.
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
# checkerboard_route's choices at the paths' shapes and at its crossovers
ROUTES = {(2, 1): ("shared", 1), (16, 100): ("shared", 1),
          (18, 3): ("global", 0), (18, 4): ("cluster", 4),
          (32, 4): ("cluster", 8), (160, 3): ("global", 0),
          (160, 4): ("cluster", 8), (162, 15): ("global", 0),
          (200, 1): ("global", 0), (200, 16): ("cluster", 8),
          (200, 100): ("cluster", 8), (256, 100): ("cluster", 8),
          (258, 100): ("global", 0), (1024, 100): ("global", 0),
          (4096, 100): ("global", 0)}


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
    # the sampler's stream: site q = i (n / 2) + (j >> 1) of its colour
    # takes word q & 3 of the call with counter (q >> 2, sweep, colour,
    # chain). At J = H = 0 every threshold is 2^23, so a site flips exactly
    # when the top bit of its word is clear, whatever its neighbours do.
    # n / 2 odd (n = 6, 10: a call straddles two rows), n = 2 (one call a
    # colour), and a batch of two chains (counter word 3)
    seed = 4242
    for n in (2, 6, 10, 16):
        half = n // 2
        i, j = np.divmod(np.arange(n * n), n)
        q = i * half + (j >> 1)
        for chain, got in enumerate(ik.checkerboard_sweeps_plain(
                seed, torch.ones((2, n, n), dtype=torch.int8), 1, J=0.0,
                H=0.0, T=1.0)):
            words = ik.philox4x32(_t(q >> 2), 0, _t((i + j) & 1), chain,
                                  seed, 0)
            word = torch.stack(words)[_t(q & 3), torch.arange(n * n)]
            want = torch.where((word >> 8) < (1 << 23), -1, 1)
            assert torch.equal(got.reshape(-1).long(), want), (n, chain)
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


def philox_np(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 in numpy on uint64 arrays of 32-bit words."""
    mask = np.uint64(0xFFFFFFFF)
    c0, c1, c2, c3 = (np.broadcast_to(np.asarray(c, np.uint64), np.shape(c0))
                      for c in (c0, c1, c2, c3))
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        p0, p1 = np.uint64(0xD2511F53) * c0, np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & mask,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & mask)
        k0, k1 = (k0 + np.uint64(0x9E3779B9)) & mask, \
            (k1 + np.uint64(0xBB67AE85)) & mask
    return c0, c1, c2, c3


def emulate_kernels(lat, nsweeps, seed, thr, ctas):
    """The CUDA kernels' order of operations in numpy (csrc/ising_kernels.cu).

    ``ctas = 0``: the device-memory route on the whole lattice; else the
    resident route, each of ``ctas`` CTAs holding a band of ``ceil(n /
    ctas)`` rows in its own copy and reading the row above and the row
    below its band from its neighbours' copies as they stand. The vector
    width comes from n alone: with n % 8 == 0 a row is 8-byte words of four
    sites each (one Philox call a word, the neighbour counts by byte
    arithmetic on the packed words, the threshold at
    ``tab[count + 5 [s = -1]]``); else one Philox call per four sites q,
    which may straddle two rows, the sites one at a time."""
    n = lat.shape[0]
    half = n // 2
    tab = np.array([thr[9 - k] for k in range(10)], np.uint64)
    band = n if ctas == 0 else -(-n // ctas)
    firsts = list(range(0, n, band))
    assert ctas == 0 or len(firsts) == ctas
    copies = [lat[f:f + band].copy() for f in firsts]
    u64 = np.uint64
    ones = u64(0x0101010101010101)
    for sweep in range(nsweeps):
        for colour in (0, 1):
            for b, first in enumerate(firsts):
                own = copies[b]
                count = own.shape[0]
                above = copies[b - 1][-1]
                below = copies[(b + 1) % len(copies)][0]
                if n % 8 == 0:
                    W = n // 8
                    i = first + np.arange(count)[:, None]
                    w = np.arange(W)[None, :]
                    rnd = philox_np((i * W + w).astype(u64) & u64(0xFFFFFFFF),
                                    sweep, colour, 0, seed, 0)
                    words = own.view(u64)
                    up = np.concatenate([above[None], own[:-1]]).view(u64)
                    down = np.concatenate([own[1:], below[None]]).view(u64)
                    bits = (own.view(np.uint8) >> 1) & 1
                    left = bits[:, (8 * w[0] - 1) % n].astype(u64)
                    right = bits[:, (8 * w[0] + 8) % n].astype(u64)
                    m = (words >> u64(1)) & ones
                    idx = (((up >> u64(1)) & ones) + ((down >> u64(1)) & ones)
                           + ((m << u64(8)) | left)
                           + ((m >> u64(8)) | (right << u64(56)))
                           + m + (m << u64(2)))
                    p = ((i + colour) & 1).astype(u64)
                    flip = np.zeros_like(words)
                    for t in range(4):
                        sh = u64(8) * (u64(2 * t) + p)
                        k = ((idx >> sh) & u64(0xF)).astype(np.int64)
                        hit = (rnd[t] >> u64(8)) < tab[k]
                        flip |= np.where(hit, u64(0xFE) << sh, u64(0))
                    copies[b] = (words ^ flip).view(np.int8)
                else:
                    ext = np.concatenate([above[None], own,
                                          below[None]]).astype(np.int64)
                    q_lo, q_hi = first * half, (first + count) * half
                    g = np.arange(q_lo >> 2, -(-q_hi // 4))
                    rnd = philox_np(g.astype(u64), sweep, colour, 0, seed, 0)
                    for t in range(4):
                        q = 4 * g + t
                        live = (q >= q_lo) & (q < q_hi)
                        qq, u24 = q[live], (rnd[t] >> u64(8))[live]
                        i = qq // half
                        j = 2 * (qq - i * half) + ((i + colour) & 1)
                        l = i - first + 1
                        s = ext[l, j]
                        sn = (ext[l - 1, j] + ext[l + 1, j]
                              + ext[l, (j - 1) % n] + ext[l, (j + 1) % n])
                        k = ((1 - s) >> 1) * 5 + ((4 - sn) >> 1)
                        flips = u24 < tab[k]
                        own[(l - 1)[flips], j[flips]] *= -1
    return np.concatenate(copies)


@pytest.mark.parametrize("nsweeps", range(1, 8))
@pytest.mark.parametrize("n", [2, 6, 16, 200])
def test_kernel_emulation_equals_plain_site_for_site(n, nsweeps):
    lat = random_lattice(n)
    J, H, T, seed = 1.0, 0.1, 2.3, 1000 + n
    thr = ik.acceptance_thresholds(J, H, T)
    want = ik.checkerboard_sweeps_plain(seed, _t(lat), nsweeps, J, H, T)
    assert n == 2 or (want.numpy() != lat).any()
    routes = [c for c in (0, 1, 2, 3, 8) if c == 0 or (
        (c - 1) * -(-n // c) < n)]
    assert len(routes) >= 2
    for ctas in routes:
        got = emulate_kernels(lat.copy(), nsweeps, seed, thr, ctas)
        np.testing.assert_array_equal(got, want.numpy(), err_msg=str(ctas))


@pytest.mark.parametrize("n,bands", [(2, 1), (6, 2), (6, 3), (12, 2),
                                     (12, 4), (16, 4), (20, 5), (24, 3),
                                     (200, 2), (200, 8)])
def test_banded_sweeps_equal_plain_site_for_site(n, bands):
    # the banded entry's plain version, band by band with the halo rows
    # copied before each colour, equals the whole lattice: n / 2 % 4 != 0
    # (n = 6, 12, 20) puts band edges inside a Philox call
    from onmf_ontf_ndl_tpu_torch.parallel.ising_sharded import (
        banded_checkerboard_sweeps)

    lat = _t(random_lattice(n))
    want = ik.checkerboard_sweeps_plain(7 + n, lat, 3, 1.0, -0.1, 2.1)
    got = banded_checkerboard_sweeps(7 + n, lat, 3, bands, 1.0, -0.1, 2.1)
    assert got.dtype == torch.int8
    assert torch.equal(got, want)


def test_band_half_checks_its_arguments():
    lat = torch.ones((8, 8), dtype=torch.int8)
    band, above, below = lat[:4].clone(), lat[7], lat[4]
    want = ik.checkerboard_band_half_plain(3, band, above, below, 0, 0, 1)
    assert torch.equal(band, lat[:4])          # the plain version copies
    assert ik.checkerboard_band_half(3, band, above, below, 0, 0, 1) is band
    assert torch.equal(band, want)
    for bad, match in (((band, above[:5], below, 0, 0, 0), "halo rows"),
                       ((band, above, below, 5, 0, 0), "rows 5..8"),
                       ((band, above, below, 0, 0, 2), "colour"),
                       ((torch.ones((2, 5), dtype=torch.int8),
                         torch.ones(5), torch.ones(5), 0, 0, 0), "even")):
        with pytest.raises(ValueError, match=match):
            ik.checkerboard_band_half(3, *bad)


def test_checkerboard_route_by_shape_alone():
    import inspect

    assert list(inspect.signature(ik.checkerboard_route).parameters) == [
        "n", "nsweeps"]
    # what the bands can hold: 227 KB a CTA less the table's 64 bytes
    assert ik._resident_fits(482, 1) and not ik._resident_fits(484, 1)
    assert ik._resident_fits(1360, 8) and not ik._resident_fits(1376, 8)
    assert not ik._resident_fits(6, 8)       # a CTA would hold no row
    for (n, nsweeps), want in ROUTES.items():
        assert ik.checkerboard_route(n, nsweeps) == want, (n, nsweeps)
    for n in range(2, 1500, 2):
        for nsweeps in (1, 3, 10, 100, 10_000):
            name, ctas = ik.checkerboard_route(n, nsweeps)
            assert (name, ctas > 1, ctas > 0) in (
                ("global", False, False), ("shared", False, True),
                ("cluster", True, True))
            assert ctas == 0 or ik._resident_fits(n, ctas)


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

"""The wide Gauss-Seidel kernel (``coder_wide_kernel``) of
onmf_ontf_ndl_tpu_torch.ops.kernels, by emulation on the CPU.

A PyTorch emulation of the kernel's order of operations, in the dtype of
its inputs: the lanes that share a column (8, 16 or 32 by rank), each
summing its float4 slots of the row into four accumulators, the butterfly
over the lanes, the step on the row's owner; the passes over the tile's
columns; with the stop, the Grams summed over the tile's columns in order
and ``ft_stop_decision``. In float64 it is held against the JAX coder on
each tile's columns alone at 1e-12 (the same sweeps per tile), in float32
against the Pallas kernel in interpret mode with its tile set to the port's
TN and against the plain version, at the Pallas kernels' tolerance rtol
2e-4 / atol 2e-5 (float32 summation order). The kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu.ops.coder import _code_impl as jax_code_impl
from onmf_ontf_ndl_tpu.ops.pallas.coder_kernel import (
    coder_sweeps as jax_coder_sweeps,
    coder_sweeps_earlystop as jax_coder_sweeps_earlystop)
from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel as ck
from test_torch_fista import _fma, _wide_decision

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)


def make(r, n, seed, d=300, dtype=np.float32):
    """The smoke's inputs: Grams of a normalised random dictionary."""
    rng = np.random.default_rng(seed)
    W = rng.random((d, r))
    W /= np.linalg.norm(W, axis=0)
    X = rng.random((d, n))
    H0 = rng.random((r, n))
    return tuple(torch.from_numpy(x.astype(dtype))
                 for x in (W.T @ W, W.T @ X, H0))


def _add_mul(a, b, c):
    return a * b + c


def _sweep(h, Ap, b, alpha, rs, lanes, slots, active):
    """One sweep of a pass's columns ``h`` (r, cols): at coordinate k each
    lane sums fmaf(A[k, j], h[j]) over its slots' rows j = 4 (lane +
    lanes m) + s into the accumulator of s, adds (a0 + a1) + (a2 + a3), the
    butterfly over the lanes (xor lanes / 2 first) gives the dot product,
    and the owner's step is max(0, h_k - st (g - b_k + alpha)) as one
    fmaf; inactive columns keep their zeros."""
    f32 = h.dtype == torch.float32
    fma = _fma if f32 else _add_mul
    r, cols = h.shape
    Hp = torch.zeros((Ap.shape[1], cols), dtype=h.dtype)
    Hp[:r] = h
    Hv = Hp.view(slots, lanes, 4, cols)
    idx = torch.arange(lanes)
    for k in range(r):
        Ak = Ap[k].view(slots, lanes, 4)
        acc = torch.zeros((lanes, 4, cols), dtype=h.dtype)
        for m in range(slots):
            acc = fma(Ak[m][:, :, None], Hv[m], acc)
        x = (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])
        o = lanes // 2
        while o:
            x = x + x[idx ^ o]
            o //= 2
        g = (x[0] - b[k]) + alpha
        st = rs / (Ap[k, k] + 1.0)
        Hp[k] = torch.where(active, torch.clamp_min(fma(-st, g, Hp[k]), 0.0),
                            Hp[k])
    return Hp[:r]


def _decision64(Gd, Gh, vs, stop, pi_iters):
    """The stop's decision in exact order-free maths: one warm power step
    from v + 0.05 v0 for the Rayleigh lower bounds, min(trace, Gershgorin)
    upper bounds, pi_iters more steps only in the band."""
    v0 = ck._fixed_start(Gd.shape[0], Gd.dtype, "cpu")
    lb, ub = [], []
    for i, G in enumerate((Gd, Gh)):
        v = vs[i] + 0.05 * v0
        w = G @ v
        v = w / max(float(torch.linalg.norm(w)), 1e-30)
        lb.append(float(v @ (G @ v)) / max(float(v @ v), 1e-30))
        ub.append(min(float(torch.trace(G)), float(G.abs().sum(1).max())))
        vs[i] = v
    s2 = stop * stop
    if ub[0] <= s2 * lb[1] or lb[0] > s2 * ub[1]:
        return ub[0] <= s2 * lb[1]
    lam = []
    for i, G in enumerate((Gd, Gh)):
        v = vs[i]
        for _ in range(pi_iters):
            w = G @ v
            v = w / max(float(torch.linalg.norm(w)), 1e-30)
        vs[i] = v
        lam.append(float(v @ (G @ v)) / max(float(v @ v), 1e-30))
    return lam[0] <= s2 * lam[1]


def _emulate_coder_wide(A, B, H0, alpha, stop=None, sub_iter=10,
                        pi_iters=12, with_sweeps=False):
    """coder_wide_kernel: per tile of TN columns, up to ``sub_iter`` sweeps
    (exactly, without ``stop``), each over the tile's columns in passes
    (``coder_wide_config``) of the lanes' order (:func:`_sweep`), step
    1 / sqrt(i + 10) / (A_kk + 1) from A's zero-padded table; with the
    stop, the Grams of the step delta and of the old iterate summed over
    the tile's columns in order (the batch's padding as zeros) and the
    decision (float32: ft_stop_decision's order; float64:
    :func:`_decision64`), the converging sweep kept."""
    dtype = B.dtype
    f32 = dtype == torch.float32
    r, n = B.shape
    lanes, slots, passes = ck.coder_wide_config(r, stop is not None)[:3]
    cols = ck.TN // passes
    Ap = torch.zeros((r, 4 * lanes * slots), dtype=dtype)
    Ap[:, :r] = A
    v0 = ck._fixed_start(r, dtype, "cpu")
    stop2 = torch.tensor(stop or 0.0, dtype=torch.float32) ** 2
    out, counts = torch.empty_like(B), []
    for t0 in range(0, n, ck.TN):
        w = min(ck.TN, n - t0)
        H = torch.zeros((r, ck.TN), dtype=dtype)
        b = torch.zeros((r, ck.TN), dtype=dtype)
        H[:, :w], b[:, :w] = H0[:, t0:t0 + w], B[:, t0:t0 + w]
        active = torch.arange(ck.TN) < w
        vs = [v0.clone(), v0.clone()]
        sweeps = 0
        for i in range(sub_iter):
            rs = (1.0 / torch.sqrt(torch.tensor(i + 10.0, dtype=dtype))
                  if f32 else 1.0 / math.sqrt(i + 10.0))
            new = torch.empty_like(H)
            for p in range(passes):
                c = slice(p * cols, (p + 1) * cols)
                new[:, c] = _sweep(H[:, c], Ap, b[:, c], alpha, rs, lanes,
                                   slots, active[c])
            sweeps += 1
            conv = False
            if stop is not None:
                grams = []
                for M in (new - H, H):
                    if f32:
                        G = torch.zeros((r, r))
                        for c in range(ck.TN):
                            G = _fma(M[:, c, None], M[None, :, c], G)
                    else:
                        G = M @ M.T
                    grams.append(G)
                conv = (_wide_decision(*grams, vs, stop2, pi_iters) if f32
                        else _decision64(*grams, vs, stop, pi_iters))
            H = new
            if conv:
                break
        out[:, t0:t0 + w] = H[:, :w]
        counts.append(sweeps)
    return (out, counts) if with_sweeps else out


@pytest.mark.parametrize("r,stop", [(101, 0.01), (136, 0.01), (137, 0.05),
                                    (160, 0.01)])
def test_wide_emulation_matches_jax_per_tile_and_pallas(r, stop):
    # two whole tiles and a ragged one. float64: each tile against the JAX
    # coder on its columns alone (the whole-batch rule with exact spectral
    # norms decides as the tile's does): the same sweeps, 1e-12. float32:
    # against the Pallas kernel at block_n = TN and the plain version
    n = 2 * ck.TN + 37
    A, B, H0 = make(r, n, seed=r, dtype=np.float64)
    got = _emulate_coder_wide(A, B, H0, 0.1, stop)
    for t0 in range(0, n, ck.TN):
        cols = slice(t0, t0 + ck.TN)
        want = np.asarray(jax_code_impl(
            jnp.asarray(A.numpy()), jnp.asarray(B[:, cols].numpy()),
            jnp.asarray(H0[:, cols].numpy()), jnp.float64(0.1),
            jnp.float64(stop), jnp.float64(0.0), 10, True, False))
        np.testing.assert_allclose(got[:, cols].numpy(), want, rtol=1e-12,
                                   atol=1e-12)
    A, B, H0 = (x.float() for x in (A, B, H0))
    got = _emulate_coder_wide(A, B, H0, 0.1, stop)
    assert got.dtype == torch.float32
    want = np.asarray(jax_coder_sweeps_earlystop(
        jnp.asarray(A.numpy()), jnp.asarray(B.numpy()),
        jnp.asarray(H0.numpy()), 0.1, stop, sub_iter=10, block_n=ck.TN,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = ck.coder_sweeps_earlystop_plain(A, B, H0, 0.1, stop)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_wide_emulation_tiles_stop_at_different_sweeps():
    # five tiles (the last ragged) that stop after different numbers of
    # sweeps: each tile keeps its own count, as the plain version's
    A, B, H0 = make(120, 4 * ck.TN + 21, seed=5, dtype=np.float64)
    H0[:, ck.TN:2 * ck.TN] *= 4.0    # further from the fixed point
    H0[:, 3 * ck.TN:4 * ck.TN] *= 0.2
    got, counts = _emulate_coder_wide(A, B, H0, 0.1, 0.05, sub_iter=30,
                                      with_sweeps=True)
    plain, sweeps = ck.coder_sweeps_earlystop_plain(
        A, B, H0, 0.1, 0.05, sub_iter=30, with_sweeps=True)
    assert counts == sweeps.tolist()
    assert len(set(counts)) > 1 and max(counts) < 30
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("r,n", [(256, ck.TN), (512, ck.TN // 2 + 5)])
def test_wide_emulation_float32_at_large_ranks_matches_plain(r, n):
    # the card's tolerance against the plain version in float32 at the
    # ranks of the smoke's workspace shapes: one lane group of 8 (r = 256)
    # and two passes of 16-lane groups (r = 512)
    A, B, H0 = make(r, n, seed=r)
    got = _emulate_coder_wide(A, B, H0, 0.1, 0.01)
    plain = ck.coder_sweeps_earlystop_plain(A, B, H0, 0.1, 0.01)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("r,n", [(129, 2 * ck.TN + 37), (300, 70),
                                 (600, 40)])
def test_wide_emulation_fixed_sweeps_match_plain(r, n):
    # without the stop, exactly sub_iter sweeps in each regime (8, 16 and
    # 32 lanes): float64 against the plain version at 1e-12, float32 at the
    # card's tolerance (r = 129 also against the Pallas kernel)
    A, B, H0 = make(r, n, seed=r, dtype=np.float64)
    got = _emulate_coder_wide(A, B, H0, 0.1, sub_iter=4)
    plain = ck.coder_sweeps_plain(A, B, H0, 0.1, sub_iter=4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-12,
                               atol=1e-12)
    A, B, H0 = (x.float() for x in (A, B, H0))
    got = _emulate_coder_wide(A, B, H0, 0.1, sub_iter=4)
    plain = ck.coder_sweeps_plain(A, B, H0, 0.1, sub_iter=4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    if r == 129:
        want = np.asarray(jax_coder_sweeps(
            jnp.asarray(A.numpy()), jnp.asarray(B.numpy()),
            jnp.asarray(H0.numpy()), 0.1, sub_iter=4, interpret=True))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_coder_wide_config_by_rank_alone():
    # the regimes and the shapes at their boundaries, and every wide rank
    # fits 512 threads' registers (at most 2 x 4 x 10 rows a thread) and an
    # SM's shared memory. With the stop the Grams and power vectors are
    # shared up to r = 136 and in the slice past it, 4 x 4 Gram blocks
    # while those take the 512 threads at most two rounds
    assert ck.coder_wide_config(101) == (
        8, 4, 1, 16, 4, 128, True,
        4 * (608 + 2 * 104 * 104 + 128 * 108), 101 * 128,
        2 * 101 * 128)
    assert ck.coder_wide_config(256) == (
        8, 8, 1, 16, 8, 128, False, 4 * 128 * 260, 256 * 256,
        2 * 256 * 128 + 2 * 256 * 256 + 1536)
    assert ck.coder_wide_config(128)[:2] == (8, 4)
    assert ck.coder_wide_config(129)[:2] == (8, 6)
    assert ck.coder_wide_config(136)[6] is True
    assert ck.coder_wide_config(137)[6] is False
    assert ck.coder_wide_config(176)[4] == 4
    assert ck.coder_wide_config(177)[4] == 8
    assert ck.coder_wide_config(192)[:2] == (8, 6)
    assert ck.coder_wide_config(193)[:2] == (8, 8)
    assert ck.coder_wide_config(257)[:3] == (16, 8, 2)
    assert ck.coder_wide_config(512)[:3] == (16, 8, 2)
    assert ck.coder_wide_config(513)[:3] == (32, 10, 4)
    assert ck.coder_wide_config(ck.MAX_RANK)[:3] == (32, 10, 4)
    assert ck.coder_wide_config(129, False) == (
        8, 6, 1, 16, 4, 128, False, 4 * (2 * 16 * (192 + 128) + 132),
        129 * 192, 0)
    for use_stopping, first in ((True, 101), (False, 129)):
        for r in range(first, ck.MAX_RANK + 1):
            lanes, slots, passes, chunk, side, cols, shared, smem, head, \
                slice_floats = ck.coder_wide_config(r, use_stopping)
            assert lanes in (8, 16, 32) and passes * 1024 // lanes == ck.TN
            assert (lanes, slots) in ((8, 4), (8, 6), (8, 8), (16, 8),
                                      (32, 10))
            assert 4 * lanes * slots >= r
            assert chunk == 16 and smem <= 232448
            assert head == r * 4 * lanes * slots
            assert shared == (use_stopping and r <= 136)
            assert (slice_floats > 0) == use_stopping
            assert slice_floats % 32 == 0
        with pytest.raises(ValueError):
            ck.coder_wide_config(first - 1, use_stopping)

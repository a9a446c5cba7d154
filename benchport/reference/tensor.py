"""Plain reference of the colour tensor configuration: online nonnegative
tensor factorization by matricization (the patches of a colour image as a
(k^2, 3, n) tensor, unfolded along mode 2 and transposed for a joint
dictionary over the other two modes), with a FISTA coder, and the colour
reconstruction by coding every patch of a strided grid and averaging the
overlaps. Plain PyTorch, float32 (its entry points turn TF32 off:
``onmf.fixed_float32``), on the device of its inputs; imports nothing of
the port. The dictionary's column pass and the aggregates' blend are
``reference/onmf.py``'s.

FISTA, written from the method's definition, solves
``min_{H >= 0} 0.5 |X - W H|^2 + alpha |H|_1`` from Gram form
(G = W^T W, P = W^T X): with the step 1 / L,
``L = 1.02 lambda_max(G) + 1e-12``, lambda_max the Rayleigh quotient after
:data:`POWER_STEPS` normalised power steps from ``onmf._start``, each
iteration is ``Hn = max(0, Y - (G Y - P + alpha) / L)``, ``t' = (1 +
sqrt(1 + 4 t^2)) / 2``, ``Y = Hn + (t - 1) / t' (Hn - H)``, from
``H = Y = H0`` and t = 1. The columns go in tiles of ``tile``, each with
its own momentum t; with a stop a tile stops, keeping its columns from
then on, after the first iteration whose step D = Hn - H and start H have
``lambda_max(D D^T) <= stop^2 lambda_max(H H^T)`` (that iteration's step
applied), or after ``iters``. The two eigenvalues are decided as the
early stop's kernel defines the rule (``onmf.code_tile_stop``: certified
bounds, then warm power steps in the band between them). Without a stop
(the reconstruction) every tile runs ``iters`` iterations.

Randomness: the learner draws from one ``torch.Generator`` seeded with
the learner's seed, in this order: the initial dictionary (uniform,
(d, r)); then each round the patches' top-left corners (rows, then
columns, uniform over 0 .. H - k - 1), and each inner step's column draw
(``batch_size`` indices uniform over 0 .. n - 1, with replacement) and
code start (uniform, (r, batch_size)). The reconstruction's code start is
drawn from a generator seeded with 29. These are the calls the port
makes; the reference makes them itself from the seeds, on a generator of
the same device.

Departures from the source's script, as the port has them: the source's
LARS solve is FISTA with ``iters`` iterations (the configuration's
``sub_iter``); its stop is decided per tile of 128 columns; the momentum
is computed in float32, as the kernel computes it.
"""

from __future__ import annotations

import torch

from benchport.reference import image, onmf

# Power steps of the step size 1 / L, a call.
POWER_STEPS = 16


def patch_tensor(img: torch.Tensor, rows, cols, k: int) -> torch.Tensor:
    """The (k^2, 3, n) tensor of the k x k patches at the corners
    (rows, cols): entry (di * k + dj, c, m) is pixel (rows[m] + di,
    cols[m] + dj) of channel c."""
    di = torch.arange(k, device=img.device).repeat_interleave(k)
    dj = torch.arange(k, device=img.device).repeat(k)
    px = img[rows[None, :] + di[:, None], cols[None, :] + dj[:, None], :]
    return px.permute(0, 2, 1)          # (k^2, n, 3) -> (k^2, 3, n)


def unfold_joint(T: torch.Tensor, mode: int) -> torch.Tensor:
    """The mode-``mode`` unfolding of T, transposed for the joint
    dictionary: (the other modes' sizes multiplied, T.shape[mode])."""
    M = torch.movedim(T, mode, 0).reshape(T.shape[mode], -1)
    return M.T


def step_size(G: torch.Tensor, prec: onmf.Prec) -> torch.Tensor:
    """1 / L, L = 1.02 lambda_max(G) + 1e-12, lambda_max the Rayleigh
    quotient after :data:`POWER_STEPS` normalised power steps."""
    v = onmf._start(G.shape[0], G.device)
    for _ in range(POWER_STEPS):
        w = prec.mm(G, v[:, None])[:, 0]
        v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
    q = (v * prec.mm(G, v[:, None])[:, 0]).sum() \
        / torch.clamp_min((v * v).sum(), 1e-30)
    return 1.0 / (q * 1.02 + 1e-12)


def _decide(D, O, vd, vh, v0, stop2: float, prec: onmf.Prec):
    """Each tile's stop on its step D and start O (tiles, r, tile), as
    ``onmf.code_tile_stop`` decides it; returns (stop now, vd, vh)."""
    Gd = prec.mm(D, D.transpose(1, 2))
    Gh = prec.mm(O, O.transpose(1, 2))
    lb_d, vd = onmf._power(Gd, vd + 0.05 * v0, 1, prec)
    lb_h, vh = onmf._power(Gh, vh + 0.05 * v0, 1, prec)
    certain = onmf._upper(Gd) <= stop2 * lb_h
    band = ~(certain | (lb_d > stop2 * onmf._upper(Gh)))
    num, vd_band = onmf._power(Gd, vd, onmf.PI_ITERS, prec)
    den, vh_band = onmf._power(Gh, vh, onmf.PI_ITERS, prec)
    now = torch.where(band, num <= stop2 * den, certain)
    vd = torch.where(band[:, None], vd_band, vd)
    vh = torch.where(band[:, None], vh_band, vh)
    return now, vd, vh


def fista(G, P, H0, alpha: float, iters: int, stop, tile: int,
          prec: onmf.Prec, with_iters: bool = False):
    """The code of the columns of P (r, n) from H0: ``iters`` FISTA
    iterations, or with ``stop`` (a float) up to ``iters`` per tile.
    ``with_iters`` also returns each tile's iterations, a (tiles,) int64
    tensor."""
    r, n = P.shape
    inv_L = step_size(G, prec)
    tiles = -(-n // tile)
    pad = tiles * tile - n
    H = torch.nn.functional.pad(H0, (0, pad))
    Pp = torch.nn.functional.pad(P, (0, pad))
    Y = H.clone()
    real = (torch.arange(tiles * tile, device=H.device) < n)[None, :]
    t = torch.ones(tiles, device=H.device)
    done = torch.zeros(tiles, dtype=torch.bool, device=H.device)
    ran = torch.zeros(tiles, dtype=torch.int64, device=H.device)
    v0 = onmf._start(r, H.device)
    vd = v0.expand(tiles, r).clone()
    vh = vd.clone()
    stop2 = None if stop is None else float(
        torch.tensor(stop, dtype=torch.float32) ** 2)
    for _ in range(iters):
        if stop is not None and bool(done.all()):
            break
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        mom = ((t - 1.0) / tn).repeat_interleave(tile)[None, :]
        grad = prec.mm(G, Y) - Pp + alpha
        Hn = torch.where(real, torch.clamp_min(Y - inv_L * grad, 0.0), 0.0)
        D = Hn - H
        live = ~done
        ran += live
        if stop is not None:
            now, vd, vh = _decide(
                D.view(r, tiles, tile).transpose(0, 1),
                H.view(r, tiles, tile).transpose(0, 1), vd, vh, v0, stop2,
                prec)
        cols = live.repeat_interleave(tile)[None, :]
        H = torch.where(cols, Hn, H)
        Y = torch.where(cols, Hn + mom * D, Y)
        t = torch.where(live, tn, t)
        if stop is not None:
            done = done | (live & now)
    H = H[:, :n]
    return (H, ran) if with_iters else H


def step(st: onmf.State, X, H0, t: float, cfg: dict, prec: onmf.Prec):
    """One online step on the batch X (d, n) from the code start H0 at
    counter ``t``: code X against W by FISTA (the configuration's stop
    unless ``fast``), then ``onmf.update`` with weight 1 / t (the
    dictionary pass from the aggregates as they were before the step).
    Returns the code."""
    G = prec.mm(st.W.T, st.W)
    P = prec.mm(st.W.T, X)
    stop = None if cfg["fast"] else cfg["stopping_diff"]
    H = fista(G, P, H0, cfg["alpha"], cfg["sub_iter"], stop, cfg["tile"],
              prec)
    st.W, st.A, st.B = onmf.update(st.W, st.A, st.B, H, X, 1.0 / t, prec)
    return H


def train(img, seed: int, cfg: dict, rounds: int, prec: onmf.Prec):
    """``rounds`` rounds of the tensor learner from a fresh state (one
    ``train_dict`` call of the port); returns the state (W, A, B)."""
    onmf.fixed_float32()
    dev = img.device
    r, k, n = cfg["n_components"], cfg["patch_size"], cfg["num_patches"]
    batch = cfg["batch_size"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = onmf.State.fresh(torch.rand((3 * k * k, r), generator=gen,
                                     device=dev))
    Hi, Wi = img.shape[0], img.shape[1]
    iters = cfg["sub_iterations"]
    t = 0.0
    for _ in range(rounds):
        a = torch.randint(0, Hi - k, (n,), generator=gen, device=dev)
        b = torch.randint(0, Wi - k, (n,), generator=gen, device=dev)
        X = unfold_joint(patch_tensor(img, a, b, k), cfg["mode"])
        for i in range(1, iters):
            idx = torch.randint(0, n, (batch,), generator=gen, device=dev)
            H0 = torch.rand((r, batch), generator=gen, device=dev)
            step(st, X[:, idx], H0, t + i, cfg, prec)
        t += iters
    return st


def reconstruct(img, W, cfg: dict, prec: onmf.Prec):
    """Code every patch of the strided grid by FISTA from a uniform start
    (seed 29) with ``sub_iter`` fixed iterations at the reconstruction's
    alpha, and average the values W H that cover each pixel; pixels no
    patch covers are 0."""
    onmf.fixed_float32()
    k, s = cfg["patch_size"], cfg["recons_stride"]
    ni, nj = image.grid(img, k, s)
    dev = img.device
    ii = torch.arange(ni, device=dev) * s
    jj = torch.arange(nj, device=dev) * s
    X = image.patches(img, ii.repeat_interleave(nj), jj.repeat(ni), k)
    G = prec.mm(W.T, W)
    P = prec.mm(W.T, X)
    del X
    gen = torch.Generator(device=dev).manual_seed(29)
    H0 = torch.rand((W.shape[1], P.shape[1]), generator=gen, device=dev)
    Hc = fista(G, P, H0, cfg["recons_alpha"], cfg["sub_iter"], None,
               cfg["tile"], prec)
    del P, H0
    V = prec.mm(W, Hc).view(k, k, 3, ni, nj)
    acc = torch.zeros_like(img)
    cnt = torch.zeros(img.shape[:2], device=dev)
    span_i, span_j = (ni - 1) * s + 1, (nj - 1) * s + 1
    for di in range(k):
        for dj in range(k):
            acc[di:di + span_i:s, dj:dj + span_j:s, :] += \
                V[di, dj].permute(1, 2, 0)
            cnt[di:di + span_i:s, dj:dj + span_j:s] += 1.0
    return acc / torch.clamp_min(cnt, 1.0)[..., None]

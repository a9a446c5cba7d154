"""Plain reference of the image configuration: online dictionary learning
on random colour patches and reconstruction by coding every patch of a
grid and averaging the overlaps. Plain PyTorch on the device of its
inputs; imports nothing of the port.

Randomness: the learner draws from one ``torch.Generator`` seeded with
the learner's seed, in this order: the initial dictionary (uniform, (d,
r)); then each round the patches' top-left corners (rows, then columns,
uniform over 0 .. H - k - 1) and each inner step's code start (uniform,
(r, n)). The reconstruction's code start is drawn from a generator seeded
with 17. These are the calls the port makes; the reference makes them
itself from the seeds, on a generator of the same device.
"""

from __future__ import annotations

import torch

from benchport.reference import onmf


def patches(img: torch.Tensor, rows, cols, k: int) -> torch.Tensor:
    """The (k*k*3, n) matrix of the k x k patches at the corners
    (rows, cols): entry ((di * k + dj) * 3 + c, m) is pixel
    (rows[m] + di, cols[m] + dj) of channel c."""
    out = []
    for di in range(k):
        for dj in range(k):
            out.append(img[rows + di, cols + dj, :])     # (n, 3)
    return torch.stack(out, 0).permute(0, 2, 1).reshape(-1, rows.shape[0])


def train(img, seed: int, cfg: dict, rounds: int, prec: onmf.Prec):
    """``rounds`` rounds of the image learner from a fresh state; returns
    the state (W, A, B)."""
    dev = img.device
    r, k, n = cfg["n_components"], cfg["patch_size"], cfg["num_patches"]
    d = 3 * k * k
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = onmf.State.fresh(torch.rand((d, r), generator=gen, device=dev))
    H, Wd = img.shape[0], img.shape[1]
    stop = None if cfg["fast"] else cfg["stopping_diff"]
    iters = cfg["sub_iterations"]
    t = 0.0
    for _ in range(rounds):
        a = torch.randint(0, H - k, (n,), generator=gen, device=dev)
        b = torch.randint(0, Wd - k, (n,), generator=gen, device=dev)
        X = patches(img, a, b, k)
        for i in range(1, iters):
            H0 = torch.rand((r, n), generator=gen, device=dev)
            onmf.step(st, X, H0, t + i, alpha=cfg["alpha"],
                      sweeps=cfg["sub_iter"], stop=stop, tile=cfg["tile"],
                      prec=prec)
        t += iters
    return st


def grid(img, k: int, stride: int):
    """The grid's corner counts (rows, columns): starts 0, stride, ...
    below H - k (the last start excluded)."""
    return (-(-(img.shape[0] - k) // stride),
            -(-(img.shape[1] - k) // stride))


def reconstruct(img, W, cfg: dict, prec: onmf.Prec):
    """Code every patch of the strided grid from a uniform start (seed
    17) with fixed sweeps at the reconstruction's alpha, and average the
    values W H that cover each pixel; pixels no patch covers are 0."""
    k, s = cfg["patch_size"], cfg["recons_stride"]
    ni, nj = grid(img, k, s)
    dev = img.device
    ii = torch.arange(ni, device=dev) * s
    jj = torch.arange(nj, device=dev) * s
    rows = ii.repeat_interleave(nj)
    cols = jj.repeat(ni)
    X = patches(img, rows, cols, k)
    G = prec.mm(W.T, W)
    P = prec.mm(W.T, X)
    del X
    gen = torch.Generator(device=dev).manual_seed(17)
    H0 = torch.rand((W.shape[1], P.shape[1]), generator=gen, device=dev)
    Hc = onmf.code_fixed(G, P, H0, cfg["recons_alpha"], cfg["sub_iter"],
                         prec)
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

"""Plain online NMF, written from the method's equations: the nonnegative
sparse coder, the dictionary's column pass and one online step. Plain
PyTorch, float32, on whatever device its inputs are on; nothing of the
port is imported.

``Prec`` carries the precision of the products. Sound: float32 with TF32
off. The control (``tf32=True``): every product's operands rounded to
TF32's 10 mantissa bits first, the precision one step below float32,
identically on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 explicit mantissa bits, to
    nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Prec:
    """The precision of a run of the reference."""

    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32(a), tf32(b)
        return a @ b


def fixed_float32() -> None:
    """Products on the card in true float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sweep(H, G, P, alpha, scale, prec: Prec):
    """One Gauss-Seidel sweep over the rows of H (in place): row k moves
    by the projected gradient step scale / (G_kk + 1) on
    0.5|X - W H|^2 + alpha |H|_1, with G = W^T W and P = W^T X, and scale
    = 1 / sqrt(i + 10) at sweep i (a float or a 0-d tensor). Each
    column's rows depend on that column alone. No value is read to the
    host, so a sweep can be captured as a CUDA graph."""
    steps = (torch.diagonal(G) + 1.0).reciprocal() * scale
    for k in range(H.shape[0]):
        grad = prec.mm(G[k:k + 1], H)[0]
        grad.sub_(P[k]).add_(alpha)
        H[k].sub_(grad.mul_(steps[k])).clamp_(min=0.0)
    return H


def code_fixed(G, P, H0, alpha: float, sweeps: int, prec: Prec):
    """The code after exactly ``sweeps`` sweeps from H0."""
    H = H0.clone()
    for i in range(sweeps):
        sweep(H, G, P, alpha, 1.0 / math.sqrt(i + 10.0), prec)
    return H


# The early stop's warm power steps where the certified bounds do not
# decide (``pi_iters`` of the method's early-stop coder).
PI_ITERS = 12


def _start(r: int, dev) -> torch.Tensor:
    """The power steps' fixed positive start vector (r,)."""
    k = torch.arange(r, device=dev)
    return 0.5 + ((k * 40503) % 65536).to(torch.float32) / 65536.0


def _power(G, v, iters: int, prec: Prec):
    """``iters`` normalised power steps of each tile's Gram G (T, r, r)
    from v (T, r), then the Rayleigh quotient; returns (quotient, v)."""
    w = prec.mm(G, v[..., None])[..., 0]
    for _ in range(iters):
        v = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=1,
                                                         keepdim=True), 1e-30)
        w = prec.mm(G, v[..., None])[..., 0]
    return (v * w).sum(1) / torch.clamp_min((v * v).sum(1), 1e-30), v


def _upper(G):
    """A certified upper bound of each PSD Gram's largest eigenvalue:
    min(trace, largest absolute row sum)."""
    return torch.minimum(torch.diagonal(G, dim1=1, dim2=2).sum(1),
                         G.abs().sum(2).amax(1))


def code_tile_stop(G, P, H0, alpha: float, sweeps: int, stop: float,
                   tile: int, prec: Prec):
    """The code under the per-tile early stop: the columns in tiles of
    ``tile``; a tile stops, keeping its columns from then on, after the
    first sweep whose change D and start H_old have
    lambda_max(D D^T) <= stop^2 lambda_max(H_old H_old^T), or after
    ``sweeps``. The eigenvalues are decided as the method defines the
    rule: certified bounds first (below, the Rayleigh quotients after one
    warm power step; above, :func:`_upper`), and :data:`PI_ITERS` more warm
    power steps, compared, only where the bounds do not decide; each
    tile's two eigenvector estimates start at :func:`_start`, carry from
    sweep to sweep, and have 0.05 of the start mixed in before each
    decision. Nothing is read to the host."""
    r, n = P.shape
    tiles = -(-n // tile)
    pad = tiles * tile - n
    H = torch.nn.functional.pad(H0, (0, pad))
    Pp = torch.nn.functional.pad(P, (0, pad))
    v0 = _start(r, H.device)
    vd = v0.expand(tiles, r).clone()
    vh = vd.clone()
    done = torch.zeros(tiles, dtype=torch.bool, device=H.device)
    stop2 = float(np.float32(stop) * np.float32(stop))
    for i in range(sweeps):
        old = H.clone()
        sweep(H, G, Pp, alpha, 1.0 / math.sqrt(i + 10.0), prec)
        H = torch.where(done.repeat_interleave(tile)[None, :], old, H)
        D = (H - old).view(r, tiles, tile).transpose(0, 1)
        O = old.view(r, tiles, tile).transpose(0, 1)
        Gd = prec.mm(D, D.transpose(1, 2))
        Gh = prec.mm(O, O.transpose(1, 2))
        lb_d, vd = _power(Gd, vd + 0.05 * v0, 1, prec)
        lb_h, vh = _power(Gh, vh + 0.05 * v0, 1, prec)
        certain_stop = _upper(Gd) <= stop2 * lb_h
        band = ~(certain_stop | (lb_d > stop2 * _upper(Gh)))
        num, vd_band = _power(Gd, vd, PI_ITERS, prec)
        den, vh_band = _power(Gh, vh, PI_ITERS, prec)
        done = done | torch.where(band, num <= stop2 * den, certain_stop)
        vd = torch.where(band[:, None], vd_band, vd)
        vh = torch.where(band[:, None], vh_band, vh)
    return H[:, :n]


def dict_pass(W, A, B, prec: Prec):
    """One pass over W's columns in order, each a step toward the
    aggregates' minimiser, projected onto the nonnegative unit ball:
    W_j <- max(W_j - (W A_j - B_j) / (A_jj + 1), 0), then / max(1, |W_j|)."""
    W = W.clone()
    for j in range(W.shape[1]):
        grad = prec.mm(W, A[:, j:j + 1])[:, 0] - B[j]
        col = torch.clamp_min(W[:, j] - grad / (A[j, j] + 1.0), 0.0)
        W[:, j] = col / torch.clamp_min(torch.linalg.vector_norm(col), 1.0)
    return W


@dataclasses.dataclass
class State:
    """The learner's state: dictionary W (d, r), aggregates A (r, r) and
    B (r, d)."""

    W: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor

    @classmethod
    def fresh(cls, W):
        r, d = W.shape[1], W.shape[0]
        return cls(W=W, A=W.new_zeros((r, r)), B=W.new_zeros((r, d)))


def update(W, A, B, H, X, w, prec: Prec):
    """The dictionary and aggregates after a step's code H of X: W by one
    column pass from the aggregates as they were before the step, then
    the batch's statistics blended into them with weight w."""
    W1 = dict_pass(W, A, B, prec)
    A1 = A * (1.0 - w) + prec.mm(H, H.T) * w
    B1 = B * (1.0 - w) + prec.mm(H, X.T) * w
    return W1, A1, B1


def train_step(W, A, B, X, H0, w, *, alpha: float, sweeps: int, stop,
               tile: int, prec: Prec):
    """One online step as a function of its tensors: the code of X from
    H0 (fixed sweeps where ``stop`` is None, else the per-tile early
    stop), then :func:`update` with weight w. Returns (W, A, B, H)."""
    G = prec.mm(W.T, W)
    P = prec.mm(W.T, X)
    if stop is None:
        H = code_fixed(G, P, H0, alpha, sweeps, prec)
    else:
        H = code_tile_stop(G, P, H0, alpha, sweeps, stop, tile, prec)
    return update(W, A, B, H, X, w, prec) + (H,)


def step(st: State, X, H0, t: float, *, alpha: float, sweeps: int, stop,
         tile: int, prec: Prec):
    """One online step on the batch X (d, n) from the code start H0 at
    counter ``t`` (:func:`train_step` with w = 1 / t, replayed as one
    CUDA graph on the card): code X against W, update W by one column
    pass from the aggregates as they were before this step, then blend
    the batch's statistics into the aggregates. Returns the code."""
    w = torch.full((), 1.0 / t, dtype=torch.float64, device=X.device)
    key = ("step", float(alpha), sweeps, stop, tile, prec)
    st.W, st.A, st.B, H = graphed(
        key, lambda *a: train_step(*a, alpha=alpha, sweeps=sweeps,
                                   stop=stop, tile=tile, prec=prec),
        st.W, st.A, st.B, X, H0, w)
    return H


_GRAPHS: dict = {}


def graphed(key, fn, *args):
    """``fn(*args)``, a tuple of tensors computed from the tensors
    ``args`` alone and read by no host code. On the card each ``key`` is
    captured once as a CUDA graph over copies of its arguments, and each
    call copies the arguments in, replays the same kernels and returns
    copies of the outputs: the launches of a step's hundreds of small
    operations cost one. The key holds the arguments' strides, since
    cuBLAS rounds a product by its operands' layout. Elsewhere ``fn`` is
    called as it is."""
    dev = args[0].device
    if dev.type != "cuda":
        return fn(*args)
    key = (key, dev, tuple((tuple(a.shape), a.stride(), a.dtype)
                           for a in args))
    entry = _GRAPHS.get(key)
    if entry is None:
        static = [a.clone() for a in args]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):       # lazy set-up, outside capture
            fn(*[a.clone() for a in args])
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*static)
        entry = _GRAPHS[key] = (graph, static, out)
    graph, static, out = entry
    for dst, src in zip(static, args):
        dst.copy_(src)
    graph.replay()
    return tuple(o.clone() for o in out)


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest entry of |got - want| over the largest of |want|."""
    got, want = got.double(), want.double()
    den = float(want.abs().max())
    return float((got - want).abs().max()) / max(den, 1e-30)

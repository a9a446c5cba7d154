"""The online-NMF optimizer state.

PyTorch counterpart of ``onmf_ontf_ndl_tpu/models/state.py``: the warm-start
state the reference threads through ``ini_dict / ini_A / ini_B / ini_C /
history`` is one frozen dataclass of tensors plus a ``torch.Generator``.

Two differences from the JAX pytree:

- ``t`` is a Python float. The step counter only feeds the host-side
  ``t^-beta`` weight, so keeping it on the host avoids a device sync and a
  scalar kernel per step.
- ``gen`` is a stateful ``torch.Generator`` on the state's device (a CUDA
  tensor needs a CUDA generator). ``dataclasses.replace`` shares it, so a
  chunked run draws the same stream as an uninterrupted one. Its numbers
  differ from JAX's threefry stream for the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["OnmfState", "init_state", "make_generator", "state_from_numpy",
           "state_to_numpy"]


@dataclasses.dataclass(frozen=True)
class OnmfState:
    """Full state of the online NMF optimizer.

    Attributes:
      W: (d, r) dictionary, nonnegative, columns in the unit L2 ball.
      A: (r, r) streaming aggregate of the code second moment H H^T.
      B: (r, d) streaming aggregate of the code-data cross moment H X^T.
      C: (d, d) aggregate of X X^T, or a (0, 0) placeholder when untracked.
      t: float iteration counter ("history") driving the t^-beta schedule.
      gen: generator for minibatch subsampling and code initialization.
      sharding: None, or where W's columns and B's rows are split over a
        mesh axis (``parallel/auto.py::shard_state``): W and B are then
        this rank's shard, (d, r / tp) and (r / tp, d).
    """

    W: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    t: float
    gen: torch.Generator
    sharding: object = None

    @property
    def d(self) -> int:
        return self.W.shape[0]

    @property
    def r(self) -> int:
        return self.W.shape[1]

    @property
    def tracks_xxt(self) -> bool:
        return self.C.numel() > 0


def entry_device(device) -> torch.device:
    """The device of an entry point. Entry points default to ``"cuda"``;
    where CUDA is missing that raises, and CPU runs pass ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return device


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def init_state(
    seed: int | torch.Generator,
    d: int,
    r: int,
    *,
    device="cuda",
    dtype=torch.float32,
    track_xxt: bool = False,
    W=None,
    A=None,
    B=None,
    C=None,
    t: float = 0.0,
) -> OnmfState:
    """Create a fresh (or warm-started) optimizer state on ``device``.

    ``seed`` is an int or a ``torch.Generator`` already on ``device``. With
    no warm-start arrays: uniform-random W and zero aggregates, the
    reference's cold start.
    """
    device = entry_device(device)
    gen = seed if isinstance(seed, torch.Generator) \
        else make_generator(seed, device)
    # validate warm-start shapes here, before any training loop sees them
    for name, arr, want in (("W", W, (d, r)), ("A", A, (r, r)),
                            ("B", B, (r, d)),
                            ("C", C, (d, d) if track_xxt else None)):
        if arr is not None and want is not None \
                and tuple(np.shape(arr)) != want:
            raise ValueError(
                f"init_state: {name} has shape {tuple(np.shape(arr))}, "
                f"expected {want} for d={d}, r={r}")

    def cast(arr):
        return torch.as_tensor(arr, dtype=dtype, device=device).clone()

    if W is None:
        W = torch.rand((d, r), generator=gen, dtype=dtype, device=device)
    else:
        W = cast(W)
    A = torch.zeros((r, r), dtype=dtype, device=device) if A is None \
        else cast(A)
    B = torch.zeros((r, d), dtype=dtype, device=device) if B is None \
        else cast(B)
    if C is None:
        C = torch.zeros((d, d) if track_xxt else (0, 0), dtype=dtype,
                        device=device)
    else:
        C = cast(C)
    return OnmfState(W=W, A=A, B=B, C=C, t=float(t), gen=gen)


def state_from_numpy(W, A, B, C, t, *, seed: int = 0, device="cuda",
                     dtype=torch.float32) -> OnmfState:
    """Build a state from host arrays (e.g. a JAX ``OnmfState`` converted
    with ``np.asarray``). ``C`` may be ``None`` or (0, 0) when untracked."""
    W = np.asarray(W)
    C = None if C is None or np.size(C) == 0 else np.asarray(C)
    return init_state(seed, W.shape[0], W.shape[1], device=device,
                      dtype=dtype, track_xxt=C is not None, W=W,
                      A=np.asarray(A), B=np.asarray(B), C=C, t=float(t))


def state_to_numpy(state: OnmfState) -> dict:
    """Host copies of the state's arrays: ``W, A, B, C`` and ``t``."""
    return dict(W=state.W.cpu().numpy(), A=state.A.cpu().numpy(),
                B=state.B.cpu().numpy(), C=state.C.cpu().numpy(),
                t=float(state.t))

"""Checkpoint / resume for the optimizer state.

Counterpart of ``onmf_ontf_ndl_tpu/utils/checkpoint.py`` with the same
``.npz`` layout (``W, A, B, C, t, key_data, key_impl`` plus ``extra_*``
arrays), so each package loads the other's files:

- the port writes ``key_data``/``key_impl`` as the threefry key
  ``jax.random.key(seed)`` of its generator's seed, which the JAX
  ``load_state`` accepts; beside them it keeps ``torch_rng_state`` and
  ``torch_rng_device``, from which it restores its own stream exactly;
- loading a JAX checkpoint seeds the generator from ``key_data``.

The random stream itself does not cross frameworks: a resumed run draws
the same numbers as an uninterrupted one only within one framework.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from onmf_ontf_ndl_tpu_torch.models.state import (OnmfState, entry_device,
                                                  make_generator)

__all__ = ["save_state", "load_state", "checkpoint_exists"]


def _norm_path(path: str) -> str:
    """np.savez appends '.npz' to suffix-less paths; normalize up front so
    save/load/exists agree on the on-disk name."""
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def checkpoint_exists(path: str) -> bool:
    """Whether a checkpoint written by :func:`save_state` exists."""
    return os.path.exists(_norm_path(path))


def save_state(path: str, state: OnmfState, extra: dict | None = None) -> None:
    """Write ``state`` (plus optional named auxiliary arrays) to ``.npz``."""
    seed = state.gen.initial_seed()
    W = state.W.cpu().numpy()
    arrays = dict(
        W=W,
        A=state.A.cpu().numpy(),
        B=state.B.cpu().numpy(),
        C=state.C.cpu().numpy(),
        t=np.asarray(state.t, dtype=W.dtype),
        key_data=np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                            dtype=np.uint32),
        key_impl=np.bytes_(b"threefry2x32"),
        torch_rng_state=state.gen.get_state().numpy(),
        torch_rng_device=np.bytes_(state.gen.device.type.encode()),
    )
    for name, value in (extra or {}).items():
        arrays["extra_" + name] = np.asarray(value)
    np.savez(_norm_path(path), **arrays)


def _text(arr) -> str:
    s = np.asarray(arr).item()
    return s.decode() if isinstance(s, bytes) else str(s)


def load_state(path: str, *, device="cuda", dtype=None,
               with_extra: bool = False):
    """Restore an OnmfState written by :func:`save_state` or by the JAX
    ``save_state``, on ``device``. ``dtype`` recasts the optimizer arrays
    (default: as saved). ``with_extra=True`` also returns the auxiliary
    arrays, in their saved dtypes."""
    device = entry_device(device)
    with np.load(_norm_path(path)) as z:
        def cast(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        gen = None
        if "torch_rng_state" in z.files \
                and _text(z["torch_rng_device"]) == device.type:
            gen = torch.Generator(device=device)
            gen.set_state(torch.from_numpy(np.array(z["torch_rng_state"])))
        if gen is None:
            hi, lo = (int(v) for v in np.asarray(z["key_data"]).ravel()[-2:])
            gen = make_generator((hi << 32) | lo, device)
        state = OnmfState(W=cast(z["W"]), A=cast(z["A"]), B=cast(z["B"]),
                          C=cast(z["C"]), t=float(z["t"]), gen=gen)
        if with_extra:
            extra = {name[len("extra_"):]: torch.as_tensor(z[name],
                                                           device=device)
                     for name in z.files if name.startswith("extra_")}
            return state, extra
        return state

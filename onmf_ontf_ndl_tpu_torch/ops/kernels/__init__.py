"""Hand-written CUDA kernels for Hopper and backend selection.

Counterpart of ``onmf_ontf_ndl_tpu/ops/pallas/``. The kernels are built
with ``nvcc`` at first use (``_lib.build``); importing this package
builds nothing.
"""

import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels.coder_kernel import (
    coder_sweeps,
    coder_sweeps_earlystop,
    dict_update_sweep,
    fista_sweeps,
)

__all__ = [
    "coder_sweeps", "coder_sweeps_earlystop", "dict_update_sweep",
    "fista_sweeps", "resolve_backend",
]


def resolve_backend(backend: str, tensor: torch.Tensor) -> str:
    """Resolve ``backend`` for the device ``tensor`` lives on.

    ``"auto"`` is ``"cuda"`` (the kernels) for a CUDA tensor and
    ``"torch"`` (plain PyTorch) for a CPU tensor. An explicit ``"cuda"``
    on a tensor that is not on a CUDA device raises.
    """
    if backend not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    on_cuda = tensor.device.type == "cuda"
    if backend == "auto":
        return "cuda" if on_cuda else "torch"
    if backend == "cuda" and not on_cuda:
        raise ValueError(
            f"backend='cuda' needs a CUDA tensor, got one on {tensor.device}")
    return backend

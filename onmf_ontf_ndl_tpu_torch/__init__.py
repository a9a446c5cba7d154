"""PyTorch/CUDA port of ``onmf_ontf_ndl_tpu``: online NMF on an NVIDIA H100.

Same layout and names as the JAX package, which stays the reference:

- ``ops``      : nonnegative sparse coders (Gauss-Seidel sweeps, FISTA),
                 BCD dictionary update, patch ops, tensor unfolding, and
                 ``ops/kernels`` (hand-written CUDA kernels for sm_90a in
                 place of the JAX package's ``ops/pallas``);
- ``models``   : ``OnmfState``, ``onmf_step`` / ``train_dict`` (one step
                 captured as a CUDA graph and replayed, in place of
                 ``lax.scan``), ``OnlineNMF``, ``OnlineNTF``;
- ``samplers`` : the Ising Metropolis chain and checkerboard sweeps, the
                 motif-homomorphism chains of network dictionary learning;
- ``data``     : images, video frames, graphs (dense, CSR, bitset) and the native loader;
- ``apps`` (``ImageReconstructor``, ``ImageReconstructorTensor``,
                 ``IsingReconstructor``, ``NetworkReconstructor``,
                 ``VideoDictionaryLearner``),
  ``utils`` (checkpoint, metrics).

Every constructor takes ``device=``; randomness comes from explicit
``torch.Generator``s. Importing the package builds no kernel and imports
no JAX.
"""

import torch

# The JAX reference numerics are compared in full float32, so TF32 stays
# off for matmuls and for convolutions on the card (cuDNN defaults it on).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from onmf_ontf_ndl_tpu_torch.models.state import (  # noqa: E402
    OnmfState, init_state, state_from_numpy, state_to_numpy)
from onmf_ontf_ndl_tpu_torch.models.onmf import (  # noqa: E402
    OnlineNMF, onmf_step, train_dict)
from onmf_ontf_ndl_tpu_torch.models.ontf import OnlineNTF  # noqa: E402
from onmf_ontf_ndl_tpu_torch.ops.coder import (  # noqa: E402
    nonneg_code, nonneg_code_gram)

__version__ = "0.1.0"

__all__ = [
    "OnmfState",
    "init_state",
    "state_from_numpy",
    "state_to_numpy",
    "OnlineNMF",
    "OnlineNTF",
    "onmf_step",
    "train_dict",
    "nonneg_code",
    "nonneg_code_gram",
    "ImageReconstructor",
    "ImageReconstructorTensor",
    "IsingReconstructor",
    "NetworkReconstructor",
    "VideoDictionaryLearner",
]

_APPS = {
    "ImageReconstructor": "onmf_ontf_ndl_tpu_torch.apps.image",
    "ImageReconstructorTensor": "onmf_ontf_ndl_tpu_torch.apps.image_tensor",
    "IsingReconstructor": "onmf_ontf_ndl_tpu_torch.apps.ising",
    "NetworkReconstructor": "onmf_ontf_ndl_tpu_torch.apps.network",
    "VideoDictionaryLearner": "onmf_ontf_ndl_tpu_torch.apps.video",
}


def __getattr__(name):
    # lazy app exports (they pull in PIL only when used)
    if name in _APPS:
        import importlib

        return getattr(importlib.import_module(_APPS[name]), name)
    raise AttributeError(name)

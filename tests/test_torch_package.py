"""Package-level properties of the PyTorch port."""

import subprocess
import sys

import pytest
import torch

from onmf_ontf_ndl_tpu_torch.ops.kernels import resolve_backend

torch.set_num_threads(1)

_PROBE = """
import sys, torch
import onmf_ontf_ndl_tpu_torch as p
import onmf_ontf_ndl_tpu_torch.apps.image
import onmf_ontf_ndl_tpu_torch.apps.image_tensor
import onmf_ontf_ndl_tpu_torch.apps.ising
import onmf_ontf_ndl_tpu_torch.apps.network
import onmf_ontf_ndl_tpu_torch.data.graphs
import onmf_ontf_ndl_tpu_torch.data.native as native
import onmf_ontf_ndl_tpu_torch.models.ontf
import onmf_ontf_ndl_tpu_torch.ops.unfold
import onmf_ontf_ndl_tpu_torch.samplers.ising
import onmf_ontf_ndl_tpu_torch.samplers.motif
import onmf_ontf_ndl_tpu_torch.utils
from onmf_ontf_ndl_tpu_torch.ops.kernels import coder_kernel, ising_kernel
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not any(m.startswith("onmf_ontf_ndl_tpu.") or m == "onmf_ontf_ndl_tpu"
               for m in sys.modules)
assert coder_kernel.build.cache_info().currsize == 0   # nothing built
assert native._get_lib.cache_info().currsize == 0      # nor the loader
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
assert "triton" not in sys.modules
assert p.IsingReconstructor.__name__ == "IsingReconstructor"
assert p.ImageReconstructorTensor.__name__ == "ImageReconstructorTensor"
assert p.NetworkReconstructor.__name__ == "NetworkReconstructor"
assert coder_kernel.build.cache_info().currsize == 0   # still nothing built
print("ok", p.ImageReconstructor.__name__)
"""


def test_port_imports_without_jax_and_builds_nothing():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok ImageReconstructor"


def test_resolve_backend_by_tensor_device():
    x = torch.zeros(3)
    assert resolve_backend("auto", x) == "torch"
    assert resolve_backend("torch", x) == "torch"
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        resolve_backend("cuda", x)
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas", x)

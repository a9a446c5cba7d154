from onmf_ontf_ndl_tpu_torch.utils.checkpoint import load_state, save_state
from onmf_ontf_ndl_tpu_torch.utils.metrics import (
    code_covariance,
    relative_recon_error,
    surrogate_error,
)

__all__ = ["load_state", "save_state", "code_covariance",
           "relative_recon_error", "surrogate_error"]

from onmf_ontf_ndl_tpu_torch.models.state import OnmfState, init_state
from onmf_ontf_ndl_tpu_torch.models.onmf import OnlineNMF, onmf_step, train_dict

__all__ = ["OnmfState", "init_state", "OnlineNMF", "onmf_step", "train_dict"]

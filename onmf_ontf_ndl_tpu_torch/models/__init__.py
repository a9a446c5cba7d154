from onmf_ontf_ndl_tpu_torch.models.state import OnmfState, init_state
from onmf_ontf_ndl_tpu_torch.models.onmf import OnlineNMF, onmf_step, train_dict
from onmf_ontf_ndl_tpu_torch.models.ontf import OnlineNTF

__all__ = ["OnmfState", "init_state", "OnlineNMF", "OnlineNTF", "onmf_step",
           "train_dict"]

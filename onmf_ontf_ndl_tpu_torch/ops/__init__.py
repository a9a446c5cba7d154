from onmf_ontf_ndl_tpu_torch.ops.coder import nonneg_code, nonneg_code_gram
from onmf_ontf_ndl_tpu_torch.ops.dict_update import dict_update_bcd

__all__ = ["nonneg_code", "nonneg_code_gram", "dict_update_bcd"]

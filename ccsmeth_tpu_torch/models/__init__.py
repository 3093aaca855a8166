from .config import AggrConfig, AttRNNConfig, TransEncConfig
from .attrnn import AttRNN, init_attrnn
from .convert import (attrnn_params_from_state_dict, attrnn_state_dict_from_params,
                      torch_ckpt_to_params)

__all__ = [
    "AggrConfig",
    "AttRNNConfig",
    "TransEncConfig",
    "AttRNN",
    "init_attrnn",
    "attrnn_params_from_state_dict",
    "attrnn_state_dict_from_params",
    "torch_ckpt_to_params",
]

from .config import AggrConfig, AttRNNConfig, TransEncConfig
from .attrnn import AttRNN, init_attrnn
from .transenc import TransEnc, init_transenc
from .convert import (attrnn_params_from_state_dict, attrnn_state_dict_from_params,
                      torch_ckpt_to_params, transenc_params_from_state_dict,
                      transenc_state_dict_from_params)

__all__ = [
    "AggrConfig",
    "AttRNNConfig",
    "TransEncConfig",
    "AttRNN",
    "TransEnc",
    "init_attrnn",
    "init_transenc",
    "attrnn_params_from_state_dict",
    "attrnn_state_dict_from_params",
    "torch_ckpt_to_params",
    "transenc_params_from_state_dict",
    "transenc_state_dict_from_params",
]

from .config import AggrConfig, AttRNNConfig, TransEncConfig
from .attrnn import AggrAttRNN, AttRNN, init_aggr_attrnn, init_attrnn
from .transenc import TransEnc, init_transenc
from .convert import (aggr_params_from_state_dict, aggr_state_dict_from_params,
                      attrnn_params_from_state_dict, attrnn_state_dict_from_params,
                      torch_ckpt_to_params, transenc_params_from_state_dict,
                      transenc_state_dict_from_params)

__all__ = [
    "AggrConfig",
    "AttRNNConfig",
    "TransEncConfig",
    "AggrAttRNN",
    "AttRNN",
    "TransEnc",
    "init_aggr_attrnn",
    "init_attrnn",
    "init_transenc",
    "aggr_params_from_state_dict",
    "aggr_state_dict_from_params",
    "attrnn_params_from_state_dict",
    "attrnn_state_dict_from_params",
    "torch_ckpt_to_params",
    "transenc_params_from_state_dict",
    "transenc_state_dict_from_params",
]

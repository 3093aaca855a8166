from .config import AggrConfig, AttRNNConfig, TransEncConfig
from .attrnn import (AggrAttRNN, AttRNN, SrcEmbed, init_aggr_attrnn, init_attrnn,
                     rnn_input_size, take_rows)
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
    "SrcEmbed",
    "TransEnc",
    "init_aggr_attrnn",
    "init_attrnn",
    "init_transenc",
    "rnn_input_size",
    "take_rows",
    "aggr_params_from_state_dict",
    "aggr_state_dict_from_params",
    "attrnn_params_from_state_dict",
    "attrnn_state_dict_from_params",
    "torch_ckpt_to_params",
    "transenc_params_from_state_dict",
    "transenc_state_dict_from_params",
]

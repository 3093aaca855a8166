#!/usr/bin/env python
"""Checkpoint format converter: torch .ckpt (zipfile-serialized) <-> this engine's
.npz params. Capability parity with scripts/unzip_model_ckpt.py
(which re-saves torch-1.6+ zip ckpts for older torch); here the useful conversion
is torch -> native npz and npz inspection.
"""

import argparse
import os

from ..models import AggrConfig, AttRNNConfig, TransEncConfig
from ..models.convert import torch_ckpt_to_params
from ..models.params_io import load_params, save_params


def _cfg(args):
    if args.model_type in ("attbigru", "attbilstm"):
        return AggrConfig(seq_len=args.seq_len, num_layers=args.layer_rnn,
                          hidden_size=args.hid_rnn, model_type=args.model_type)
    if args.model_type == "transencoder2s":
        return TransEncConfig(seq_len=args.seq_len, num_layers=args.layer_tfe,
                              d_model=args.d_model_tfe, dim_ff=args.nhid_tfe,
                              nhead=args.nhead_tfe, num_classes=args.class_num)
    return AttRNNConfig(seq_len=args.seq_len, num_layers=args.layer_rnn,
                        hidden_size=args.hid_rnn, model_type=args.model_type)


def main():
    parser = argparse.ArgumentParser("convert/inspect model checkpoints")
    parser.add_argument("--model_file", type=str, required=True,
                        help=".ckpt (torch) or .npz (native)")
    parser.add_argument("--model_type", type=str, default="attbigru2s",
                        choices=["attbigru2s", "attbilstm2s", "attbigru2s2",
                                 "attbilstm2s2", "attbigru1s", "attbilstm1s",
                                 "transencoder2s", "attbigru", "attbilstm"])
    parser.add_argument("--seq_len", type=int, default=21)
    parser.add_argument("--layer_rnn", type=int, default=3)
    parser.add_argument("--hid_rnn", type=int, default=256)
    parser.add_argument("--class_num", type=int, default=2)
    parser.add_argument("--dropout_rate", type=float, default=0)
    parser.add_argument("--is_stds", type=str, default="no")
    parser.add_argument("--n_vocab", type=int, default=16,
                        help="[compat] vocab size (fixed by the base alphabet)")
    parser.add_argument("--n_embed", type=int, default=4,
                        help="[compat] embedding size (fixed per model family)")
    parser.add_argument("--layer_tfe", type=int, default=6,
                        help="transformer encoder layers (transencoder2s)")
    parser.add_argument("--d_model_tfe", type=int, default=256)
    parser.add_argument("--nhid_tfe", type=int, default=512)
    parser.add_argument("--nhead_tfe", type=int, default=4)
    parser.add_argument("--output", "-o", type=str, default=None,
                        help="write converted .npz here (torch input only)")
    args = parser.parse_args()

    if args.model_file.endswith(".npz"):
        params = load_params(args.model_file)

        def show(tree, prefix=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    show(v, prefix + k + "/")
            elif isinstance(tree, list):
                for i, v in enumerate(tree):
                    show(v, prefix + str(i) + "/")
            else:
                print("{}{}".format(prefix[:-1].ljust(50), tree.shape))

        show(params)
        return
    if args.model_type in ("attbigru", "attbilstm") and args.layer_rnn == 3:
        args.layer_rnn = 1
        args.hid_rnn = 32
        args.seq_len = 11
    cfg = _cfg(args)
    params = torch_ckpt_to_params(args.model_file, cfg)
    out = args.output or (os.path.splitext(args.model_file)[0] + ".npz")
    save_params(out, params)
    print("converted {} -> {}".format(args.model_file, out))


if __name__ == "__main__":
    main()

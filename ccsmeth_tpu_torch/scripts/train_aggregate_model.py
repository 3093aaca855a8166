"""Train the call_freqb aggregate model (AggrAttRNN) on rows from
``scripts/generate_aggre_train_data.py``: the counterpart of the JAX
package's ``scripts/train_aggregate_model.py``, with the same arguments and
``--device``. The best checkpoint loads into ``call_freqb --call_mode
aggregate -m model.npz`` of either package.

    python -m ccsmeth_tpu_torch.scripts.train_aggregate_model \\
        --train_file train.tsv --valid_file valid.tsv --model_dir models \\
        [--model_type attbigru|attbilstm] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

from ..training.aggregate import AggreTrainConfig, train_aggregate


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_file", type=str, required=True)
    parser.add_argument("--valid_file", type=str, required=True)
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--model_type", type=str, default="attbigru",
                        choices=["attbigru", "attbilstm"])
    parser.add_argument("--seq_len", type=int, default=11)
    parser.add_argument("--layer_rnn", type=int, default=1)
    parser.add_argument("--hid_rnn", type=int, default=32)
    parser.add_argument("--bin_size", type=int, default=20)
    parser.add_argument("--dropout_rate", type=float, default=0.5)
    parser.add_argument("--optim_type", type=str, default="Adam")
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--lr_decay", type=float, default=0.1)
    parser.add_argument("--lr_decay_step", type=int, default=1)
    parser.add_argument("--max_epoch_num", type=int, default=50)
    parser.add_argument("--min_epoch_num", type=int, default=5)
    parser.add_argument("--init_model", type=str, default=None)
    parser.add_argument("--tseed", type=int, default=1234)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda[:i] (default; the BiRNN through the "
                             "hand-written kernels) or cpu (their plain "
                             "PyTorch versions); cuda without a GPU raises")
    return parser


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    result = train_aggregate(AggreTrainConfig(
        train_file=args.train_file, valid_file=args.valid_file,
        model_dir=args.model_dir, model_type=args.model_type,
        seq_len=args.seq_len, layer_rnn=args.layer_rnn, hid_rnn=args.hid_rnn,
        bin_size=args.bin_size, dropout_rate=args.dropout_rate,
        optim_type=args.optim_type, batch_size=args.batch_size, lr=args.lr,
        lr_decay=args.lr_decay, lr_decay_step=args.lr_decay_step,
        max_epoch_num=args.max_epoch_num, min_epoch_num=args.min_epoch_num,
        init_model=args.init_model, tseed=args.tseed, device=args.device))
    print("best RMSE {:.5f} at epoch {}".format(result["best_rmse"],
                                                result["best_epoch"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

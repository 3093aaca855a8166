"""The port's ``train`` subcommand: flag parity with the JAX package's CLI
(and of ``call_mods``, ``call_freqb``, ``call_freqt`` and ``extract``),
a CPU run through ``python -m ccsmeth_tpu_torch.cli`` that writes a
checkpoint, and no fallback from ``--device cuda`` without a GPU."""

import argparse
import glob
import os
import subprocess
import sys

import pytest
import torch

from ccsmeth_tpu import cli as jax_cli
from ccsmeth_tpu_torch import cli
from tests.test_training import _write_feature_tsv

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _options(parser, command):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction)).choices[command]
    return {s for a in sub._actions for s in a.option_strings}


def test_train_parser_has_every_jax_option_plus_device():
    want = _options(jax_cli.get_parser(), "train") | {"--device"}
    got = _options(cli.get_parser(), "train")
    assert want <= got, sorted(want - got)
    args = cli.get_parser().parse_args(
        ["train", "--train_file", "a", "--valid_file", "b", "--model_dir", "m"])
    assert (args.device, args.dropout_rate, args.layer_rnn, args.hid_rnn,
            args.batch_size, args.optim_type) == ("cuda", 0.5, 3, 256, 512, "Adam")


def _actions(parser, command):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction)).choices[command]
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.required)
            for a in sub._actions if a.dest != "help"}


@pytest.mark.parametrize("command", ["call_freqb", "call_freqt", "extract"])
def test_new_subcommands_match_the_jax_parser(command):
    """Flags, defaults, choices and required flags of the JAX package's
    subcommand; --device is the only addition (call_freqb, where a model
    runs)."""
    want = _actions(jax_cli.get_parser(), command)
    got = _actions(cli.get_parser(), command)
    if command == "call_freqb":
        assert got.pop("device") == (("--device",), "cuda", None, False)
    assert got == want


def test_call_mods_matches_the_jax_parser():
    """call_mods: every flag, default, choice and required flag of the JAX
    package's parser, but the port's two documented additions: --device and
    --rnn_backend pallas_layer (K2, one launch a layer), which the JAX CLI
    does not offer."""
    want = _actions(jax_cli.get_parser(), "call_mods")
    got = _actions(cli.get_parser(), "call_mods")
    assert got.pop("device") == (("--device",), "cuda", None, False)
    flags, default, choices, required = got.pop("rnn_backend")
    assert choices == want.pop("rnn_backend")[2] + ["pallas_layer"]
    assert (flags, default, required) == (("--rnn_backend",), "xla", False)
    assert got == want


def _files(tmp_path):
    tr, va = str(tmp_path / "tr.tsv"), str(tmp_path / "va.tsv")
    _write_feature_tsv(tr, n=96, seed=1)
    _write_feature_tsv(va, n=32, seed=2)
    return ["--train_file", tr, "--valid_file", va, "--model_dir",
            str(tmp_path / "m"), "--layer_rnn", "1", "--hid_rnn", "8",
            "--batch_size", "32", "--max_epoch_num", "1", "--min_epoch_num", "1",
            "--step_interval", "2"]


def test_cli_train_on_cpu_writes_a_checkpoint(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "ccsmeth_tpu_torch.cli", "train"] + _files(tmp_path)
        + ["--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert glob.glob(str(tmp_path / "m" / "attbigru2s.b21_epoch1.ckpt.npz"))


def test_cli_train_cuda_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["train"] + _files(tmp_path) + ["--device", "cuda"])

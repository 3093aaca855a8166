"""Multi-process training in the port on the CPU, two ``gloo`` ranks.

(a) One step on 2 ranks (B rows each) against the JAX package's
    ``make_train_step`` on a 2-device mesh over the same global batch of 2B
    rows, dropout 0, SGD: the parameters at atol 1e-6, the tolerance of the
    one-process step test (``tests/test_torch_train.py``). attbigru2s, and
    attbigru2s2 with stds, whose SrcEmbed BatchNorms take each rank's
    (each device shard's) own statistics on both sides. The batch ends in
    padding rows, so the ranks' weight sums differ and the loss must be
    normalized by the global sum.
(b) ``trainm`` on 2 ranks through the CLI, ``--train_transfer fp32`` and
    ``packed``: rank 0 alone writes checkpoints, both ranks log the same
    validation lines and stop at the same epoch, and the final checkpoint
    equals a one-process run at batch 2B within 1e-5 (the two ranks' halves
    of each gradient are summed in another order than one batch's); the
    JAX package loads and runs it.
(c) The steps of an epoch are len // (B x 2), the tail dropped, with two
    all-reduces a step and one a validation sweep.

The ranks run through ``tests/test_torch_dist.py::run_ranks``: a timeout of
their own on each rank, every rank killed on expiry.
"""

import glob
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from ccsmeth_tpu.models import AttRNNConfig as JaxAttRNNConfig
from ccsmeth_tpu.models import apply_attrnn
from ccsmeth_tpu.models.params_io import load_params as jax_load_params
from ccsmeth_tpu.parallel.mesh import data_mesh
from ccsmeth_tpu.training.optim import build_optimizer as jax_build_optimizer
from ccsmeth_tpu.training.train import make_train_step as jax_make_train_step
from ccsmeth_tpu_torch.models import AttRNN, AttRNNConfig, attrnn_state_dict_from_params
from ccsmeth_tpu_torch.models import init_attrnn
from ccsmeth_tpu_torch.models.params_io import _flatten, load_params, save_params
from ccsmeth_tpu_torch.training import TrainConfig, train
from ccsmeth_tpu_torch.training.data import load_feature_tsv
from tests.test_torch_dist import free_port, last_json, run_ranks
from tests.test_torch_train import _feats
from tests.test_torch_train2s2 import _batch
from tests.test_training import _write_feature_tsv

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

B = 16  # rows a rank
STEP_RANK = r"""
import json
import numpy as np
import torch
torch.set_num_threads(1)
from ccsmeth_tpu_torch.models import (AttRNN, AttRNNConfig, attrnn_params_from_state_dict,
                                      attrnn_state_dict_from_params)
from ccsmeth_tpu_torch.models.convert import gc_dims
from ccsmeth_tpu_torch.models.params_io import load_params, save_params
from ccsmeth_tpu_torch.parallel import distributed
from ccsmeth_tpu_torch.training import build_optimizer
from ccsmeth_tpu_torch.training.train import make_train_step

rank, B, kw, d = {rank}, {B}, {kw!r}, {d!r}
distributed.init_multihost("127.0.0.1:{port}", 2, rank, "cpu")
try:
    model = AttRNN(AttRNNConfig(**kw))
    model.load_state_dict(attrnn_state_dict_from_params(load_params(d + "/params.npz")))
    batch = np.load(d + "/batch.npz")
    rows = slice(rank * B, (rank + 1) * B)
    feats = {{k[2:]: torch.from_numpy(batch[k][rows]) for k in batch.files
             if k.startswith("f/")}}
    labels = torch.from_numpy(batch["labels"][rows]).long()
    mask = torch.from_numpy(batch["mask"][rows])
    opt = build_optimizer("SGD", 1e-2)
    opt.init(model.parameters(), gc_dims([n for n, _ in model.named_parameters()]))
    loss = make_train_step(model, opt, 1.5)(feats, labels, mask)
    if rank == 0:
        save_params(d + "/stepped.npz", attrnn_params_from_state_dict(model.state_dict()))
    print(json.dumps({{"loss": loss.item(), "calls": distributed.allreduce_calls,
                      "bytes": distributed.allreduce_bytes,
                      "n_params": sum(p.numel() for p in model.parameters())}}))
finally:
    distributed.teardown()
"""


@pytest.mark.parametrize("family", ["attbigru2s", "attbigru2s2_stds"])
def test_one_step_on_two_ranks_matches_jax_two_device_step(family, tmp_path):
    if family == "attbigru2s":
        kw = dict(num_layers=2, hidden_size=16, dropout_rate=0)
        feats, labels = _feats(2 * B, seed=21)
        mask = np.ones(2 * B, np.float32)
        mask[-5:] = 0.0  # rank 1's weight sum is smaller than rank 0's
    else:
        kw = dict(num_layers=2, hidden_size=16, dropout_rate=0,
                  model_type="attbigru2s2", is_stds=True)
        feats, labels, mask = _batch(2 * B, 2 * B - 5, seed=22)
    params = init_attrnn(6, AttRNNConfig(**kw))
    d = str(tmp_path)
    save_params(d + "/params.npz", params)
    np.savez(d + "/batch.npz", labels=labels, mask=mask,
             **{"f/" + k: v for k, v in feats.items()})
    port = free_port()
    outs = run_ranks([STEP_RANK.format(rank=k, B=B, kw=kw, d=d, port=port)
                      for k in (0, 1)])

    tx = jax_build_optimizer("SGD", 1e-2)
    jstep, _mesh = jax_make_train_step(JaxAttRNNConfig(**kw), tx, 1.5,
                                       mesh=data_mesh(jax.devices()[:2]))
    p_j, _o, loss_j = jstep(params, tx.init(params), feats, labels, mask,
                            jax.random.PRNGKey(0))
    got = dict(_flatten(load_params(d + "/stepped.npz")))
    want = dict(_flatten(jax.device_get(p_j)))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
    for out in outs:
        info = last_json(out)
        assert abs(info["loss"] - float(loss_j)) <= 1e-6
        # the weight sum (one float), then the gradients and the loss together
        assert info["calls"] == 2
        assert info["bytes"] == 4 + 4 * (info["n_params"] + 1)


TRAINM_RANK = r"""
import json
import torch
torch.set_num_threads(1)
from ccsmeth_tpu_torch import cli
from ccsmeth_tpu_torch.training.train import LAST_RUN

cli.main(["trainm"] + {argv!r} + ["--model_dir", {mdir!r}, "--num_processes", "2",
          "--process_id", "{rank}", "--dist_coordinator", "127.0.0.1:{port}"])
print(json.dumps({{k: LAST_RUN[k] for k in ("steps", "ckpts", "epoch_wall_s",
                                            "best_accuracy", "world", "backend",
                                            "allreduce_calls", "allreduce_bytes",
                                            "valid_losses")}}))
"""


def _trainm_argv(tr, va, batch, transfer, epochs=(4, 2), interval=2):
    return ["--train_file", tr, "--valid_file", va, "--model_type", "attbigru2s",
            "--layer_rnn", "1", "--hid_rnn", "16", "--batch_size", str(batch),
            "--dropout_rate", "0", "--lr", "0.01", "--max_epoch_num", str(epochs[0]),
            "--min_epoch_num", str(epochs[1]), "--step_interval", str(interval),
            "--tseed", "3", "--train_transfer", transfer, "--device", "cpu"]


def _valid_lines(out):
    """The rank's validation log lines without their wall times."""
    return [re.sub(r"; Time: .*", "", ln[ln.index("Epoch ["):])
            for ln in out.splitlines() if "ValidLoss" in ln]


@pytest.mark.parametrize("transfer", ["fp32", "packed"])
def test_trainm_on_two_ranks_equals_one_process_at_the_global_batch(transfer, tmp_path):
    tr, va = str(tmp_path / "tr.tsv"), str(tmp_path / "va.tsv")
    _write_feature_tsv(tr, n=8 * B * 2, seed=1)  # 8 global batches
    _write_feature_tsv(va, n=4 * B * 2, seed=2)
    argv = _trainm_argv(tr, va, B, transfer)
    port = free_port()
    mdirs = [str(tmp_path / "rank{}".format(k)) for k in (0, 1)]
    outs = run_ranks([TRAINM_RANK.format(argv=argv, mdir=mdirs[k], rank=k, port=port)
                      for k in (0, 1)])
    runs = [last_json(o) for o in outs]
    # rank 0 alone writes
    assert runs[0]["ckpts"] and runs[1]["ckpts"] == []
    assert os.listdir(mdirs[1]) == []
    assert sorted(glob.glob(mdirs[0] + "/attbigru2s.b21_epoch*.ckpt.npz")) \
        == sorted(set(runs[0]["ckpts"]))
    # both ranks see the same validations and stop at the same epoch
    lines = [_valid_lines(o) for o in outs]
    assert lines[0] and lines[0] == lines[1]
    assert len(runs[0]["epoch_wall_s"]) == len(runs[1]["epoch_wall_s"])
    assert runs[0]["valid_losses"] == runs[1]["valid_losses"]
    for r in runs:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["steps"] == 8 * len(r["epoch_wall_s"])

    one = train(TrainConfig(
        train_file=tr, valid_file=va, model_dir=str(tmp_path / "one"),
        model_type="attbigru2s", layer_rnn=1, hid_rnn=16, batch_size=2 * B,
        dropout_rate=0.0, lr=0.01, max_epoch_num=4, min_epoch_num=2,
        step_interval=2, tseed=3, train_transfer=transfer, device="cpu"))
    assert one["world"] == 1 and one["allreduce_calls"] == 0
    assert [os.path.basename(p) for p in one["ckpts"]] \
        == [os.path.basename(p) for p in runs[0]["ckpts"]]
    assert one["steps"] == runs[0]["steps"]
    np.testing.assert_allclose(runs[0]["valid_losses"], one["valid_losses"], atol=1e-5)
    got = dict(_flatten(load_params(runs[0]["ckpts"][-1])))
    want = dict(_flatten(load_params(one["ckpts"][-1])))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)

    # the JAX package reads the rank-0 checkpoint and computes what the port does
    params = jax_load_params(runs[0]["ckpts"][-1])
    kw = dict(num_layers=1, hidden_size=16, dropout_rate=0)
    data = load_feature_tsv(va)
    feats = {k: v[:24] for k, v in data.items() if k != "labels"}
    _l, p_j = apply_attrnn(params, JaxAttRNNConfig(**kw), feats)
    m = AttRNN(AttRNNConfig(**kw))
    m.load_state_dict(attrnn_state_dict_from_params(load_params(runs[0]["ckpts"][-1])))
    with torch.inference_mode():
        _l, p_t = m({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=5e-6)


def test_steps_are_the_length_over_the_global_batch_tail_dropped(tmp_path):
    tr, va = str(tmp_path / "tr.tsv"), str(tmp_path / "va.tsv")
    _write_feature_tsv(tr, n=4 * 2 * B + 27, seed=3)  # 4 global batches + a tail
    _write_feature_tsv(va, n=2 * 2 * B + 9, seed=4)
    argv = _trainm_argv(tr, va, B, "fp32", epochs=(1, 1), interval=100)
    port = free_port()
    outs = run_ranks([TRAINM_RANK.format(argv=argv, mdir=str(tmp_path / "m"),
                                         rank=k, port=port) for k in (0, 1)])
    n_params = sum(p.numel() for p in AttRNN(AttRNNConfig(
        num_layers=1, hidden_size=16)).parameters())
    for out in outs:
        r = last_json(out)
        assert r["steps"] == 4
        # two a step (the weight sum; the gradients with the loss), one a
        # sweep of 2 batches of 7 sums
        assert r["allreduce_calls"] == 2 * 4 + 1
        assert r["allreduce_bytes"] == 4 * (4 * (1 + n_params + 1) + 2 * 7)
    assert json.dumps(last_json(outs[0])["valid_losses"]) \
        == json.dumps(last_json(outs[1])["valid_losses"])


@pytest.mark.parametrize("family, extra", [
    ("attbilstm1s", []),
    ("attbigru2s2", ["--train_transfer", "bf16", "--is_stds", "yes"]),
    ("transencoder2s", ["--dl_offsets", "--layer_trans", "1", "--d_model", "32",
                        "--dim_ff", "32"]),
])
def test_trainm_on_two_ranks_runs_every_family(family, extra, tmp_path):
    """The other families and wires through the same multi-rank loop: the
    single-strand LSTM, the embedded-kinetics family with its BatchNorms on
    the bf16 wire, and transencoder2s from the out-of-core loader. Both
    ranks log the same validations, rank 0 alone writes, and its checkpoint
    loads into the port's model."""
    from ccsmeth_tpu_torch.models import TransEnc, TransEncConfig
    from ccsmeth_tpu_torch.training.train import model_io
    from tests.test_torch_train1s import _write_ss_tsv

    tr, va = str(tmp_path / "tr.tsv"), str(tmp_path / "va.tsv")
    if family.endswith("1s"):
        _write_ss_tsv(tr, 4 * 2 * B, 5)
        _write_ss_tsv(va, 2 * 2 * B, 6)
    else:
        _write_feature_tsv(tr, n=4 * 2 * B, seed=5)
        _write_feature_tsv(va, n=2 * 2 * B, seed=6)
    argv = ["--train_file", tr, "--valid_file", va, "--model_type", family,
            "--layer_rnn", "1", "--hid_rnn", "16", "--batch_size", str(B),
            "--max_epoch_num", "2", "--min_epoch_num", "2", "--step_interval", "2",
            "--tseed", "4", "--device", "cpu"] + extra
    port = free_port()
    mdirs = [str(tmp_path / "rank{}".format(k)) for k in (0, 1)]
    outs = run_ranks([TRAINM_RANK.format(argv=argv, mdir=mdirs[k], rank=k, port=port)
                      for k in (0, 1)])
    runs = [last_json(o) for o in outs]
    lines = [_valid_lines(o) for o in outs]
    assert len(lines[0]) == 4 and lines[0] == lines[1]
    assert runs[0]["ckpts"] and runs[1]["ckpts"] == [] and os.listdir(mdirs[1]) == []
    for r in runs:
        assert r["steps"] == 2 * 4 and r["world"] == 2
        assert np.all(np.isfinite(r["valid_losses"]))
    cfg = TrainConfig(model_type=family, layer_rnn=1, hid_rnn=16, layer_trans=1,
                      d_model=32, dim_ff=32, dropout_rate=0.0,
                      is_stds="--is_stds" in extra).model_config()
    module, to_state_dict, _ = model_io(cfg)
    assert (module is TransEnc) == isinstance(cfg, TransEncConfig)
    module(cfg).load_state_dict(to_state_dict(load_params(runs[0]["ckpts"][-1])))

"""The multi-process and multi-card paths on the card: ``trainm`` on two
ranks sharing one card (``gloo``, by the backend rule), ``call_freqb
--dist_coordinator`` on two ranks (count mode byte-equal to one process,
aggregate mode through K1 on rank 0's card row-equal to one process on the
card), and, where the machine has a second card, every kernel launched on
``cuda:1`` while the current device stays 0, against its plain version.
Needs a CUDA device and skips without one (the second-card test also skips
with one card).

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_dist_cuda.py
"""

import os
import re

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.bamio import BamReader, BamWriter
from ccsmeth_tpu_torch.models import AggrConfig, init_aggr_attrnn
from ccsmeth_tpu_torch.models.params_io import _flatten, load_params, save_params
from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.parallel import distributed
# this file's own directory, where pytest imports test files from
from test_torch_dist import free_port, last_json, run_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
REF = os.path.join(GOLD, "ref.fa")
B = 64  # rows a rank


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _write_feature_tsv(path, n, seed, seq_len=21):
    """Separable synthetic features: label-1 rows get an ipd shift at the
    center (the writer of tests/test_training.py, which imports JAX)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            label = i % 2
            kmer = "".join(rng.choice(list("ACGT"), seq_len))
            kmer = kmer[:10] + "CG" + kmer[12:]
            ipd, pw = rng.randn(seq_len), rng.randn(seq_len)
            if label:
                ipd[8:13] += 2.0
            csv = lambda v: ",".join("{:.6f}".format(x) for x in v)  # noqa: E731
            f.write("\t".join([
                "chr1", str(1000 + i), "+", "read/{}/ccs".format(i), str(50 + i),
                kmer, "10", csv(ipd), ".", csv(pw), ".", ".", ".", kmer[::-1], "9",
                csv(rng.randn(seq_len)), ".", csv(rng.randn(seq_len)), ".", ".", ".",
                str(label)]) + "\n")


TRAINM_RANK = r"""
import json
import torch
from ccsmeth_tpu_torch import cli
from ccsmeth_tpu_torch.ops import bigru, bigru_vjp
from ccsmeth_tpu_torch.training.train import LAST_RUN

cli.main(["trainm"] + {argv!r} + ["--num_processes", "2", "--process_id", "{rank}",
          "--dist_coordinator", "127.0.0.1:{port}"])
torch.cuda.synchronize()
run = {{k: LAST_RUN[k] for k in ("steps", "ckpts", "world", "backend",
                                 "allreduce_calls", "valid_losses", "best_accuracy")}}
run.update(k4=bigru_vjp.launches_fwd, k5=bigru_vjp.launches_bwd,
           plain=bigru_vjp.plain_calls, k1=bigru.launches,
           device=torch.cuda.current_device())
print(json.dumps(run))
"""


@pytest.mark.cuda
def test_trainm_on_two_ranks_on_the_card(tmp_path):
    _need_card()
    tr, va = str(tmp_path / "tr.tsv"), str(tmp_path / "va.tsv")
    _write_feature_tsv(tr, 8 * 2 * B, 1)
    _write_feature_tsv(va, 2 * 2 * B, 2)
    mdirs = [str(tmp_path / "rank{}".format(k)) for k in (0, 1)]
    argv = ["--train_file", tr, "--valid_file", va, "--model_type", "attbigru2s",
            "--layer_rnn", "2", "--hid_rnn", "64", "--batch_size", str(B),
            "--dropout_rate", "0", "--lr", "0.01", "--max_epoch_num", "2",
            "--min_epoch_num", "2", "--step_interval", "4", "--tseed", "5",
            "--device", "cuda"]
    port = free_port()
    outs = run_ranks([TRAINM_RANK.format(argv=argv + ["--model_dir", mdirs[k]],
                                         rank=k, port=port) for k in (0, 1)])
    runs = [last_json(o) for o in outs]
    n = torch.cuda.device_count()
    want = distributed.backend_for("cuda", 2, n)
    for k, r in enumerate(runs):
        assert r["world"] == 2 and r["backend"] == want
        assert r["device"] == k % n
        assert r["steps"] == 2 * 8
        # K4 and K5 once a layer a step, nothing through the plain version;
        # K1 on each rank's validation batches: 2 intervals an epoch, 2
        # batches a rank each
        assert r["k4"] == r["k5"] == 2 * r["steps"] and r["plain"] == 0
        assert r["k1"] == 2 * 2 * 2
    assert runs[0]["valid_losses"] == runs[1]["valid_losses"]
    lines = [[re.sub(r"; Time: .*", "", ln[ln.index("Epoch ["):])
              for ln in o.splitlines() if "ValidLoss" in ln] for o in outs]
    assert lines[0] and lines[0] == lines[1]
    assert runs[0]["ckpts"] and runs[1]["ckpts"] == [] and os.listdir(mdirs[1]) == []
    assert np.all(np.isfinite(runs[0]["valid_losses"]))
    for _k, v in _flatten(load_params(runs[0]["ckpts"][-1])):
        assert np.all(np.isfinite(v))


FREQB_RANK = r"""
import json
import torch
from ccsmeth_tpu_torch import cli
from ccsmeth_tpu_torch.ops import bigru
from ccsmeth_tpu_torch.pipeline.call_freq_bam import LAST_RUN

cli.main(["call_freqb", "-i", {bam!r}, "--ref", {ref!r}, "-o", {out!r},
          "--chunk_len", "500"] + {extra!r}
         + ["--num_processes", "2", "--process_id", "{rank}",
            "--dist_coordinator", "127.0.0.1:{port}"])
run = dict(LAST_RUN)
run.update(k1=bigru.launches, k1_plain=bigru.plain_calls)
print(json.dumps(run))
"""


@pytest.fixture(scope="module")
def card_modbam(tmp_path_factory):
    """The golden reads through the port's call_mods on the card, HP tags
    drawn as tests/make_goldens.py draws them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ccsmeth_tpu_torch.pipeline.call_mods import CallModsConfig, call_mods_bam

    tmp = tmp_path_factory.mktemp("dist_cuda")
    cfg = CallModsConfig(model_file=os.path.join(GOLD, "attbigru2s_2x64.ckpt.npz"),
                         mode="align", ref=REF, batch_size=64, layer_rnn=2,
                         hid_rnn=64, threads=2, no_sort=True, device="cuda")
    mods = call_mods_bam(cfg, os.path.join(GOLD, "reads.bam"), str(tmp / "mods"))
    rd = BamReader(mods)
    recs = list(rd)
    rng = np.random.RandomState(1)
    for rec in recs:
        hap = int(rng.randint(0, 3))
        if hap:
            rec.set_tag("HP", "i", hap)
    tagged = str(tmp / "mods.hp.bam")
    with BamWriter(tagged, rd.header) as w:
        for rec in recs:
            w.write(rec)
    return tagged


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["count", "aggregate"])
def test_call_freqb_on_two_ranks_equals_one_process(card_modbam, tmp_path, mode):
    _need_card()
    from ccsmeth_tpu_torch.pipeline import call_freq_bam as cfb

    extra = ["--call_mode", mode]
    kw = {}
    if mode == "aggregate":
        npz = str(tmp_path / "aggr.npz")
        save_params(npz, init_aggr_attrnn(11, AggrConfig()))
        extra += ["--aggre_model", npz, "--device", "cuda"]
        kw = dict(aggre_model=npz, device="cuda")
    outs = [str(tmp_path / "rank{}".format(k) / "dist") for k in (0, 1)]
    for o in outs:
        os.makedirs(os.path.dirname(o))
    port = free_port()
    logs = run_ranks([FREQB_RANK.format(bam=card_modbam, ref=REF, out=outs[k],
                                        extra=extra, rank=k, port=port)
                      for k in (0, 1)])
    runs = [last_json(lg) for lg in logs]
    assert os.listdir(os.path.dirname(outs[1])) == []
    for r in runs:
        assert r["world"] == 2 and r["allreduce_calls"] >= 3
    if mode == "aggregate":  # rank 0 alone runs the model, through K1
        assert runs[0]["k1"] == runs[0]["batches"] > 0 and runs[0]["k1_plain"] == 0
        assert runs[1]["k1"] == runs[1]["batches"] == 0
    single = cfb.call_mods_frequency_from_bamfile(cfb.FreqBamConfig(
        input_bam=card_modbam, ref=REF, output=str(tmp_path / "single"),
        chunk_len=500, call_mode=mode, **kw))
    assert single
    for path in single:
        tag = path.split(".")[-3]
        got = "{}.{}.{}.freq.txt".format(outs[0], mode, tag)
        assert _read(got) == _read(path), tag


@pytest.mark.cuda
def test_every_kernel_on_the_second_card():
    """Each kernel's wrapper on tensors of cuda:1 with the current device
    left at 0: the C entry sets its own runtime's device from the tensors'
    ordinal, so the launch lands on cuda:1 and agrees with the plain
    version there."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    from ccsmeth_tpu_torch.models import TransEncConfig, init_transenc
    from ccsmeth_tpu_torch.models.transenc import randomize_affine
    from ccsmeth_tpu_torch.ops import bigru, bigru_vjp, bilstm_vjp, transenc

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    rng = np.random.RandomState(3)
    for cell in ("gru", "lstm"):
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            ly = [layer_weights(ld, dt, dev)
                  for ld in init_rnn_params(rng, 11, 256, 3, cell)]
            x = torch.from_numpy(rng.randn(21, 300, 11).astype(np.float32)).to(dev, dt)
            out, hn = bigru.birnn_stack(ly, x, dt, cell)  # K1
            ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
            assert out.device == dev and torch.cuda.current_device() == 0
            assert (out.float() - ref_out.float()).abs().max().item() <= tol
            assert (hn - ref_hn).abs().max().item() <= tol
            one = bigru.bigru_layer_tm(ly[0], x, dt, cell)  # K2
            ref_one = bigru.bigru_layer_tm_plain(ly[0], x, dt, cell)
            assert (one.float() - ref_one.float()).abs().max().item() <= tol
            out_l2, _hn = bigru._stack_l2(ly, x, dt, cell, 256)  # K1's l2 design
            assert (out_l2.float() - ref_out.float()).abs().max().item() <= tol
        (wih, bih, whh, bhh), = [layer_weights(ld, torch.float32, dev)
                                 for ld in init_rnn_params(rng, 11, 256, 1, cell)]
        x = torch.from_numpy(rng.randn(21, 256, 11).astype(np.float32)).to(dev)
        dout = torch.from_numpy(rng.randn(21, 256, 512).astype(np.float32)).to(dev)
        if cell == "gru":  # K4, K5
            out, gates = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh)
            ref_out, ref_gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih,
                                                                       whh, bhh)
            grads = bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, out, gates)
            ref = bigru_vjp.bigru_layer_bwd_plain(dout, x, wih, whh, ref_out,
                                                  ref_gates)
        else:  # K6
            out, c, gates = bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh)
            ref_out, ref_c, ref_gates = bilstm_vjp.bilstm_layer_train_fwd_plain(
                x, wih, bih, whh, bhh)
            grads = bilstm_vjp.bilstm_layer_bwd(dout, x, wih, whh, out, c, gates)
            ref = bilstm_vjp.bilstm_layer_bwd_plain(dout, x, wih, whh, ref_out,
                                                    ref_c, ref_gates)
        assert (out - ref_out).abs().max().item() <= 1e-5
        for a, r in zip(grads, ref):
            assert a.device == dev
            assert (a - r).abs().max().item() <= 1e-5 * r.abs().max().item() + 1e-5
    cfg = TransEncConfig()
    params = randomize_affine(init_transenc(4, cfg), 4)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):  # K3
        st = transenc.stack_layers(params["layers"], dt, dev)
        x = torch.from_numpy(rng.randn(300, 21, 256).astype(np.float32)).to(dev, dt)
        ref = transenc.encoder_pooled_plain(st, x, dt, cfg.nhead)
        for got in (transenc.encoder_pooled(st, x, dt, cfg.nhead),
                    transenc._encoder_l2(st, x, dt, cfg.nhead)):
            assert got.device == dev
            assert (got - ref).abs().max().item() <= tol
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0

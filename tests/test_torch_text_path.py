"""The text path through the port on CPU: ``extract`` -> features.tsv and
``call_mods`` on a features TSV -> per_readsite.tsv, against the committed
goldens and against the JAX package's call_mods_txt on the same inputs.

per_readsite rows print each prob rounded to 6 decimals; the goldens (and the
JAX runs here) come from XLA on 8 virtual CPU devices, whose shard shapes move
a prob's last ulp, so a printed prob may differ by one unit of the 6th decimal
(<= 1e-6); every other field, the called label included, is equal."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccsmeth_tpu.pipeline.call_mods import CallModsConfig as JaxCallModsConfig
from ccsmeth_tpu.pipeline.call_mods import call_mods_txt as jax_call_mods_txt
from ccsmeth_tpu_torch.ops import bigru
from ccsmeth_tpu_torch.pipeline import call_mods
from ccsmeth_tpu_torch.pipeline.call_mods import CallModsConfig, call_mods_txt

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
BAM = os.path.join(GOLD, "reads.bam")
REF = os.path.join(GOLD, "ref.fa")
CKPT = os.path.join(GOLD, "attbigru2s_2x64.ckpt.npz")
FEATS = os.path.join(GOLD, "features.tsv")
GOLDEN_KW = dict(model_file=CKPT, batch_size=64, layer_rnn=2, hid_rnn=64, threads=2)


def _read_text(path):
    if path.endswith(".gz"):
        import gzip

        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path) as f:
        return f.read()


def _assert_per_readsite_close(got_path, want_path):
    got = [ln.split("\t") for ln in _read_text(got_path).splitlines()]
    want = [ln.split("\t") for ln in _read_text(want_path).splitlines()]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == 10
        assert g[:6] + g[8:] == w[:6] + w[8:], (g, w)
        for i in (6, 7):  # prob_0, prob_1: units of the 6th decimal
            assert abs(round(float(g[i]) * 1e6) - round(float(w[i]) * 1e6)) <= 1, (g, w)


def _run_cli(args):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "ccsmeth_tpu_torch.cli"] + args,
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_cli_extract_and_call_mods_tsv_match_goldens(tmp_path):
    feats = str(tmp_path / "features.tsv")
    _run_cli(["extract", "--input", BAM, "--output", feats, "--mode", "align",
              "--ref", REF, "--threads", "2"])
    with open(feats, "rb") as a, open(FEATS, "rb") as b:
        assert a.read() == b.read()
    _run_cli(["call_mods", "-i", feats, "-o", str(tmp_path / "prs"), "-m", CKPT,
              "--layer_rnn", "2", "--hid_rnn", "64", "--batch_size", "64",
              "--device", "cpu"])
    _assert_per_readsite_close(str(tmp_path / "prs.per_readsite.tsv"),
                               os.path.join(GOLD, "per_readsite.tsv"))


def test_call_mods_tsv_matches_golden(tmp_path):
    """One K1 plain-version call a padded batch, as many as batches ran."""
    before = bigru.plain_calls
    out = call_mods_txt(CallModsConfig(**GOLDEN_KW, device="cpu"), FEATS,
                        str(tmp_path / "prs"))
    run = dict(call_mods.LAST_RUN)
    assert run["sites"] == 729 and run["batches"] == 12  # 729 rows, batches of 64
    assert bigru.plain_calls - before == run["batches"]
    _assert_per_readsite_close(out, os.path.join(GOLD, "per_readsite.tsv"))


def _holes(tmp_path, keep):
    holes = sorted({ln.split("\t")[3] for ln in _read_text(FEATS).splitlines()})
    path = str(tmp_path / "holes.txt")
    with open(path, "w") as f:
        f.write("\n".join(holes[:keep]) + "\n")
    return path


def _seeded_ckpt(tmp_path, model_type):
    from ccsmeth_tpu_torch.models import (AttRNNConfig, TransEncConfig, init_attrnn,
                                          init_transenc)
    from ccsmeth_tpu_torch.models.params_io import save_params
    from ccsmeth_tpu_torch.models.transenc import randomize_affine

    ckpt = str(tmp_path / (model_type + ".ckpt.npz"))
    if model_type == "transencoder2s":
        shape = dict(num_layers=2, d_model=32, nhead=4, dim_ff=64, dropout_rate=0)
        save_params(ckpt, randomize_affine(init_transenc(23, TransEncConfig(**shape)), 23))
        return dict(model_file=ckpt, model_type=model_type, layer_trans=2, d_model=32,
                    nhead=4, dim_ff=64, batch_size=64)
    save_params(ckpt, init_attrnn(17, AttRNNConfig(
        model_type=model_type, num_layers=2, hidden_size=32, dropout_rate=0)))
    return dict(model_file=ckpt, model_type=model_type, layer_rnn=2, hid_rnn=32,
                batch_size=64)


@pytest.mark.parametrize("case", ["seq_len_17", "holeids_e", "holeids_ne", "gzip",
                                  "pallas_layer", "attbilstm2s", "transencoder2s"])
def test_call_mods_tsv_matches_the_jax_package(tmp_path, case):
    """The same TSV and checkpoint through both packages: center-truncated
    k-mers, the hole filters, gzipped output, K2's plain version
    (pallas_layer; the JAX run is its XLA reference) and the other model
    families."""
    kw, port_kw = dict(GOLDEN_KW), {}
    if case == "seq_len_17":
        kw["seq_len"] = 17
    elif case == "holeids_e":
        kw["holeids_e"] = _holes(tmp_path, 10)
    elif case == "holeids_ne":
        kw["holeids_ne"] = _holes(tmp_path, 10)
    elif case == "gzip":
        kw["gzip_out"] = True
    elif case == "pallas_layer":
        port_kw["rnn_backend"] = "pallas_layer"
    else:
        kw = _seeded_ckpt(tmp_path, case)
    want = jax_call_mods_txt(JaxCallModsConfig(**kw), FEATS, str(tmp_path / "jax"))
    got = call_mods_txt(CallModsConfig(**kw, **port_kw, device="cpu"), FEATS,
                        str(tmp_path / "port"))
    assert got.endswith(".gz") == (case == "gzip")
    _assert_per_readsite_close(got, want)
    if case == "seq_len_17":  # the center 5-mer of a 17-mer cut from the 21-mer
        assert {ln.split("\t")[9][2:4] for ln in _read_text(got).splitlines()} == {"CG"}


@pytest.mark.parametrize("kw", [dict(h0_mode="randn", rnn_backend="pallas"),
                                dict(num_processes=2, process_id=5),
                                dict(h0_mode="randn", num_processes=2)])
def test_call_mods_tsv_unported_options_raise(tmp_path, kw):
    """Requests that the JAX package refuses too: randn h0 through a zero-h0
    kernel backend, a process_id outside [0, num_processes), randn h0 on a
    sharded run."""
    with pytest.raises(ValueError):
        call_mods_txt(CallModsConfig(**GOLDEN_KW, device="cpu", **kw), FEATS,
                      str(tmp_path / "x"))


def test_call_mods_tsv_rows_shorter_than_seq_len_give_no_rows(tmp_path):
    out = call_mods_txt(CallModsConfig(**dict(GOLDEN_KW, seq_len=23), device="cpu"),
                        FEATS, str(tmp_path / "short"))
    assert _read_text(out) == "" and np.isfinite(call_mods.LAST_RUN["seconds"])

"""Golden gate for the port: call_mods BAM -> modbam on CPU against
tests/goldens/mmml.tsv, through the library and through the CLI.

The goldens came from ccsmeth_tpu's XLA path on 8 virtual CPU devices
(tests/make_goldens.py:29-30), whose shard shapes move the last ulp of the
probs; so MM strings and row order must be equal and ML bytes at most 1 apart.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.bamio import BamReader
from ccsmeth_tpu_torch.pipeline.call_mods import CallModsConfig, call_mods_bam

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
BAM = os.path.join(GOLD, "reads.bam")
REF = os.path.join(GOLD, "ref.fa")
CKPT = os.path.join(GOLD, "attbigru2s_2x64.ckpt.npz")


def _dump(modbam: str) -> list[tuple[str, str, str]]:
    """qname, MM, ML rows as tests/make_goldens.py:91-97 writes them."""
    rows = []
    for rec in BamReader(modbam):
        mm = rec.get_tag("MM") if rec.has_tag("MM") else "."
        ml = (",".join(str(int(x)) for x in rec.get_tag("ML"))
              if rec.has_tag("ML") else ".")
        rows.append((rec.qname, mm, ml))
    return rows


def _compare_with_golden(rows):
    with open(os.path.join(GOLD, "mmml.tsv")) as f:
        gold = [tuple(line.rstrip("\n").split("\t")) for line in f]
    assert [r[0] for r in rows] == [g[0] for g in gold]
    assert [r[1] for r in rows] == [g[1] for g in gold]
    n_bytes = n_diff = 0
    for (_q, _mm, ml), (_gq, _gmm, gml) in zip(rows, gold):
        assert (ml == ".") == (gml == ".")
        if ml == ".":
            continue
        a = np.asarray(ml.split(","), np.int64)
        b = np.asarray(gml.split(","), np.int64)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1
        n_bytes += a.size
        n_diff += int((a != b).sum())
    assert n_bytes > 0
    print("ML bytes differing from the golden by 1: {} of {}".format(
        n_diff, n_bytes))


def test_call_mods_bam_matches_golden(tmp_path):
    cfg = CallModsConfig(model_file=CKPT, mode="align", ref=REF, batch_size=64,
                         layer_rnn=2, hid_rnn=64, threads=2, no_sort=True,
                         device="cpu")
    _compare_with_golden(_dump(call_mods_bam(cfg, BAM, str(tmp_path / "mods"))))


def test_cli_call_mods_matches_golden(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "ccsmeth_tpu_torch.cli", "call_mods",
           "--input", BAM, "--output", str(tmp_path / "mods"),
           "--model_file", CKPT, "--mode", "align", "--ref", REF,
           "--batch_size", "64", "--layer_rnn", "2", "--hid_rnn", "64",
           "--threads", "2", "--no_sort", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    _compare_with_golden(_dump(str(tmp_path / "mods.modbam.bam")))


def test_sorted_output_is_indexed(tmp_path):
    cfg = CallModsConfig(model_file=CKPT, mode="align", ref=REF, batch_size=64,
                         layer_rnn=2, hid_rnn=64, threads=2, device="cpu")
    out = call_mods_bam(cfg, BAM, str(tmp_path / "s"))
    assert os.path.exists(out + ".bai")
    recs = list(BamReader(out))
    pos = [(r.ref_id, r.pos) for r in recs]
    assert pos == sorted(pos) and len(recs) == 24


@pytest.mark.parametrize("bad", ["cuda_without_gpu", "randn_h0", "processes",
                                 "shape_mismatch", "attbigru2s2",
                                 "gru_ckpt_as_lstm", "lstm_1s"])
def test_unsupported_requests_raise(tmp_path, bad):
    kw = dict(model_file=CKPT, mode="align", ref=REF, layer_rnn=2, hid_rnn=64,
              device="cpu")
    if bad == "cuda_without_gpu":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        kw["device"] = "cuda"
        err = RuntimeError
    elif bad == "randn_h0":  # randn replays through the plain BiRNN only
        kw["h0_mode"] = "randn"
        kw["rnn_backend"] = "pallas"
        err = ValueError
    elif bad == "processes":  # a process_id outside [0, num_processes)
        kw["num_processes"] = 2
        kw["process_id"] = 2
        err = ValueError
    elif bad == "shape_mismatch":
        kw["hid_rnn"] = 256
        err = ValueError
    elif bad == "gru_ckpt_as_lstm":  # 3H-row tensors where the LSTM has 4H
        kw["model_type"] = "attbilstm2s"
        err = ValueError
    elif bad == "lstm_1s":  # a single-strand family: train/trainm only
        kw["model_type"] = "attbilstm1s"
        err = ValueError
    else:  # a checkpoint without the stds embeds of --is_stds yes
        kw["model_type"] = "attbigru2s2"
        kw["is_stds"] = True
        err = ValueError
    with pytest.raises(err):
        call_mods_bam(CallModsConfig(**kw), BAM, str(tmp_path / "x"))


@pytest.mark.parametrize("model_type", ["attbigru3s", "bilstm"])
def test_unknown_model_type_raises_as_the_jax_package(model_type):
    """A --model_type outside every family: both packages' CallModsConfig
    raise ValueError with the same message."""
    from ccsmeth_tpu.pipeline.call_mods import CallModsConfig as JaxCallModsConfig

    raised = []
    for cfg in (CallModsConfig(model_type=model_type), JaxCallModsConfig(model_type=model_type)):
        with pytest.raises(Exception) as err:
            cfg.model_config()
        raised.append((type(err.value), str(err.value)))
    assert raised[0] == raised[1] == (ValueError, "--model_type not right!")


def test_cli_rejects_features_tsv(tmp_path):
    """A features TSV now runs call_mods_txt (tests/test_torch_text_path.py
    holds its output); the CLI rejects it, as it rejects a BAM, only when
    the checkpoint does not match the model flags."""
    from ccsmeth_tpu_torch.cli import main

    args = ["call_mods", "-i", os.path.join(GOLD, "features.tsv"),
            "-o", str(tmp_path / "o"), "-m", CKPT, "--device", "cpu"]
    with pytest.raises(ValueError, match="does not match the model flags"):
        main(args)
    main(args + ["--layer_rnn", "2", "--hid_rnn", "64", "--batch_size", "64"])
    with open(str(tmp_path / "o.per_readsite.tsv")) as f:
        assert len(f.read().splitlines()) == 729


def test_attbilstm2s_call_mods_matches_jax(tmp_path, monkeypatch):
    """The slice as a whole: call_mods --model_type attbilstm2s on
    tests/goldens/reads.bam with a seeded 2 x 32 checkpoint, through the JAX
    package's call_mods_bam and through the port on the CPU. MM strings and
    read order are equal; ML bytes are equal, except that one may differ by
    1 where the port's prob lies within 1e-5 of the 1/256 boundary between
    the two bytes (the JAX run shards over 8 virtual devices, which moves the
    last ulp of a prob)."""
    from ccsmeth_tpu.pipeline.call_mods import CallModsConfig as JaxCallModsConfig
    from ccsmeth_tpu.pipeline.call_mods import call_mods_bam as jax_call_mods_bam
    from ccsmeth_tpu_torch.models import AttRNNConfig, init_attrnn
    from ccsmeth_tpu_torch.models.params_io import save_params
    from ccsmeth_tpu_torch.pipeline import call_mods as port_call_mods

    ckpt = str(tmp_path / "attbilstm2s_2x32.ckpt.npz")
    save_params(ckpt, init_attrnn(17, AttRNNConfig(
        model_type="attbilstm2s", num_layers=2, hidden_size=32, dropout_rate=0)))
    kw = dict(model_file=ckpt, model_type="attbilstm2s", mode="align", ref=REF,
              batch_size=64, layer_rnn=2, hid_rnn=32, threads=2, no_sort=True)
    want = _dump(jax_call_mods_bam(JaxCallModsConfig(**kw), BAM,
                                   str(tmp_path / "jax")))

    probs = {}  # qname -> the port's probs in ML order (sorted by loc)
    tag = port_call_mods.add_mm_ml_to_record

    def recording_tag(rec, locs_probs, rm_pulse=True):
        probs[rec.qname] = [p for _loc, p in sorted(locs_probs)]
        return tag(rec, locs_probs, rm_pulse)

    monkeypatch.setattr(port_call_mods, "add_mm_ml_to_record", recording_tag)
    got = _dump(call_mods_bam(CallModsConfig(**kw, device="cpu"), BAM,
                              str(tmp_path / "port")))
    assert [r[:2] for r in got] == [w[:2] for w in want]
    n_sites = 0
    for (q, _mm, ml), (_q, _wmm, wml) in zip(got, want):
        assert (ml == ".") == (wml == ".")
        if ml == ".":
            continue
        a = np.asarray(ml.split(","), np.int64)
        b = np.asarray(wml.split(","), np.int64)
        assert a.shape == b.shape == (len(probs[q]),)
        n_sites += a.size
        for i in np.flatnonzero(a != b):
            assert abs(a[i] - b[i]) == 1, (q, i, a[i], b[i])
            assert abs(probs[q][i] - max(a[i], b[i]) / 256.0) <= 1e-5, (
                q, i, probs[q][i], a[i], b[i])
    assert n_sites > 500


def test_transencoder2s_call_mods_matches_jax(tmp_path, monkeypatch):
    """The transencoder2s slice as a whole: call_mods --model_type
    transencoder2s on tests/goldens/reads.bam with a seeded 2 x 32
    checkpoint (random biases, LayerNorm and BatchNorm parameters), through
    the JAX package's call_mods_bam and through the port
    on the CPU. Such a small random model gives nearly the same ML byte at
    every site, so equal tags prove little: the probs the port's tagger
    records are also held against the JAX package's apply_transenc on the
    same extracted features, at 1e-5 (the tagger rounds them to 6 decimals)."""
    from ccsmeth_tpu.models.config import TransEncConfig as JaxTransEncConfig
    from ccsmeth_tpu.models.transenc import apply_transenc
    from ccsmeth_tpu.pipeline.call_mods import CallModsConfig as JaxCallModsConfig
    from ccsmeth_tpu.pipeline.call_mods import call_mods_bam as jax_call_mods_bam
    from ccsmeth_tpu_torch.features import (ExtractConfig, batch_from_reads,
                                            extract_read_features)
    from ccsmeth_tpu_torch.models import TransEncConfig, init_transenc
    from ccsmeth_tpu_torch.models.params_io import save_params
    from ccsmeth_tpu_torch.models.transenc import randomize_affine
    from ccsmeth_tpu_torch.ops import transenc
    from ccsmeth_tpu_torch.pipeline import call_mods as port_call_mods
    from ccsmeth_tpu_torch.utils.codecs import get_motif_seqs
    from ccsmeth_tpu_torch.utils.fasta import DNAReference

    shape = dict(num_layers=2, d_model=32, nhead=4, dim_ff=64, dropout_rate=0)
    params = randomize_affine(init_transenc(23, TransEncConfig(**shape)), 23)
    ckpt = str(tmp_path / "transencoder2s_2x32.ckpt.npz")
    save_params(ckpt, params)
    kw = dict(model_file=ckpt, model_type="transencoder2s", mode="align", ref=REF,
              batch_size=64, layer_trans=2, d_model=32, nhead=4, dim_ff=64,
              threads=2, no_sort=True)
    want = _dump(jax_call_mods_bam(JaxCallModsConfig(**kw), BAM, str(tmp_path / "jax")))

    probs = {}  # qname -> the port's recorded probs in ML order (by loc)
    tag = port_call_mods.add_mm_ml_to_record

    def recording_tag(rec, locs_probs, rm_pulse=True):
        probs[rec.qname] = [p for _loc, p in sorted(locs_probs)]
        return tag(rec, locs_probs, rm_pulse)

    monkeypatch.setattr(port_call_mods, "add_mm_ml_to_record", recording_tag)
    plain = transenc.plain_calls
    got = _dump(call_mods_bam(CallModsConfig(**kw, device="cpu"), BAM,
                              str(tmp_path / "port")))
    assert transenc.plain_calls - plain == port_call_mods.LAST_RUN["batches"] > 0
    assert [r[:2] for r in got] == [w[:2] for w in want]
    n_sites = 0
    for (q, _mm, ml), (_q, _wmm, wml) in zip(got, want):
        assert (ml == ".") == (wml == ".")
        if ml == ".":
            continue
        a = np.asarray(ml.split(","), np.int64)
        b = np.asarray(wml.split(","), np.int64)
        assert a.shape == b.shape == (len(probs[q]),)
        n_sites += a.size
        for i in np.flatnonzero(a != b):
            assert abs(a[i] - b[i]) == 1, (q, i, a[i], b[i])
            assert abs(probs[q][i] - max(a[i], b[i]) / 256.0) <= 1e-5
    assert n_sites > 500

    # the JAX model on the port's extracted features, per read in loc order
    reader = BamReader(BAM)
    names = [r[0] for r in reader.header.references]
    contigs = DNAReference(REF).getcontigs()
    recs = list(reader)
    reader.close()
    reads = [extract_read_features(rec, get_motif_seqs("CG"), ExtractConfig(mode="align"),
                                   contigs, None, None,
                                   names[rec.ref_id] if rec.ref_id >= 0 else None)
             for rec in recs]
    kept = [i for i, r in enumerate(reads) if r is not None]
    batch = batch_from_reads([reads[i] for i in kept])
    _l, p = apply_transenc(params, JaxTransEncConfig(**shape), batch.model_feats())
    p = np.asarray(p, np.float64)
    p1n = p[:, 1] / (p[:, 0] + p[:, 1])
    n_checked = 0
    for j, i in enumerate(kept):
        sel = np.flatnonzero(batch.read_idx == j)
        jax_probs = p1n[sel[np.argsort(batch.locs[sel], kind="stable")]]
        np.testing.assert_allclose(probs[recs[i].qname], jax_probs, atol=1e-5)
        n_checked += sel.size
    assert n_checked == n_sites

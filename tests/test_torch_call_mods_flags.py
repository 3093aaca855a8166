"""call_mods' flags on both inputs, the port on the CPU against the JAX
package: --h0_mode randn (the replayed draws, and the tags they give),
--num_processes N --process_id k (the shards' union is the single run, and
each shard is the JAX package's), --profile_dir (a trace, and the same
outputs)."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from ccsmeth_tpu.pipeline.call_mods import CallModsConfig as JaxCallModsConfig
from ccsmeth_tpu.pipeline.call_mods import _make_h0_stream as jax_make_h0_stream
from ccsmeth_tpu.pipeline.call_mods import call_mods_bam as jax_call_mods_bam
from ccsmeth_tpu.pipeline.call_mods import call_mods_txt as jax_call_mods_txt
from ccsmeth_tpu_torch.bamio import BamReader
from ccsmeth_tpu_torch.models import AttRNNConfig, attrnn, init_attrnn
from ccsmeth_tpu_torch.models.params_io import save_params
from ccsmeth_tpu_torch.ops import bigru
from ccsmeth_tpu_torch.pipeline import call_mods as port

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
BAM = os.path.join(GOLD, "reads.bam")
REF = os.path.join(GOLD, "ref.fa")
TSV = os.path.join(GOLD, "features.tsv")
CKPT = os.path.join(GOLD, "attbigru2s_2x64.ckpt.npz")
GOLDEN_KW = dict(model_file=CKPT, layer_rnn=2, hid_rnn=64)
BAM_KW = dict(mode="align", ref=REF, threads=2, no_sort=True)


def _tags(modbam):
    """qname -> (MM, ML bytes) in file order."""
    out = {}
    for rec in BamReader(modbam):
        out[rec.qname] = (rec.get_tag("MM") if rec.has_tag("MM") else None,
                          tuple(int(x) for x in rec.get_tag("ML"))
                          if rec.has_tag("ML") else None)
    return out


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _lstm2s2_ckpt(tmp_path):
    """A seeded attbilstm2s2 2 x 16, its tables x10 and its output layer
    x100 so that its calls spread over the ML bytes."""
    params = init_attrnn(29, AttRNNConfig(model_type="attbilstm2s2", num_layers=2,
                                          hidden_size=16, dropout_rate=0))
    for name in ("seq_embed", "ipd_embed", "pw_embed"):
        params[name] = params[name] * 10
    params["classifier"][1]["w"] = params["classifier"][1]["w"] * 100
    path = str(tmp_path / "attbilstm2s2.ckpt.npz")
    save_params(path, params)
    return dict(model_file=path, model_type="attbilstm2s2", layer_rnn=2, hid_rnn=16)


@pytest.mark.parametrize("model_type", ["attbigru2s", "attbilstm2s"])
def test_h0_draws_equal_the_jax_stream(model_type):
    """Seed once, then per forward strand-1 h0 [c0], strand-2 h0 [c0] at the
    unpadded row count, zero rows for the padding: the port's explicit
    generator gives the JAX package's draws (which seed torch's global
    one) draw for draw."""
    cfg = AttRNNConfig(model_type=model_type, num_layers=2, hidden_size=8)
    mine = port._make_h0_stream(cfg, 77)
    theirs = jax_make_h0_stream(cfg, 77)
    for n_valid, pad_n in ((5, 8), (8, 8), (3, 16), (1, 8)):
        a, b = mine(n_valid, pad_n), theirs(n_valid, pad_n)
        keys = ["h0", "c0", "h0_2", "c0_2"] if model_type == "attbilstm2s" else ["h0", "h0_2"]
        assert sorted(a) == sorted(b) == sorted(keys)
        for k in keys:
            assert a[k].shape == (4, pad_n, 8) and a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
            assert not a[k][:, n_valid:].any()


@pytest.mark.parametrize("model", ["attbigru2s", "attbilstm2s2"])
def test_randn_h0_tags_equal_jax(model, tmp_path):
    """call_mods --h0_mode randn on tests/goldens/reads.bam: the port's tags
    equal the JAX package's, ML bytes at most 1 apart (its run shards over 8
    virtual devices), and they are not the zero-h0 run's; the BiRNN ran
    through the plain birnn_tm once a batch, never through K1's plain
    version."""
    kw = dict(GOLDEN_KW) if model == "attbigru2s" else _lstm2s2_ckpt(tmp_path)
    kw.update(BAM_KW, batch_size=64, h0_mode="randn", tseed=4321)
    want = _tags(jax_call_mods_bam(JaxCallModsConfig(**kw), BAM, str(tmp_path / "jax")))
    attrnn.h0_plain_calls = 0
    plain = bigru.plain_calls
    got = _tags(port.call_mods_bam(port.CallModsConfig(**kw, device="cpu"), BAM,
                                   str(tmp_path / "port")))
    assert attrnn.h0_plain_calls == port.LAST_RUN["batches"] > 1
    assert bigru.plain_calls == plain
    zero = _tags(port.call_mods_bam(port.CallModsConfig(**dict(kw, h0_mode="zeros"),
                                                        device="cpu"),
                                    BAM, str(tmp_path / "zero")))
    assert list(got) == list(want)
    n_sites = n_moved = 0
    for q, (mm, ml) in got.items():
        assert mm == want[q][0]
        if ml is None:
            continue
        a, b, z = (np.asarray(v) for v in (ml, want[q][1], zero[q][1]))
        assert np.abs(a - b).max() <= 1, q
        n_sites += a.size
        n_moved += int((a != z).sum())
    assert n_sites > 500 and n_moved > n_sites // 10


def test_randn_h0_tsv_equals_jax(tmp_path):
    """The TSV path replays the same stream: per_readsite rows equal the JAX
    package's but the printed probs, within one unit of the 6th decimal."""
    kw = dict(GOLDEN_KW, batch_size=64, h0_mode="randn", tseed=99)
    want = _lines(jax_call_mods_txt(JaxCallModsConfig(**kw), TSV, str(tmp_path / "j")))
    got = _lines(port.call_mods_txt(port.CallModsConfig(**kw, device="cpu"), TSV,
                                    str(tmp_path / "p")))
    zero = _lines(port.call_mods_txt(port.CallModsConfig(**dict(kw, h0_mode="zeros"),
                                                         device="cpu"),
                                     TSV, str(tmp_path / "z")))
    assert len(got) == len(want) == 729
    for a, b in zip(got, want):
        a, b = a.split("\t"), b.split("\t")
        assert a[:6] + a[8:] == b[:6] + b[8:]
        assert abs(float(a[7]) - float(b[7])) <= 1.01e-6
    assert sum(a != z for a, z in zip(got, zero)) > 100


def test_processes_shards_rebuild_the_single_run_bam(tmp_path):
    """--num_processes 2: each shard holds the reads owns_read gives it and
    equals the JAX package's shard (ML bytes at most 1 apart); together
    they are the single run."""
    kw = dict(GOLDEN_KW, **BAM_KW, batch_size=64)
    single = _tags(port.call_mods_bam(port.CallModsConfig(**kw, device="cpu"), BAM,
                                      str(tmp_path / "single")))
    merged = {}
    for pid in (0, 1):
        skw = dict(kw, num_processes=2, process_id=pid)
        shard = _tags(port.call_mods_bam(port.CallModsConfig(**skw, device="cpu"), BAM,
                                         str(tmp_path / "p{}".format(pid))))
        jax_shard = _tags(jax_call_mods_bam(JaxCallModsConfig(**skw), BAM,
                                            str(tmp_path / "j{}".format(pid))))
        assert 0 < len(shard) < len(single) and list(shard) == list(jax_shard)
        for q, (mm, ml) in shard.items():
            assert mm == jax_shard[q][0]
            if ml is not None:
                assert np.abs(np.asarray(ml) - np.asarray(jax_shard[q][1])).max() <= 1
        assert not set(shard) & set(merged)
        merged.update(shard)
    assert merged == single


def test_processes_shards_rebuild_the_single_run_tsv(tmp_path):
    """The TSV path splits on column 4, the read name: the two shards' rows,
    together, are the single run's; each shard's rows are the JAX
    package's shard's but the printed probs, within one unit of the 6th
    decimal."""
    kw = dict(GOLDEN_KW, batch_size=64)
    single = _lines(port.call_mods_txt(port.CallModsConfig(**kw, device="cpu"), TSV,
                                       str(tmp_path / "single")))
    merged = []
    for pid in (0, 1):
        skw = dict(kw, num_processes=2, process_id=pid)
        shard = _lines(port.call_mods_txt(port.CallModsConfig(**skw, device="cpu"), TSV,
                                          str(tmp_path / "p{}".format(pid))))
        jax_shard = _lines(jax_call_mods_txt(JaxCallModsConfig(**skw), TSV,
                                             str(tmp_path / "j{}".format(pid))))
        assert 0 < len(shard) < len(single) and len(shard) == len(jax_shard)
        for a, b in zip(shard, jax_shard):
            a, b = a.split("\t"), b.split("\t")
            assert a[:6] + a[8:] == b[:6] + b[8:]
            assert abs(float(a[7]) - float(b[7])) <= 1.01e-6
        merged += shard
    assert sorted(merged) == sorted(single)


def test_profile_dir_writes_a_trace_and_changes_no_output(tmp_path):
    """--profile_dir on both inputs: a Chrome trace of the dispatch loop in
    the directory, with the model's ops in it, and outputs byte-equal to the
    run without it."""
    kw = dict(GOLDEN_KW, batch_size=64)
    outs = {}
    for name, extra in (("plain", {}), ("traced", {"profile_dir": str(tmp_path / "tr")})):
        cfg = port.CallModsConfig(**kw, **BAM_KW, device="cpu", **extra)
        with open(port.call_mods_bam(cfg, BAM, str(tmp_path / name)), "rb") as f:
            bam = f.read()
        with open(port.call_mods_txt(cfg, TSV, str(tmp_path / name)), "rb") as f:
            outs[name] = (bam, f.read())
    assert outs["plain"] == outs["traced"]
    traces = glob.glob(str(tmp_path / "tr" / "trace_*.json"))
    assert len(traces) == 2  # one a run
    for path in traces:
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        assert any(n.split("::")[-1] in ("mm", "addmm", "matmul") for n in names)

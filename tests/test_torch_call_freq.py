"""call_freqb through the port on CPU: count mode byte-equal to the committed
goldens on the path of tests/make_goldens.py:104-122, every output format
byte-equal to the JAX package's call_mods_frequency_from_bamfile on the same
modbam, the streaming and BAI-scoped scans equal to the full scan, two
share-nothing processes that rebuild the single run, and aggregate mode (both
cells, the same seeded .npz) against the JAX package's."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ccsmeth_tpu.pipeline import call_freq_bam as jax_cfb
from ccsmeth_tpu_torch.bamio import BamReader, BamWriter, build_index, sort_bam
from ccsmeth_tpu_torch.bamio.bam import BamHeader
from ccsmeth_tpu_torch.models import AggrConfig, init_aggr_attrnn
from ccsmeth_tpu_torch.models.params_io import save_params
from ccsmeth_tpu_torch.ops import bigru
from ccsmeth_tpu_torch.pipeline import call_freq_bam as cfb
from ccsmeth_tpu_torch.pipeline.call_mods import CallModsConfig, call_mods_bam

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
REF = os.path.join(GOLD, "ref.fa")


def _hp_tagged(src, dst):
    """HP tags drawn as tests/make_goldens.py:108-117 draws them."""
    rd = BamReader(src)
    recs = list(rd)
    rng = np.random.RandomState(1)
    for rec in recs:
        hap = int(rng.randint(0, 3))
        if hap:
            rec.set_tag("HP", "i", hap)
    with BamWriter(dst, rd.header) as w:
        for rec in recs:
            w.write(rec)
    return recs


@pytest.fixture(scope="module")
def modbam(tmp_path_factory):
    """The golden reads through the port's call_mods (CPU, no_sort, as
    tests/make_goldens.py:84-88), HP-tagged; and a sorted, indexed copy."""
    tmp = tmp_path_factory.mktemp("torch_freq")
    cfg = CallModsConfig(model_file=os.path.join(GOLD, "attbigru2s_2x64.ckpt.npz"),
                         mode="align", ref=REF, batch_size=64, layer_rnn=2,
                         hid_rnn=64, threads=2, no_sort=True, device="cpu")
    mods = call_mods_bam(cfg, os.path.join(GOLD, "reads.bam"), str(tmp / "mods"))
    tagged = str(tmp / "mods.hp.bam")
    _hp_tagged(mods, tagged)
    indexed = str(tmp / "sorted" / "mods.hp.bam")
    os.makedirs(os.path.dirname(indexed))
    sort_bam(tagged, indexed)
    build_index(indexed)
    return SimpleNamespace(bam=tagged, indexed=indexed, tmp=tmp)


def _run(pkg, bam, prefix, **kw):
    kw.setdefault("chunk_len", 500)
    if pkg is cfb and kw.get("call_mode") == "aggregate":
        kw.setdefault("device", "cpu")
    return pkg.call_mods_frequency_from_bamfile(
        pkg.FreqBamConfig(input_bam=bam, ref=REF, output=prefix, **kw))


def _by_tag(paths):
    return {t: p for p in paths for t in ("all", "hp1", "hp2") if ".{}.".format(t) in p}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def count_outputs(modbam):
    return _by_tag(_run(cfb, modbam.bam, str(modbam.tmp / "freq"), call_mode="count"))


@pytest.mark.parametrize("tag", ["all", "hp1", "hp2"])
def test_count_mode_matches_golden(count_outputs, tag):
    assert _read(count_outputs[tag]) == _read(
        os.path.join(GOLD, "freq_count.{}.tsv".format(tag)))


@pytest.mark.parametrize("kw", [dict(bed=True), dict(sort=True), dict(gzip=True),
                                dict(bed=True, gzip=True, sort=True),
                                dict(prob_cf=0.3, no_amb_cov=True),
                                dict(refsites_all=True, no_comb=True)])
def test_outputs_equal_the_jax_package(modbam, tmp_path, kw):
    """Byte-equal files, .tbi indexes of --gzip included."""
    ours = _run(cfb, modbam.bam, str(tmp_path / "ours"), **kw)
    theirs = _run(jax_cfb, modbam.bam, str(tmp_path / "theirs"), **kw)
    assert [os.path.basename(p) for p in ours] == [
        os.path.basename(p).replace("theirs", "ours") for p in theirs]
    assert ours
    for a, b in zip(ours, theirs):
        assert _read(a) == _read(b), a
        if kw.get("gzip"):
            assert a.endswith(".gz") and _read(a + ".tbi") == _read(b + ".tbi")


def _strip_so(src, dst):
    """A copy with the @HD SO: field removed, so the scan cannot stream."""
    rd = BamReader(src)
    recs = list(rd)
    text = "\n".join("\t".join(f for f in ln.split("\t") if not f.startswith("SO:"))
                     for ln in rd.header.text.splitlines())
    with BamWriter(dst, BamHeader(text + "\n", rd.header.references)) as w:
        for rec in recs:
            w.write(rec)


def test_streaming_and_scoped_scans_equal_the_full_scan(modbam, tmp_path):
    assert "SO:coordinate" in BamReader(modbam.indexed).header.text
    nosort = str(tmp_path / "noso.bam")
    _strip_so(modbam.indexed, nosort)
    full = _run(cfb, nosort, str(tmp_path / "full"))
    stream = _run(cfb, modbam.indexed, str(tmp_path / "stream"))
    assert len(full) == len(stream) == 3
    for a, b in zip(full, stream):
        assert _read(a) == _read(b)
    # the BAI-scoped read path (a span of the contig) against the linear scan
    dnacontigs = cfb.DNAReference(REF).getcontigs()
    cfg = cfb.FreqBamConfig(input_bam=modbam.indexed, ref=REF, output="x")
    span = {"chrS": [(600, 1800)]}

    def sites(accs):
        return {(c, s, p): v for c, a in accs.items()
                for s, d in (("+", a.fwd), ("-", a.rev)) for p, v in d.items()
                if 600 <= p < 1800}

    scoped = sites(cfb.scan_bam_accumulate(cfg, dnacontigs, None,
                                           scoped_regions=span))
    linear = sites(cfb.scan_bam_accumulate(cfg, dnacontigs, None))
    assert len(linear) > 50 and scoped == linear


@pytest.mark.parametrize("indexed", [False, True])
def test_two_processes_rebuild_the_single_run(modbam, tmp_path, indexed):
    """Disjoint round-robin chunk ownership: the shards' rows, together,
    are the single run's rows (linear scan, or BAI-scoped with the index)."""
    bam = modbam.indexed if indexed else modbam.bam
    single = _read(_by_tag(_run(cfb, bam, str(tmp_path / "one")))["all"])
    rows = []
    for pid in range(2):
        out = _by_tag(_run(cfb, bam, str(tmp_path / "p{}".format(pid)),
                           num_processes=2, process_id=pid))
        part = _read(out["all"]).decode().splitlines()
        assert part
        rows += part
    key = lambda r: (r.split("\t")[0], int(r.split("\t")[1]), r.split("\t")[3])
    assert sorted(rows, key=key) == sorted(single.decode().splitlines(), key=key)


def test_dist_coordinator_and_cuda_without_gpu_raise(modbam, tmp_path, monkeypatch):
    import torch

    # a coordinator for one process is refused (the collective merge itself
    # runs in tests/test_torch_call_freq_dist.py)
    with pytest.raises(ValueError, match="requires --num_processes > 1"):
        _run(cfb, modbam.bam, str(tmp_path / "d"), num_processes=1,
             dist_coordinator="localhost:1")
    npz = str(tmp_path / "aggr.npz")
    save_params(npz, init_aggr_attrnn(1, AggrConfig()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _run(cfb, modbam.bam, str(tmp_path / "c"), call_mode="aggregate",
             aggre_model=npz, device="cuda")


@pytest.mark.parametrize("model_type", ["attbigru", "attbilstm"])
def test_aggregate_mode_matches_the_jax_package(modbam, tmp_path, model_type):
    """The same seeded .npz through both packages: rows equal except at most
    max(1, rows // 200), the JAX package's own allowance
    (tests/test_call_freq_bam.py:216-220); every batch through K1's plain
    version, padded to 1024 rows."""
    npz = str(tmp_path / "aggr.npz")
    save_params(npz, init_aggr_attrnn(
        9, AggrConfig(model_type=model_type, dropout_rate=0.0)))
    kw = dict(call_mode="aggregate", aggre_model=npz, model_type=model_type,
              cov_cf=2, sort=True)
    before = bigru.plain_calls
    ours = _by_tag(_run(cfb, modbam.bam, str(tmp_path / "ours"), **kw))
    run = dict(cfb.LAST_RUN)
    theirs = _by_tag(_run(jax_cfb, modbam.bam, str(tmp_path / "theirs"), **kw))
    assert run["batches"] > 0 and run["rows"] == 1024 * run["batches"]
    assert bigru.plain_calls - before == run["batches"]
    assert ours.keys() == theirs.keys() == {"all", "hp1", "hp2"}
    n_rows = n_diff = 0
    for tag in ours:
        a = _read(ours[tag]).decode().splitlines()
        b = _read(theirs[tag]).decode().splitlines()
        assert len(a) == len(b) > 0
        n_rows += len(a)
        n_diff += sum(x != y for x, y in zip(a, b))
    assert n_diff <= max(1, n_rows // 200), (n_diff, n_rows)
    print("aggregate {}: {} rows, {} differ".format(model_type, n_rows, n_diff))


def test_cli_call_freqb_on_cpu(modbam, tmp_path):
    """python -m ccsmeth_tpu_torch.cli call_freqb, aggregate mode on the CPU,
    equals the library call."""
    npz = str(tmp_path / "aggr.npz")
    save_params(npz, init_aggr_attrnn(4, AggrConfig()))
    lib = _by_tag(_run(cfb, modbam.bam, str(tmp_path / "lib"), call_mode="aggregate",
                       aggre_model=npz, cov_cf=2, bed=True))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "ccsmeth_tpu_torch.cli", "call_freqb", "-i", modbam.bam,
         "--ref", REF, "-o", str(tmp_path / "cli"), "--chunk_len", "500",
         "--call_mode", "aggregate", "-m", npz, "--cov_cf", "2", "--bed",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for tag, path in lib.items():
        assert _read(path) == _read(str(tmp_path / "cli.aggregate.{}.bed".format(tag)))

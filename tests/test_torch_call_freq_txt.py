"""call_freqt through the port (a copy of the JAX package's host module)
byte-equal to the JAX package's on the committed golden per_readsite.tsv,
over its output and filter options."""

import os
import subprocess
import sys

import pytest
import torch

from ccsmeth_tpu.pipeline import call_freq_txt as jax_cft
from ccsmeth_tpu_torch.pipeline import call_freq_txt as cft

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
PRS = os.path.join(GOLD, "per_readsite.tsv")
REF = os.path.join(GOLD, "ref.fa")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kw", [dict(), dict(bed=True), dict(sort=True),
                                dict(gzip=True), dict(rm_1strand=True, prob_cf=0.2),
                                dict(refsites_only=True, ref=REF),
                                dict(contigs="chrS", threads=2)])
def test_call_freqt_equals_the_jax_package(tmp_path, kw):
    ext = ".bed" if kw.get("bed") else ".txt"
    outs = []
    for pkg, name in ((cft, "ours"), (jax_cft, "theirs")):
        path = str(tmp_path / (name + ext))
        pkg.call_mods_frequency_to_file(pkg.FreqTxtConfig(
            input_path=[PRS], result_file=path, **kw))
        outs.append(path + (".gz" if kw.get("gzip") else ""))
    assert len(_read(outs[0])) > 100
    assert _read(outs[0]) == _read(outs[1])


def test_cli_call_freqt_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = str(tmp_path / "cli.txt")
    proc = subprocess.run(
        [sys.executable, "-m", "ccsmeth_tpu_torch.cli", "call_freqt", "-i", PRS,
         "-o", out, "--sort"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = str(tmp_path / "lib.txt")
    jax_cft.call_mods_frequency_to_file(jax_cft.FreqTxtConfig(
        input_path=[PRS], result_file=want, sort=True))
    assert _read(out) == _read(want)

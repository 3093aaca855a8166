"""The port's copies of the three root scripts that reach the model code
(``python -m ccsmeth_tpu_torch.scripts.<name>``) against the root scripts,
which run with the JAX package in a subprocess as ``tests/test_scripts.py``
runs them, on the same inputs: per-read-site rows (both formats) and the
coverage-subsampling harness on the golden reads' modbam, and the
checkpoint converter on a reference torch checkpoint. Each output is
byte-equal."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models import AttRNN, AttRNNConfig, attrnn_state_dict_from_params
from ccsmeth_tpu_torch.models import init_attrnn
from tests.test_scripts import run_script
from tests.test_torch_call_freq import GOLD, REF, modbam  # noqa: F401

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_port(name, *args, cwd=REPO):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "ccsmeth_tpu_torch.scripts." + name,
                          *args], capture_output=True, text=True, env=env, cwd=cwd,
                         timeout=180)
    assert out.returncode == 0, "{} failed:\n{}\n{}".format(name, out.stdout,
                                                            out.stderr)
    return out.stdout


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("extra", [[], ["--sitelist"], ["--no_comb", "--refsites_only"]])
def test_per_readsite_rows_equal_the_root_script(modbam, tmp_path, extra):
    ours, theirs = str(tmp_path / "ours.tsv"), str(tmp_path / "theirs.tsv")
    run_port("call_mods_freq_bam_per_readsite", "-i", modbam.bam, "--ref", REF,
             "-o", ours, *extra)
    run_script("call_mods_freq_bam_per_readsite.py", "-i", modbam.bam, "--ref", REF,
               "-o", theirs, *extra)
    assert _read(ours) == _read(theirs) and _read(ours)


def test_subsample_and_eval_equals_the_root_script(modbam, tmp_path):
    """Count mode at two fractions against a BS-seq bed made from the golden
    frequencies: the same table and the same subsampled bedMethyl files."""
    bs = str(tmp_path / "bs.bed")
    with open(os.path.join(GOLD, "freq_count.all.tsv")) as f, open(bs, "w") as w:
        for i, line in enumerate(f):
            c = line.split("\t")
            w.write("\t".join([c[0], c[1], c[2], ".", "10", c[3], c[1], c[2],
                               "0,0,0", "10", str((i * 37) % 101)]) + "\n")
    args = ["-i", modbam.bam, "--ref", REF, "--bs_bed", bs, "--fracs", "0.5,1.0",
            "--bs_cov_cf", "1", "--seed", "9"]
    out_ours = run_port("subsample_and_eval_modbam", *args, "--wdir",
                        str(tmp_path / "ours"))
    out_theirs = run_script("subsample_and_eval_modbam.py", *args, "--wdir",
                            str(tmp_path / "theirs"))
    assert out_ours == out_theirs
    rows = out_ours.strip().splitlines()
    assert len(rows) == 3 and rows[2].split("\t")[0] == "1.00"
    assert int(rows[2].split("\t")[4]) > 1  # sites shared with the truth
    names = sorted(os.listdir(str(tmp_path / "ours")))
    assert names == sorted(os.listdir(str(tmp_path / "theirs"))) and names
    for name in names:
        assert _read(str(tmp_path / "ours" / name)) \
            == _read(str(tmp_path / "theirs" / name)), name


def test_unzip_model_ckpt_equals_the_root_script(tmp_path):
    """A reference-style torch .ckpt (DDP's 'module.' prefix) of a seeded
    attbigru2s at the defaults (3 x 256)."""
    cfg = AttRNNConfig(dropout_rate=0)
    model = AttRNN(cfg)
    model.load_state_dict(attrnn_state_dict_from_params(init_attrnn(7, cfg)))
    ckpt = str(tmp_path / "model.ckpt")
    torch.save({"module." + k: v for k, v in model.state_dict().items()}, ckpt)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    said = run_port("unzip_model_ckpt", "--model_file", ckpt, "-o", ours)
    assert said == "converted {} -> {}\n".format(ckpt, ours)
    run_script("unzip_model_ckpt.py", "--model_file", ckpt, "-o", theirs)
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files) and a.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the inspection of an .npz prints the same leaves and shapes
    shown = run_port("unzip_model_ckpt", "--model_file", ours)
    assert shown == run_script("unzip_model_ckpt.py", "--model_file", ours)
    assert "embed" in shown

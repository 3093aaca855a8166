"""The port's call_hifi / align_hifi wrappers (copies of the JAX package's,
``tests/test_wrappers.py``'s checks on them) and their CLI subcommands: the
same arguments as the JAX CLI's, and the named errors on a bad input or a
missing binary. No pbccs, pbmm2, minimap2 or bwa is installed, so commands
are checked, not run."""

import io

import pytest
import torch

from ccsmeth_tpu import cli as jax_cli
from ccsmeth_tpu_torch import cli
from ccsmeth_tpu_torch.wrappers.align_hifi import (AlignHifiConfig, bam2fastq_stream,
                                                   generate_aligner_cmd)
from ccsmeth_tpu_torch.wrappers.call_hifi import CallHifiConfig, generate_ccs_cmd
from tests.synth import make_synth_bam

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once


def test_ccs_cmd_construction():
    cfg = CallHifiConfig(subreads="x.subreads.bam", threads=8, min_passes=3,
                         by_strand=True, hd_finder=True, log_level="INFO")
    cmd = generate_ccs_cmd(cfg)
    assert cmd.startswith("ccs --hifi-kinetics")
    for part in ("--log-level INFO", "--min-passes 3", "--num-threads 8",
                 "--by-strand", "--hd-finder"):
        assert part in cmd
    cmd2 = generate_ccs_cmd(CallHifiConfig())
    assert "--min-passes" not in cmd2 and "--by-strand" not in cmd2


def test_aligner_cmd_construction():
    assert generate_aligner_cmd(AlignHifiConfig(threads=6)).startswith(
        "pbmm2 align --preset CCS -j 6 --sort")
    cmd = generate_aligner_cmd(AlignHifiConfig(minimap2=True, bestn=1, threads=4))
    assert "minimap2 -ax map-hifi -y -t 4 --secondary=no" in cmd
    assert "-N 2" in generate_aligner_cmd(AlignHifiConfig(minimap2=True, bestn=3,
                                                          threads=4))
    assert generate_aligner_cmd(AlignHifiConfig(bwa=True, threads=2)).startswith(
        "bwa mem -x pacbio -C -V -t 2")


def test_bam2fastq_preserves_tags(tmp_path):
    bam = str(tmp_path / "x.bam")
    make_synth_bam(bam, n_reads=3, read_len=50, ref_len=500)
    out = io.StringIO()
    assert bam2fastq_stream(bam, out) == 3
    lines = out.getvalue().splitlines()
    assert len(lines) == 12
    assert lines[0].startswith("@m0/0/ccs\t")
    assert "fi:B:C," in lines[0] and "fn:i:" in lines[0] and "sn:B:f," in lines[0]
    assert len(lines[1]) == 50 and lines[2] == "+" and len(lines[3]) == 50


def test_subcommands_raise_their_named_errors(tmp_path):
    """Through the CLI: a bad input's ValueError, a missing file's IOError,
    and a missing binary's error for a real input (no pbccs or aligner)."""
    with pytest.raises(ValueError, match="bam format"):
        cli.main(["call_hifi", "-i", "x.fastq"])
    with pytest.raises(IOError):
        cli.main(["call_hifi", "-i", str(tmp_path / "nope.bam")])
    with pytest.raises(ValueError, match="bam/sam/fastq"):
        cli.main(["align_hifi", "-i", "x.txt", "--ref", "r.fa"])
    with pytest.raises(IOError):
        cli.main(["align_hifi", "-i", str(tmp_path / "nope.bam"), "--ref", "nope.fa"])
    bam = str(tmp_path / "x.subreads.bam")
    make_synth_bam(bam, n_reads=2, read_len=40, ref_len=300)
    with pytest.raises(RuntimeError, match="ccs failed"):
        cli.main(["call_hifi", "-i", bam, "--path_to_ccs", str(tmp_path / "no_ccs")])
    ref = str(tmp_path / "r.fa")
    with open(ref, "w") as f:
        f.write(">chr1\nACGT\n")
    with pytest.raises(RuntimeError, match="alignment failed"):
        cli.main(["align_hifi", "-i", bam, "--ref", ref, "--path_to_pbmm2",
                  str(tmp_path / "no_pbmm2")])


@pytest.mark.parametrize("argv", [
    ["call_hifi", "-i", "s.bam", "-o", "h.bam", "--threads", "4", "--min-passes", "3",
     "--by-strand", "--hd-finder", "--log-level", "INFO"],
    ["align_hifi", "-i", "h.bam", "--ref", "r.fa", "--minimap2", "-n", "2", "-t", "3",
     "--header", "--bwa"]])
def test_subcommand_arguments_equal_the_jax_cli(argv):
    got = vars(cli.get_parser().parse_args(argv))
    want = vars(jax_cli.get_parser().parse_args(argv))
    assert {k: v for k, v in got.items() if k != "func"} == \
        {k: v for k, v in want.items() if k != "func"}

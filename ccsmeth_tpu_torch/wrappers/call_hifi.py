"""call_hifi: subreads.bam -> hifi.bam with kinetics via pbccs.

Command construction parity with ccsmeth/call_hifi_reads.py:34-88.
pbccs/samtools stay external binaries (upstream of the model, not in the hot loop;
SURVEY.md §2.9). When samtools is absent, BAM outputs fall back to this engine's
in-repo indexless path (the downstream stages here do not require .bai).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time

from ..utils.logging import mylogger
from ..utils.process import run_cmd

LOGGER = mylogger(__name__)


@dataclasses.dataclass
class CallHifiConfig:
    subreads: str = ""
    output: str | None = None
    path_to_ccs: str | None = None
    threads: int | None = None
    min_passes: int | None = None
    by_strand: bool = False
    hd_finder: bool = False
    log_level: str = "WARN"
    path_to_samtools: str | None = None


def _check_output(outputfile, inputfile):
    if outputfile is None:
        fname, _ = os.path.splitext(inputfile)
        if fname.endswith(".subreads"):
            fname = fname[: -len(".subreads")]
        return fname + ".hifi.bam"
    if not outputfile.endswith((".sam", ".bam")):
        raise ValueError("--output/-o must be in bam/sam format!")
    return os.path.abspath(outputfile)


def generate_ccs_cmd(cfg: CallHifiConfig) -> str:
    ccs_path = cfg.path_to_ccs if cfg.path_to_ccs else "ccs"
    cmd = ccs_path + " --hifi-kinetics"
    cmd += " --log-level {}".format(cfg.log_level)
    if cfg.min_passes is not None:
        cmd += " --min-passes {}".format(cfg.min_passes)
    if cfg.threads is not None:
        cmd += " --num-threads {}".format(cfg.threads)
    if cfg.by_strand:
        cmd += " --by-strand"
    if cfg.hd_finder:
        cmd += " --hd-finder"
    return cmd


def ccs_call_hifi_reads(cfg: CallHifiConfig) -> str:
    LOGGER.info("[main]call_hifi_reads starts")
    start = time.time()
    if not cfg.subreads.endswith(".bam"):
        raise ValueError("--subreads/-i must be in bam format!")
    inputpath = os.path.abspath(cfg.subreads)
    if not os.path.exists(inputpath):
        raise IOError("input file does not exist!")
    outputpath = _check_output(cfg.output, inputpath)

    ccscaller = generate_ccs_cmd(cfg)
    samtools = cfg.path_to_samtools or "samtools"
    have_samtools = shutil.which(samtools.split()[0]) is not None

    if outputpath.endswith(".bam"):
        cmds = " ".join([ccscaller, inputpath, outputpath])
        if have_samtools:
            cmds += " && {} index -@ {} {}".format(samtools, cfg.threads or 3, outputpath)
    else:
        tmp_bam = outputpath + ".tmp.bam"
        cmds = " ".join([ccscaller, inputpath, tmp_bam])
        cmds += " && {} view -@ {} -h {} > {} && rm {}*".format(
            samtools, cfg.threads or 3, tmp_bam, outputpath, tmp_bam)

    LOGGER.info("cmds: %s", cmds)
    stdinfo, returncode = run_cmd(cmds)
    stdout, stderr = stdinfo
    LOGGER.info("succeeded" if not returncode else "failed")
    LOGGER.info("stdout:\n%s", stdout.decode("utf-8", "replace"))
    LOGGER.info("stderr:\n%s", stderr.decode("utf-8", "replace"))
    LOGGER.info("[main]call_hifi_reads costs %.1f seconds", time.time() - start)
    if returncode:
        raise RuntimeError("ccs failed (exit {})".format(returncode))
    return outputpath

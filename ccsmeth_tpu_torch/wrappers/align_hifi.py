"""align_hifi: hifi.bam/fastq -> aligned sorted bam via pbmm2/minimap2/bwa.

Command construction parity with ccsmeth/align_hifi_reads.py:45-151.
The minimap2/bwa paths need BAM->FASTQ conversion preserving tags; the reference
shells out to a helper script via samtools view | python sam2fastq — here the
conversion is in-process through this engine's own BAM reader (bam2fastq_stream),
avoiding one samtools dependency and a subprocess hop.
"""

from __future__ import annotations

import dataclasses
import os
import time

from ..bamio import BamReader
from ..utils.logging import mylogger
from ..utils.process import run_cmd

LOGGER = mylogger(__name__)


@dataclasses.dataclass
class AlignHifiConfig:
    hifireads: str = ""
    ref: str = ""
    output: str | None = None
    path_to_pbmm2: str | None = None
    minimap2: bool = False
    path_to_minimap2: str | None = None
    bestn: int = 3
    bwa: bool = False
    path_to_bwa: str | None = None
    path_to_samtools: str | None = None
    threads: int = 5


def _sam_escape_tag(tag, ty, val) -> str:
    import numpy as np

    if ty in ("i", "c", "C", "s", "S", "I"):
        return "{}:i:{}".format(tag, int(val))
    if ty == "f":
        return "{}:f:{}".format(tag, val)
    if ty in ("Z", "H", "A"):
        return "{}:{}:{}".format(tag, ty, val)
    if ty.startswith("B"):
        sub = ty[1]
        vals = np.asarray(val)
        if sub == "f":
            body = ",".join(str(float(x)) for x in vals)
        else:
            body = ",".join(str(int(x)) for x in vals)
        return "{}:B:{},{}".format(tag, sub, body)
    raise ValueError("cannot encode tag type " + ty)


def bam2fastq_stream(bam_path: str, out_fh) -> int:
    """BAM/SAM -> FASTQ with tags appended on the header line (minimap2 -y / bwa -C
    consume them). Parity with utils/sam2fastq_std.py semantics."""
    n = 0
    with BamReader(bam_path) as reader:
        for rec in reader:
            tags = "\t".join(_sam_escape_tag(t, ty, v) for t, ty, v in rec.tags)
            qual = "~" * len(rec.seq) if rec.qual is None else \
                "".join(chr(q + 33) for q in rec.qual)
            out_fh.write("@{}\t{}\n{}\n+\n{}\n".format(rec.qname, tags, rec.seq, qual))
            n += 1
    return n


def generate_aligner_cmd(cfg: AlignHifiConfig) -> str:
    """Parity with align_hifi_reads.py:45-69."""
    if cfg.minimap2:
        aligner = cfg.path_to_minimap2 or "minimap2"
        num_secondary = cfg.bestn - 1
        if num_secondary in (0, 1):
            aligner += " -ax map-hifi -y -t {t} --secondary=no".format(t=cfg.threads)
        else:
            aligner += " -ax map-hifi -y -t {t} -N {N}".format(t=cfg.threads,
                                                               N=num_secondary)
    elif cfg.bwa:
        aligner = cfg.path_to_bwa or "bwa"
        aligner += " mem -x pacbio -C -V -t {t}".format(t=cfg.threads)
    else:
        aligner = cfg.path_to_pbmm2 or "pbmm2"
        aligner += " align --preset CCS -j {t} --sort ".format(t=cfg.threads)
    return aligner


def align_hifi_reads_to_genome(cfg: AlignHifiConfig) -> str:
    LOGGER.info("[main]align_hifi_reads starts")
    start = time.time()
    if not cfg.hifireads.endswith((".bam", ".sam", ".fq", ".fastq")):
        raise ValueError("--hifireads/-i must be in bam/sam/fastq format!")
    inputpath = os.path.abspath(cfg.hifireads)
    reference = os.path.abspath(cfg.ref)
    if not os.path.exists(inputpath):
        raise IOError("input file does not exist!")
    if not os.path.exists(reference):
        raise IOError("refernce(--ref) file does not exist!")
    if cfg.output is None:
        fname, _ = os.path.splitext(inputpath)
        aligner_name = "minimap2" if cfg.minimap2 else ("bwa" if cfg.bwa else "pbmm2")
        outputpath = fname + "." + aligner_name + ".bam"
    else:
        if not cfg.output.endswith((".sam", ".bam")):
            raise ValueError("--output/-o must be in bam/sam format!")
        outputpath = os.path.abspath(cfg.output)

    aligner = generate_aligner_cmd(cfg)
    samtools = cfg.path_to_samtools or "samtools"

    if not cfg.minimap2 and not cfg.bwa:
        # pbmm2 consumes BAM directly and sorts itself
        if outputpath.endswith(".bam"):
            cmds = " ".join([aligner, reference, inputpath, outputpath])
            cmds += " && {} index -@ {} {}".format(samtools, cfg.threads, outputpath)
        else:
            cmds = "{} {} {} | {} view -@ {} -h - > {}".format(
                aligner, reference, inputpath, samtools, max(cfg.threads // 2, 1),
                outputpath)
        LOGGER.info("cmds: %s", cmds)
        stdinfo, returncode = run_cmd(cmds)
    else:
        # minimap2/bwa path: fastq (+tags) on stdin
        fq_path = None
        if inputpath.endswith((".fq", ".fastq")):
            align_in = inputpath
        else:
            fq_path = outputpath + ".tmp.fastq"
            with open(fq_path, "w") as f:
                n = bam2fastq_stream(inputpath, f)
            LOGGER.info("converted %d reads to fastq", n)
            align_in = fq_path
        if outputpath.endswith(".sam"):
            cmds = "{} {} {} > {}".format(aligner, reference, align_in, outputpath)
        else:
            cmds = ("{} {} {} | {} view -@ {} -h -b | {} sort -@ {} -o {} - && "
                    "{} index -@ {} {}").format(
                aligner, reference, align_in, samtools, max(cfg.threads // 2, 1),
                samtools, max(cfg.threads // 2, 1), outputpath, samtools,
                cfg.threads, outputpath)
        LOGGER.info("cmds: %s", cmds)
        stdinfo, returncode = run_cmd(cmds)
        if fq_path and os.path.exists(fq_path):
            os.remove(fq_path)
    stdout, stderr = stdinfo
    LOGGER.info("succeeded.." if not returncode else "failed..")
    LOGGER.info("stdout:\n%s", stdout.decode("utf-8", "replace"))
    LOGGER.info("stderr:\n%s", stderr.decode("utf-8", "replace"))
    LOGGER.info("[main]align_hifi_reads costs %.1f seconds", time.time() - start)
    if returncode:
        raise RuntimeError("alignment failed (exit {})".format(returncode))
    return outputpath

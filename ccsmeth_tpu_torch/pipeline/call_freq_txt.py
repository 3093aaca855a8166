"""call_freqt: per_readsite TSV(s) -> per-site methylation frequencies.

Semantics parity with ccsmeth/call_mods_freq_txt.py: aggregate
per-read-site rows keyed by chrom||pos||strand into met/unmet counts + summed
probs; optional per-contig decomposition (the reference forks a process per
contig; here contigs are processed in one pass with per-contig grouping — the
genome-decomposition axis that shards across hosts at scale).
"""

from __future__ import annotations

import dataclasses
import os
import time

from ..bamio import create_text_gz, open_text_auto
from ..utils.codecs import complement_seq, get_motif_seqs
from ..utils.constants import DEFAULT_REF_LOC
from ..utils.fasta import DNAReference
from ..utils.logging import mylogger

LOGGER = mylogger(__name__)

KEY_SEP = "||"


class SiteStats:
    __slots__ = ("kmer", "prob_0", "prob_1", "met", "unmet", "coverage")

    def __init__(self, kmer: str):
        self.kmer = kmer
        self.prob_0 = 0.0
        self.prob_1 = 0.0
        self.met = 0
        self.unmet = 0
        self.coverage = 0


@dataclasses.dataclass
class FreqTxtConfig:
    input_path: list[str] = dataclasses.field(default_factory=list)
    result_file: str = ""
    file_uid: str | None = None
    contigs: str | None = None
    threads: int = 1
    bed: bool = False
    sort: bool = False
    prob_cf: float = 0.0
    rm_1strand: bool = False
    gzip: bool = False
    refsites_only: bool = False
    motifs: str = "CG"
    mod_loc: int = 0
    ref: str | None = None


def calculate_mods_frequency(mods_files, prob_cf: float, rm_1strand: bool = False,
                             contig_names: set | None = None) -> dict[str, SiteStats]:
    """Parity with call_mods_freq_txt.py:70-121."""
    if isinstance(mods_files, str):
        mods_files = [mods_files]
    stats: dict[str, SiteStats] = {}
    count = used = 0
    for mods_file in mods_files:
        opener = ((lambda p, _m="rt": open_text_auto(p))
                  if mods_file.endswith(".gz") else open)
        with opener(mods_file, "rt") as infile:
            for line in infile:
                w = line.strip().split("\t")
                pos = int(w[1])
                if pos == DEFAULT_REF_LOC:
                    continue
                if contig_names is not None and w[0] not in contig_names:
                    continue
                count += 1
                depthstr = w[5]
                if rm_1strand and "," not in depthstr:
                    continue
                prob_0 = float(w[6])
                prob_1 = float(w[7])
                if abs(prob_0 - prob_1) < prob_cf:
                    continue
                key = KEY_SEP.join([w[0], str(pos), w[2]])
                st = stats.get(key)
                if st is None:
                    st = stats[key] = SiteStats(w[9] if len(w) > 9 else "-")
                st.prob_0 += prob_0
                st.prob_1 += prob_1
                st.coverage += 1
                if int(w[8]) == 1:
                    st.met += 1
                else:
                    st.unmet += 1
                used += 1
    if count == 0:
        raise ValueError("No modification calls found in {}..".format(mods_files))
    LOGGER.info("%.2f%% (%d of %d) calls used..", used / float(count) * 100, used, count)
    return stats


def _split_key(key: str):
    w = key.split(KEY_SEP)
    return w[0], int(w[1]), w[2]


def write_sitekey2stats(stats: dict[str, SiteStats], result_file: str, is_sort: bool,
                        is_bed: bool, is_gzip: bool, motifs=None, mod_loc=None,
                        dnacontigs=None) -> str:
    """Parity with call_mods_freq_txt.py:124-189 (row formats incl. %.3f/%.4f)."""
    fwd_s = fwd_e = rev_s = rev_e = None
    if motifs is not None:
        len_motif = len(motifs[0])
        fwd_s = -mod_loc
        fwd_e = len_motif - mod_loc
        rev_s = -(len_motif - 1 - mod_loc)
        rev_e = mod_loc + 1
        motifs = set(motifs)
    keys = sorted(stats.keys(), key=_split_key) if is_sort else list(stats.keys())
    if is_gzip:
        if not result_file.endswith(".gz"):
            result_file += ".gz"
        wf = create_text_gz(result_file)
    else:
        wf = open(result_file, "w")
    for key in keys:
        chrom, pos, strand = _split_key(key)
        if motifs is not None:
            motif_seq = (dnacontigs[chrom][(pos + fwd_s):(pos + fwd_e)]
                         if strand == "+" else
                         complement_seq(dnacontigs[chrom][(pos + rev_s):(pos + rev_e)]))
            if motif_seq not in motifs:
                continue
        st = stats[key]
        assert st.coverage == st.met + st.unmet
        if st.coverage > 0:
            rmet = float(st.met) / st.coverage
            if is_bed:
                wf.write("\t".join([
                    chrom, str(pos), str(pos + 1), ".", str(st.coverage), strand,
                    str(pos), str(pos + 1), "0,0,0", str(st.coverage),
                    str(int(round(rmet * 100 + 0.001, 0)))]) + "\n")
            else:
                wf.write("%s\t%d\t%d\t%s\t%.3f\t%.3f\t%d\t%d\t%d\t%.4f\t%s\n" % (
                    chrom, pos, pos + 1, strand, st.prob_0, st.prob_1, st.met,
                    st.unmet, st.coverage, rmet + 0.000001, st.kmer))
        else:
            LOGGER.info("%s %s has no coverage..", chrom, pos)
    wf.flush()
    wf.close()
    return result_file


def _collect_input_files(cfg: FreqTxtConfig) -> list[str]:
    mods_files = []
    for ipath in cfg.input_path:
        input_path = os.path.abspath(ipath)
        if os.path.isdir(input_path):
            for ifile in sorted(os.listdir(input_path)):
                if cfg.file_uid is None or ifile.find(cfg.file_uid) != -1:
                    mods_files.append(os.path.join(input_path, ifile))
        elif os.path.isfile(input_path):
            mods_files.append(input_path)
        else:
            raise ValueError("--input_path is not a file or a directory!")
    return mods_files


def _get_contig_names(contigs_arg: str) -> list[str]:
    if os.path.isfile(contigs_arg):
        with open(contigs_arg) as rf:
            first = ""
            for line in rf:
                if not line.startswith("#"):
                    first = line
                    break
        if contigs_arg.endswith((".fa", ".fasta", ".fna")) or first.startswith(">"):
            names = []
            with open(contigs_arg) as rf:
                for line in rf:
                    if line.startswith(">"):
                        names.append(line.strip()[1:].split(" ")[0])
            return names
        with open(contigs_arg) as rf:
            return sorted(set(rf.read().splitlines()))
    return sorted(set(contigs_arg.strip().split(",")))


def call_mods_frequency_to_file(cfg: FreqTxtConfig) -> str:
    LOGGER.info("[main]call_freq starts")
    start = time.time()
    dnacontigs = motifs = modloc = None
    if cfg.refsites_only:
        if cfg.ref is None:
            raise ValueError("--ref must be set when --refsites_only is True!")
        if not os.path.exists(cfg.ref):
            raise ValueError("--ref doesn't exist!")
        dnacontigs = DNAReference(cfg.ref).getcontigs()
        motifs = get_motif_seqs(cfg.motifs)
        modloc = cfg.mod_loc
        LOGGER.info("[###] --refsites_only: keeping only motifs(%s) reference sites",
                    motifs)
    mods_files = _collect_input_files(cfg)
    LOGGER.info("get %d input file(s)..", len(mods_files))
    if cfg.contigs is None:
        stats = calculate_mods_frequency(mods_files, cfg.prob_cf, cfg.rm_1strand)
        out = write_sitekey2stats(stats, cfg.result_file, cfg.sort, cfg.bed, cfg.gzip,
                                  motifs, modloc, dnacontigs)
    else:
        contig_names = _get_contig_names(cfg.contigs)
        # one pass; per-contig grouping happens in the key space already
        stats = calculate_mods_frequency(mods_files, cfg.prob_cf, cfg.rm_1strand,
                                         contig_names=set(contig_names))
        # emit per-contig blocks concatenated in sorted-contig order (reference
        # concatenates per-contig result files sorted by name, lines 272-284)
        per_contig: dict[str, dict] = {c: {} for c in contig_names}
        for key, st in stats.items():
            per_contig[key.split(KEY_SEP)[0]][key] = st
        tmp_files = []
        base, fext = os.path.splitext(cfg.result_file)
        for contig in sorted(contig_names):
            if not per_contig[contig]:
                continue
            tmp = "{}.{}{}".format(base, contig, fext)
            write_sitekey2stats(per_contig[contig], tmp, cfg.sort, cfg.bed, False,
                                motifs, modloc, dnacontigs)
            tmp_files.append(tmp)
        out = cfg.result_file
        if cfg.gzip and not out.endswith(".gz"):
            out += ".gz"
        wf = create_text_gz(out) if cfg.gzip else open(out, "w")
        for tmp in sorted(tmp_files):
            with open(tmp) as rf:
                wf.write(rf.read())
            os.remove(tmp)
        wf.close()
    LOGGER.info("[main]call_freq costs %.1f seconds", time.time() - start)
    return out

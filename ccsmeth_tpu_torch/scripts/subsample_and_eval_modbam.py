#!/usr/bin/env python
"""Subsample a modbam to target coverage fractions, run call_freqb on each
subsample, and report correlation vs BS-seq truth — the coverage-robustness
harness. Capability parity with scripts/subsample_and_eval_modbam.py
(samtools view -s replaced by an in-process random read filter).
"""

import argparse
import math
import os
import random

import numpy as np
import scipy.stats

from ..bamio import BamReader, BamWriter
from ..pipeline.call_freq_bam import (
    FreqBamConfig,
    call_mods_frequency_from_bamfile,
)


def subsample_bam(in_bam, out_bam, frac, seed):
    rng = random.Random(seed)
    reader = BamReader(in_bam)
    n = 0
    with BamWriter(out_bam, reader.header) as w:
        for rec in reader:
            if rng.random() < frac:
                w.write(rec)
                n += 1
    reader.close()
    return n


def read_bed_rmet(path, cov_cf=1):
    out = {}
    for line in open(path):
        w = line.strip().split("\t")
        if len(w) == 11 and w[8] == "0,0,0":  # bedMethyl
            if int(w[9]) >= cov_cf:
                out[(w[0], int(w[1]))] = float(w[10]) / 100.0
        elif len(w) == 11:  # freq.txt
            if int(w[8]) >= cov_cf:
                out[(w[0], int(w[1]))] = float(w[9])
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_bam", "-i", "--bam", dest="input_bam", type=str,
                        required=True)
    parser.add_argument("--ref", "--genomefa", dest="ref", type=str,
                        required=True)
    parser.add_argument("--bs_bed", "--cmp_bed", dest="bs_bed", type=str,
                        required=True)
    parser.add_argument("--fracs", type=str, default="0.1,0.25,0.5,0.75,1.0")
    parser.add_argument("--covs", type=str, default=None,
                        help="target mean coverages (reference interface); "
                             "converted to fractions via --genome_size/--total")
    parser.add_argument("--genome_size", type=float, default=None,
                        help="genome size in bases (with --covs)")
    parser.add_argument("--total", type=float, default=None,
                        help="total sequenced bases in the bam (with --covs; "
                             "computed from the bam when omitted)")
    parser.add_argument("--repeat", type=int, default=1,
                        help="subsampling repeats per fraction (seed offset)")
    parser.add_argument("--contig_names", type=str, default=None,
                        help="comma-separated contigs to keep in the eval")
    parser.add_argument("--is_clip", action="store_true", default=False,
                        help="[compat] clip handling is automatic here")
    parser.add_argument("--is_nohap", action="store_true", default=False,
                        help="[compat] haplotype outputs are off by default here")
    parser.add_argument("--wdir", "--out_dir", dest="wdir", type=str,
                        default="subsample_eval")
    parser.add_argument("--call_mode", type=str, default="count",
                        choices=["count", "aggregate"])
    parser.add_argument("--aggre_model", type=str, default=None)
    parser.add_argument("--cov_cf", type=int, default=1)
    parser.add_argument("--bs_cov_cf", type=int, default=5)
    parser.add_argument("--seed", type=int, default=1234)
    args = parser.parse_args()

    os.makedirs(args.wdir, exist_ok=True)
    truth = read_bed_rmet(args.bs_bed, args.bs_cov_cf)
    if args.contig_names is not None:
        keep = set(args.contig_names.split(","))
        truth = {k: v for k, v in truth.items() if k[0] in keep}
    fracs = [float(x) for x in args.fracs.split(",")]
    if args.covs is not None:
        # reference interface: target coverages -> fractions of the bam's bases
        if args.genome_size is None:
            parser.error("--covs requires --genome_size")
        total = args.total
        if total is None:
            reader = BamReader(args.input_bam)
            total = float(sum(len(rec.seq) for rec in reader))
            reader.close()
        full_cov = total / args.genome_size
        fracs = [min(float(c) / full_cov, 1.0) for c in args.covs.split(",")]
        print("# full-bam mean coverage {:.2f}x -> fractions {}".format(
            full_cov, ",".join("{:.3f}".format(f) for f in fracs)))
    print("\t".join(["frac", "rep", "reads", "sites", "num_inter", "pearson",
                     "rmse"]))
    for frac, rep in [(f, r) for f in fracs for r in range(max(args.repeat, 1))]:
        tag = "sub_{:.2f}_r{}".format(frac, rep)
        sub_bam = os.path.join(args.wdir, tag + ".bam")
        n = subsample_bam(args.input_bam, sub_bam, frac, args.seed + rep)
        prefix = os.path.join(args.wdir, tag)
        cfg = FreqBamConfig(input_bam=sub_bam, ref=args.ref, output=prefix,
                            call_mode=args.call_mode,
                            aggre_model=args.aggre_model, sort=True, bed=True)
        outs = call_mods_frequency_from_bamfile(cfg)
        all_out = [p for p in outs if ".all." in p]
        if not all_out:
            print("\t".join(["{:.2f}".format(frac), str(rep), str(n), "0", "0",
                             "nan", "nan"]))
            continue
        ours = read_bed_rmet(all_out[0], args.cov_cf)
        inter = sorted(set(ours) & set(truth))
        if len(inter) > 1:
            x = np.array([truth[k] for k in inter])
            y = np.array([ours[k] for k in inter])
            r, _ = scipy.stats.pearsonr(x, y)
            rmse = math.sqrt(float(np.mean((x - y) ** 2)))
            print("\t".join(["{:.2f}".format(frac), str(rep), str(n),
                             str(len(ours)), str(len(inter)),
                             "{:.4f}".format(r), "{:.4f}".format(rmse)]))
        else:
            print("\t".join(["{:.2f}".format(frac), str(rep), str(n),
                             str(len(ours)), str(len(inter)), "nan", "nan"]))


if __name__ == "__main__":
    main()

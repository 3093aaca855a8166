#!/usr/bin/env python
"""modbam -> per-READ-site rows (the input generator for aggregate-model training).

Capability parity with scripts/call_mods_freq_bam.per_readsite.py:
the default output is the reference's 10-column per_readsite format (one row per
read per site; call_mods_freq_bam.per_readsite.py:337-351):

    chrom  pos  strand  read_name  -1  1,1  1-prob  prob  label  -

with CpG fwd/rev combining (rev site r reported at fwd pos r-1, strand "+")
unless --no_comb, and --refsites_only restricting to reference-motif sites.
--sitelist instead emits the compact per-SITE format (chrom, pos, strand,
coverage, comma-joined probs) consumed directly by generate_aggre_train_data.py.
"""

import argparse

from ..bamio import BamReader
from ..pipeline.call_freq_bam import _moddict_arrays
from ..utils.codecs import (
    aligned_pairs_from_cigar,
    complement_seq,
    compute_pct_identity,
    get_motif_seqs,
)
from ..utils.fasta import DNAReference


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_bam", "-i", type=str, required=True)
    parser.add_argument("--ref", type=str, required=True)
    parser.add_argument("--output", "-o", type=str, required=True)
    parser.add_argument("--modtype", type=str, default="5mC", choices=["5mC"])
    parser.add_argument("--motifs", type=str, default="CG")
    parser.add_argument("--mod_loc", type=int, default=0)
    parser.add_argument("--mapq", type=int, default=1)
    parser.add_argument("--identity", type=float, default=0.0)
    parser.add_argument("--no_supplementary", action="store_true", default=False)
    parser.add_argument("--no_comb", action="store_true", default=False)
    parser.add_argument("--refsites_only", action="store_true", default=False)
    parser.add_argument("--hap_tag", type=str, default="HP")
    parser.add_argument("--contigs", type=str, default=None,
                        help="comma-separated contigs to keep")
    parser.add_argument("--prob_cf", type=float, default=0.0,
                        help="skip calls with |p1-p0| < prob_cf")
    parser.add_argument("--chunk_len", type=int, default=500000,
                        help="[compat] linear scan here")
    parser.add_argument("--threads", type=int, default=1,
                        help="[compat] linear scan here")
    parser.add_argument("--sitelist", action="store_true", default=False,
                        help="emit compact per-site rows (chrom, pos, strand, "
                             "coverage, comma-joined probs) instead of the "
                             "10-column per-read-site format")
    args = parser.parse_args()

    dnacontigs = DNAReference(args.ref).getcontigs()
    motifs = set(get_motif_seqs(args.motifs))
    len_motif = len(next(iter(motifs)))
    fwd_s, fwd_e = -args.mod_loc, len_motif - args.mod_loc
    rev_s, rev_e = -(len_motif - 1 - args.mod_loc), args.mod_loc + 1
    combine = args.motifs == "CG" and not args.no_comb

    def motif_ok(contig, pos, strand):
        if not args.refsites_only:
            return True
        seq = dnacontigs[contig]
        if strand == "+":
            return seq[pos + fwd_s : pos + fwd_e] in motifs
        return complement_seq(seq[pos + rev_s : pos + rev_e]) in motifs

    reader = BamReader(args.input_bam)
    refnames = [r[0] for r in reader.header.references]
    site_table: dict = {}  # (contig, pos, strand) -> [probs] for --sitelist
    n_rows = 0
    wf = open(args.output, "w") if not args.sitelist else None
    for rec in reader:
        if rec.ref_id < 0 or rec.is_unmapped or rec.is_secondary or rec.is_duplicate:
            continue
        if args.no_supplementary and rec.is_supplementary:
            continue
        if rec.mapq < args.mapq:
            continue
        if compute_pct_identity(rec.get_cigar_stats()) < args.identity:
            continue
        contig = refnames[rec.ref_id]
        if contig not in dnacontigs:
            continue
        if args.contigs is not None and contig not in set(args.contigs.split(",")):
            continue
        modpos, modprobs = _moddict_arrays(rec, "C", "m")
        if len(modpos) == 0:
            continue
        moddict = dict(zip(modpos.tolist(), modprobs.tolist()))
        pairs = aligned_pairs_from_cigar(rec.cigar, rec.pos, True)
        for q_pos, r_pos in pairs:
            if q_pos not in moddict:
                continue
            prob = moddict[q_pos]
            if abs(prob - (1 - prob)) < args.prob_cf:
                continue
            if rec.is_reverse:
                pos, strand = (r_pos - 1, "+") if combine else (r_pos, "-")
                if combine and pos < 0:
                    continue
            else:
                pos, strand = r_pos, "+"
            if not motif_ok(contig, r_pos, "-" if rec.is_reverse else "+"):
                continue
            if args.sitelist:
                site_table.setdefault((contig, pos, strand), []).append(prob)
            else:
                label = 1 if prob > 0.5 else 0
                wf.write("\t".join(map(str, (
                    contig, pos, strand, rec.qname, "-1", "1,1",
                    1 - prob, prob, label, "-"))) + "\n")
            n_rows += 1
    reader.close()
    if args.sitelist:
        with open(args.output, "w") as sf:
            for (contig, pos, strand) in sorted(site_table.keys()):
                probs = site_table[(contig, pos, strand)]
                sf.write("\t".join([
                    contig, str(pos), strand, str(len(probs)),
                    ",".join("{:.6f}".format(p) for p in probs)]) + "\n")
        print("wrote {} sites -> {}".format(len(site_table), args.output))
    else:
        wf.close()
        print("wrote {} read-site rows -> {}".format(n_rows, args.output))


if __name__ == "__main__":
    main()

"""Synthetic HiFi-like data simulator (first-party; used by tests, the benchmark,
and examples/run_demo.py).

Simulates what `ccs --hifi-kinetics` + alignment produce: reads carrying fi/ri/fp/rp
(uint8 CodecV1-coded kinetics), fn/rn (pass counts), sn (4 floats) tags, optionally
aligned to a random reference contig.
"""

from __future__ import annotations

import numpy as np

from ..bamio import BamHeader, BamRecord, BamWriter
from .codecs import complement_seq

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_seq(rng: np.random.RandomState, n: int, cg_boost: float = 0.08) -> str:
    """Random DNA with extra CG dinucleotides so CpG sites are plentiful."""
    arr = BASES[rng.randint(0, 4, size=n)].copy()
    n_cg = int(n * cg_boost / 2)
    pos = rng.choice(np.arange(0, n - 1, 2), size=min(n_cg, n // 2 - 1), replace=False)
    arr[pos] = ord("C")
    arr[pos + 1] = ord("G")
    return arr.tobytes().decode("ascii")


def make_read(rng: np.random.RandomState, seq: str, qname: str, flag: int = 4,
              ref_id: int = -1, pos: int = -1, mapq: int = 60,
              cigar=None) -> BamRecord:
    n = len(seq)
    rec = BamRecord(
        qname=qname, flag=flag, ref_id=ref_id, pos=pos, mapq=mapq,
        cigar=cigar if cigar is not None else ([(0, n)] if ref_id >= 0 else []),
        seq=seq, qual=np.full(n, 40, dtype=np.uint8),
    )
    rec.tags = [
        ("fi", "BC", rng.randint(0, 256, size=n).astype(np.uint8)),
        ("ri", "BC", rng.randint(0, 256, size=n).astype(np.uint8)),
        ("fp", "BC", rng.randint(0, 256, size=n).astype(np.uint8)),
        ("rp", "BC", rng.randint(0, 256, size=n).astype(np.uint8)),
        ("fn", "i", int(rng.randint(3, 25))),
        ("rn", "i", int(rng.randint(3, 25))),
        ("sn", "Bf", rng.uniform(2, 12, size=4).astype(np.float32)),
        ("np", "i", int(rng.randint(3, 25))),
        ("rq", "f", 0.999),
    ]
    return rec


def make_synth_bam(path: str, n_reads: int = 20, read_len: int = 400, seed: int = 7,
                   aligned: bool = True, ref_len: int = 5000,
                   ref_name: str = "chrS") -> tuple[str, str]:
    """Write a synthetic (aligned, sorted) hifi BAM; returns (fasta_str, sam_header_text).

    Aligned reads are exact substrings of the reference (cigar all-M), half reverse
    strand (the stored seq is then the reverse complement of the forward read seq,
    and kinetics tags follow the HiFi convention: fi/fp along the forward read,
    ri/rp along its reverse complement).
    """
    rng = np.random.RandomState(seed)
    refseq = random_seq(rng, ref_len)
    header = BamHeader(
        "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{}\tLN:{}\n".format(ref_name, ref_len),
        [(ref_name, ref_len)],
    )
    starts = np.sort(rng.randint(0, ref_len - read_len, size=n_reads))
    with BamWriter(path, header) as w:
        for i, s in enumerate(starts):
            sub = refseq[s : s + read_len]
            is_rev = bool(i % 2) and aligned
            if aligned:
                stored = complement_seq(sub) if is_rev else sub
                flag = 16 if is_rev else 0
                rec = make_read(rng, stored, "m0/{}/ccs".format(i), flag=flag,
                                ref_id=0, pos=int(s))
            else:
                rec = make_read(rng, sub, "m0/{}/ccs".format(i))
            w.write(rec)
    return refseq, header.text


def cpg_sites(refseq: str) -> np.ndarray:
    """Forward-strand C positions of every CpG dinucleotide in ``refseq``."""
    arr = np.frombuffer(refseq.encode("ascii"), dtype=np.uint8)
    return np.nonzero((arr[:-1] == ord("C")) & (arr[1:] == ord("G")))[0]


def plant_truth(refseq: str, rng: np.random.RandomState,
                levels=(0.0, 0.25, 0.5, 0.75, 1.0)) -> dict[int, float]:
    """Assign each reference CpG a ground-truth methylation fraction drawn
    uniformly from ``levels`` — the planted profile an end-to-end accuracy
    test recovers (stands in for the reference demo's BS-seq truth bed,
    demo/hg002_bsseq_chr20_demo.bed, absent from the repo
    snapshot)."""
    sites = cpg_sites(refseq)
    return {int(p): float(levels[rng.randint(len(levels))]) for p in sites}


def write_truth_bed(path: str, truth: dict[int, float], ref_name: str = "chrS",
                    coverage: int = 50) -> None:
    """Planted profile as a bedMethyl file (the format BS-seq truth arrives in;
    scripts/correlation_with_bs.py read_methylbed consumes cols 10/11 as
    coverage / percent-methylated)."""
    with open(path, "w") as f:
        for pos in sorted(truth):
            f.write("{c}\t{p}\t{e}\t.\t{cov}\t+\t{p}\t{e}\t0,0,0\t{cov}\t{r}\n"
                    .format(c=ref_name, p=pos, e=pos + 1, cov=coverage,
                            r=int(round(truth[pos] * 100))))


def make_methylated_bam(path: str, refseq: str, truth: dict[int, float],
                        n_reads: int = 60, read_len: int = 300, seed: int = 0,
                        ref_name: str = "chrS",
                        base_code_mu: float = 30.0, base_code_sd: float = 6.0,
                        meth_code_mu: float = 88.0, meth_code_sd: float = 5.0,
                        ) -> dict[tuple[str, int], int]:
    """Aligned synthetic HiFi BAM whose IPD kinetics carry a planted
    5mCpG signal: at every CpG of a read, methylation status is drawn per
    molecule from ``truth[site]`` and, when methylated, the C position's IPD
    code is elevated on BOTH strands (fi along the forward read at the C,
    ri along the reverse complement at the complementary C) — the kinetic
    slowdown `ccs --hifi-kinetics` encodes and the models learn from
    (reference semantics: extract_features.py fi/ri windows around the
    motif hit and its reverse-complement position).

    Reads are exact reference substrings, half reverse-aligned (flag 16,
    stored seq = revcomp of the molecule's forward sequence), so every CpG in
    a read maps exactly to one reference CpG in ``truth``.

    Returns the per-molecule draws as {(qname, forward-strand site): 0|1} —
    the read-level ground truth (join key for an extract TSV row:
    site = pos for '+' rows, pos - 1 for '-' rows).
    """
    rng = np.random.RandomState(seed)
    header = BamHeader(
        "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{}\tLN:{}\n".format(
            ref_name, len(refseq)),
        [(ref_name, len(refseq))],
    )
    ref_len = len(refseq)
    starts = np.sort(rng.randint(0, ref_len - read_len, size=n_reads))

    def kin(n):
        return np.clip(rng.normal(base_code_mu, base_code_sd, size=n),
                       1, 63).astype(np.uint8)

    calls: dict[tuple[str, int], int] = {}
    with BamWriter(path, header) as w:
        for i, s in enumerate(starts):
            s = int(s)
            sub = refseq[s:s + read_len]
            is_rev = bool(i % 2)
            qname = "m{}/{}/ccs".format(seed, i)
            # the molecule's forward-orientation sequence (what fi/fp run
            # along; = revcomp of the stored seq for reverse alignments)
            fwd = complement_seq(sub) if is_rev else sub
            L = len(fwd)
            fi, ri = kin(L), kin(L)
            fp_, rp_ = kin(L), kin(L)
            fb = np.frombuffer(fwd.encode("ascii"), dtype=np.uint8)
            cg_j = np.nonzero((fb[:-1] == ord("C")) & (fb[1:] == ord("G")))[0]
            for j in cg_j:
                j = int(j)
                # reference forward-strand C position of this CpG
                site = s + (L - 2 - j) if is_rev else s + j
                frac = truth.get(site)
                if frac is None:
                    continue
                meth = int(rng.rand() < frac)
                calls[(qname, site)] = meth
                if not meth:
                    continue
                code = np.clip(rng.normal(meth_code_mu, meth_code_sd),
                               64, 120)
                fi[j] = np.uint8(code)  # forward-strand C
                ri[L - 2 - j] = np.uint8(code)  # complementary C (rc coords)
            stored = complement_seq(fwd) if is_rev else sub
            rec = BamRecord(
                qname=qname,
                flag=16 if is_rev else 0, ref_id=0, pos=s, mapq=60,
                cigar=[(0, L)], seq=stored,
                qual=np.full(L, 40, dtype=np.uint8),
            )
            rec.tags = [
                ("fi", "BC", fi), ("ri", "BC", ri),
                ("fp", "BC", fp_), ("rp", "BC", rp_),
                ("fn", "i", int(rng.randint(8, 20))),
                ("rn", "i", int(rng.randint(8, 20))),
                ("sn", "Bf", rng.uniform(2, 12, size=4).astype(np.float32)),
                ("np", "i", int(rng.randint(8, 20))),
                ("rq", "f", 0.999),
            ]
            w.write(rec)
    return calls


def write_fasta(path: str, contigs: dict[str, str], width: int = 60) -> None:
    with open(path, "w") as f:
        for name, seq in contigs.items():
            f.write(">{}\n".format(name))
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")

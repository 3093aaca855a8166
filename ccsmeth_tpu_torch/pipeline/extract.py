"""extract subcommand: BAM/SAM -> features TSV (.gz).

Orchestration parity with ccsmeth/extract_features.py:538-608, built
on the vectorized extractor: a reader thread feeds hole batches, the main loop
extracts + stringifies, a writer thread streams (gz) TSV.
"""

from __future__ import annotations

import os
import queue
import threading
import time

from ..bamio import BamReader
from ..features import ExtractConfig, extract_read_features, features_to_tsv_rows
from ..utils.codecs import get_motif_seqs
from ..utils.fasta import DNAReference
from ..utils.logging import mylogger
from ..utils.process import str2bool

LOGGER = mylogger(__name__)


def _get_holes(path: str) -> set:
    holes = set()
    with open(path) as rf:
        for line in rf:
            holes.add(line.strip().split("\t")[0])
    LOGGER.info("get %d holeids from %s", len(holes), path)
    return holes


def extract_hifireads_features(args) -> str:
    LOGGER.info("[main]extract_features_hifi starts")
    start = time.time()
    inputfile = args.input
    if not (inputfile.endswith(".bam") or inputfile.endswith(".sam")):
        raise ValueError("--input/-i must be in bam/sam format!")
    inputpath = os.path.abspath(inputfile)
    if not os.path.exists(inputpath):
        raise IOError("input file does not exist!")
    if args.output is None:
        fname, _ = os.path.splitext(inputpath)
        outputpath = fname + ".features.tsv"
    else:
        outputpath = os.path.abspath(args.output)
    if args.seq_len % 2 == 0:
        raise ValueError("--seq_len must be odd")

    cfg = ExtractConfig(
        mode=args.mode, seq_len=args.seq_len, motifs=args.motifs,
        mod_loc=args.mod_loc, methy_label=args.methy_label, norm=args.norm,
        no_decode=args.no_decode, is_sn=str2bool(args.is_sn),
        is_map=str2bool(args.is_map), mapq=args.mapq, identity=args.identity,
        no_supplementary=args.no_supplementary,
        skip_unmapped=str2bool(args.skip_unmapped), holes_batch=args.holes_batch)

    dnacontigs = None
    if args.mode == "align":
        if args.ref is None:
            raise ValueError("--ref must be provided when using align mode!")
        if not os.path.exists(os.path.abspath(args.ref)):
            raise IOError("reference(--ref) file does not exist!")
        dnacontigs = DNAReference(os.path.abspath(args.ref)).getcontigs()

    holeids_e = _get_holes(args.holeids_e) if args.holeids_e else None
    holeids_ne = _get_holes(args.holeids_ne) if args.holeids_ne else None
    motifs = get_motif_seqs(args.motifs)

    reader = BamReader(inputpath)
    refnames = [r[0] for r in reader.header.references]

    write_q: "queue.Queue" = queue.Queue(maxsize=32)
    err: list[BaseException] = []

    if args.gzip:
        if not outputpath.endswith(".gz"):
            outputpath += ".gz"
        from ..bamio import create_text_gz

        wf = create_text_gz(outputpath)
    else:
        wf = open(outputpath, "w")

    def write():
        try:
            while True:
                rows = write_q.get()
                if rows is None:
                    break
                wf.write("\n".join(rows) + "\n")
        except BaseException as e:  # noqa: BLE001
            err.append(e)

    t_w = threading.Thread(target=write, daemon=True)
    t_w.start()

    total_num = failed_num = 0
    for rec in reader:
        total_num += 1
        refname = refnames[rec.ref_id] if rec.ref_id >= 0 else None
        try:
            rf = extract_read_features(rec, motifs, cfg, dnacontigs, holeids_e,
                                       holeids_ne, refname)
        except Exception as e:  # noqa: BLE001
            LOGGER.warning("%s: %s in read:%s", type(e).__name__, e, rec.qname)
            rf = None
        if rf is None:
            failed_num += 1
            continue
        rows = features_to_tsv_rows(rf, cfg.is_sn, cfg.is_map)
        if rows:
            # bounded put that cannot deadlock on a dead writer
            while not err:
                try:
                    write_q.put(rows, timeout=0.5)
                    break
                except queue.Full:
                    continue
        if err:
            break
    while True:
        try:
            write_q.put(None, timeout=0.5)
            break
        except queue.Full:
            if err:
                try:
                    write_q.get_nowait()
                except queue.Empty:
                    pass
    t_w.join()
    wf.close()
    reader.close()
    if err:
        raise err[0]
    LOGGER.info("%d holes/reads in total, %d skipped/failed", total_num, failed_num)
    LOGGER.info("[main]extract_features_hifi costs %.1f seconds", time.time() - start)
    return outputpath

"""call_freqb: aligned modbam -> per-site methylation frequencies (bedMethyl / freq.txt).

Counterpart of ``ccsmeth_tpu/pipeline/call_freq_bam.py``: the host code is
its copy, changed only where the device work is. Its docstring follows.

Semantics parity with ccsmeth/call_mods_freq_bam.py, redesigned
around ONE linear scan of the (sorted) BAM instead of per-region random fetches:
each aligned (q_pos, r_pos) contribution is routed to its genome chunk by binary
search over the chunk boundaries (with the reference's CG-straddle boundary
adjustment, lines 51-84), so the per-region results — including the aggregate
model's 11-site window context — are identical to the reference's fetch-per-region
design while reading the BAM once. Genome chunks are the sharding unit for
multi-host scale-out (per-site accumulators merge by concatenation — disjoint
region ownership makes the merge order-independent).

Aggregate mode runs the AggrAttRNN regressor in padded batches of 1024 rows on
one device, its BiRNN through kernel K1 on the card (the reference reloads the
torch model per region and runs CPU minibatches of 1024, lines 308-342).

With --dist_coordinator the ranks form a torch.distributed group
(``parallel/distributed.py``; the host's ``gloo`` in count mode, which
runs on the host, and the rule's backend on the ranks' cards in aggregate
mode), split the reads by qname hash and all-reduce each active chunk's
per-site tables (``_dist_emit_chunks``); rank 0 alone runs the model and
writes.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..bamio import BamReader
from ..models import (AggrAttRNN, AggrConfig, aggr_state_dict_from_params,
                      torch_ckpt_to_params)
from ..models.params_io import load_params
from ..parallel import distributed
from ..utils.codecs import (
    aligned_pairs_from_cigar,
    complement_seq,
    compute_pct_identity,
    get_refloc_of_methysite_in_motif,
    get_motif_seqs,
    ml_to_prob,
    moddict_from_mm_ml,
    parse_mm_tag,
    seq_to_bytes,
)
from ..utils.fasta import DNAReference
from ..utils.logging import mylogger
from ..utils.process import is_file_empty
from .call_mods import resolve_device

LOGGER = mylogger(__name__)

# counts of the last call_mods_frequency_from_bamfile run (sites written,
# rows through the aggregate model, its batches, seconds), for callers that
# drive it through the CLI
LAST_RUN: dict = {}


@dataclasses.dataclass
class FreqBamConfig:
    input_bam: str = ""
    ref: str = ""
    output: str = ""
    contigs: str | None = None
    chunk_len: int = 500000
    modtype: str = "5mC"
    call_mode: str = "count"
    prob_cf: float = 0.0
    no_amb_cov: bool = False
    hap_tag: str = "HP"
    mapq: int = 1
    identity: float = 0.0
    no_supplementary: bool = False
    motifs: str = "CG"
    mod_loc: int = 0
    no_comb: bool = False
    refsites_only: bool = False
    refsites_all: bool = False
    no_hap: bool = False
    base_clip: int = 0
    # aggregate mode
    aggre_model: str | None = None
    model_type: str = "attbigru"
    seq_len: int = 11
    class_num: int = 1
    layer_rnn: int = 1
    hid_rnn: int = 32
    bin_size: int = 20
    cov_cf: int = 4
    only_close: bool = False
    discrete: bool = False
    tseed: int = 1234
    # output
    bed: bool = False
    sort: bool = False
    gzip: bool = False
    threads: int = 5
    # multi-process scale-out. Without --dist_coordinator: share-nothing — each
    # process owns a disjoint round-robin slice of the genome chunk list
    # (parallel/distributed.py) and writes its own output prefix; concatenate
    # shards afterwards (scripts/combine_call_mods_freq_files.py). With
    # --dist_coordinator: collective — processes form one torch.distributed
    # group, split the READ stream by stable qname hash, all-reduce per-chunk
    # per-site count/histogram tensors, and rank 0 writes the single merged
    # output (replaces the reference's share-nothing freq workers,
    # call_mods_freq_bam.py:597-677)
    num_processes: int = 1
    process_id: int = 0
    dist_coordinator: str | None = None
    # where the aggregate model runs: cuda (kernel K1) or cpu (its plain
    # version); cuda without a GPU raises
    device: str = "cuda"


# ---------------------------------------------------------------------------------------
# genome chunking (call_mods_freq_bam.py:51-99)
# ---------------------------------------------------------------------------------------


def get_reference_chunks(dnacontigs: dict[str, str], contig_str: str | None,
                         chunk_len: int = 300000, motifs: str = "CG"
                         ) -> list[tuple[str, int, int]]:
    if contig_str is not None:
        if os.path.isfile(contig_str):
            with open(contig_str) as rf:
                contigs = sorted(set(rf.read().splitlines()))
        else:
            contigs = sorted(set(contig_str.strip().split(",")))
    else:
        contigs = sorted(dnacontigs.keys())
    ref_chunks = []
    for contig in contigs:
        contig_len = len(dnacontigs[contig])
        for i in range(0, contig_len, chunk_len):
            ref_chunks.append((contig, i, min(i + chunk_len, contig_len)))
    if motifs == "CG":
        # move a boundary-straddling CG wholly into the left chunk (lines 69-84)
        for idx in range(1, len(ref_chunks)):
            pre_ref, pre_s, pre_e = ref_chunks[idx - 1]
            cur_ref, cur_s, cur_e = ref_chunks[idx]
            if pre_ref != cur_ref:
                continue
            assert cur_s == pre_e
            if dnacontigs[pre_ref][(pre_e - 1):(pre_e + 1)] == "CG":
                ref_chunks[idx - 1] = (pre_ref, pre_s, pre_e + 1)
                ref_chunks[idx] = (cur_ref, cur_s + 1, cur_e)
    return ref_chunks


# ---------------------------------------------------------------------------------------
# frequency math (count + aggregate; call_mods_freq_bam.py:200-454)
# ---------------------------------------------------------------------------------------


def cal_modfreq_from_counts(raw, flt, mod, no_amb_cov=False):
    """Count-mode (cov, met, freq) from the three ADDITIVE per-site counts
    (raw calls, calls passing prob_cf, modified calls among those) —
    call_mods_freq_bam.py:200-217 semantics reformulated over counts so partial
    tables from different hosts merge by summation (psum)."""
    modfreq = mod / float(flt) if flt > 0 else 0.0
    if no_amb_cov:
        return flt, mod, modfreq
    met = mod
    if flt != raw:
        met = np.round(raw * modfreq, 2)
    return raw, met, modfreq


def cal_modfreq_count_mode(modprobs, prob_cf=0.0, no_amb_cov=False):
    cnt_all_filtered, cnt_mod = 0, 0
    for p in modprobs:
        if abs(p - (1 - p)) < prob_cf:
            continue
        cnt_all_filtered += 1
        if p > 0.5:
            cnt_mod += 1
    return cal_modfreq_from_counts(len(modprobs), cnt_all_filtered, cnt_mod,
                                   no_amb_cov)


def get_normalized_histo(probs, cov_cf=4, binsize=20) -> np.ndarray:
    cov = len(probs)
    assert cov >= cov_cf
    hist = np.histogram(probs, bins=binsize, range=[0, 1])[0]
    norm = np.linalg.norm(hist)
    return np.round(hist / norm, 6)


def discretize_score(modprob, coverage):
    if modprob > 0.66:
        mod_reads = int(np.ceil(modprob * float(coverage)))
    elif modprob <= 0.33:
        mod_reads = int(np.floor(modprob * float(coverage)))
    else:
        mod_reads = round(coverage * modprob, 2)
    unmod_reads = int(coverage) - mod_reads
    adjusted = float(mod_reads) / (mod_reads + unmod_reads) if mod_reads != 0 else 0.0
    return mod_reads, unmod_reads, adjusted


class AggrPredictor:
    """The aggregate model in padded batches of ``PAD`` rows on one device
    (the JAX package's jitted step, ``ccsmeth_tpu/pipeline/call_freq_bam.py:
    187-269``): a batch is one (PAD, L + L*binsize) float32 copy to the
    device, the model (its BiRNN through kernel K1 on the card), and the
    (PAD, 1) output back; padded rows are computed and dropped. Up to
    ``IN_FLIGHT`` batches are queued on the device's one stream before the
    oldest is collected, so the host packs the next batch while the card
    computes. ``rows`` and ``batches`` count what went through the model."""

    PAD = 1024
    IN_FLIGHT = 3

    def __init__(self, cfg: FreqBamConfig):
        acfg = AggrConfig(seq_len=cfg.seq_len, num_layers=cfg.layer_rnn,
                          num_classes=cfg.class_num, dropout_rate=0.0,
                          hidden_size=cfg.hid_rnn, binsize=cfg.bin_size,
                          model_type=cfg.model_type)
        if cfg.aggre_model is None or not os.path.exists(cfg.aggre_model):
            raise ValueError("--aggre_model is not set right!")
        if cfg.aggre_model.endswith(".npz"):
            params = load_params(cfg.aggre_model)
        else:
            params = torch_ckpt_to_params(cfg.aggre_model, acfg)
        self.device = resolve_device(cfg.device)
        model = AggrAttRNN(acfg)
        model.load_state_dict(aggr_state_dict_from_params(params))
        self.model = model.eval().to(self.device)
        self.L, self.NB = cfg.seq_len, cfg.bin_size
        self.rows = 0
        self.batches = 0

    def _dispatch(self, flat: torch.Tensor) -> tuple:
        """Queue one padded batch; returns (host result, event or None)."""
        L = self.L
        with torch.inference_mode():
            dev = flat.to(self.device, non_blocking=True)
            res = self.model(dev[:, :L], dev[:, L:].reshape(-1, L, self.NB))
            if self.device.type != "cuda":
                return res, None
            host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
            host.copy_(res, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return host, event

    def raw(self, offsets: np.ndarray, histos: np.ndarray) -> np.ndarray:
        """offsets (N, L), histos (N, L, binsize) -> the model's raw first
        output (N,) float32."""
        from collections import deque

        N = len(offsets)
        L = self.L
        out = np.empty(N, dtype=np.float32)
        pinned = self.device.type == "cuda"
        futs: deque = deque()

        def drain_one():
            s, e, n, _flat, (res, event) = futs.popleft()
            if event is not None:
                event.synchronize()
            out[s:e] = res.numpy()[:n, 0]

        for s in range(0, N, self.PAD):
            e = min(s + self.PAD, N)
            n = e - s
            flat = torch.zeros((self.PAD, L + L * self.NB), dtype=torch.float32,
                               pin_memory=pinned)
            buf = flat.numpy()
            buf[:n, :L] = offsets[s:e]
            buf[:n, L:] = histos[s:e].reshape(n, -1)
            # the pinned input stays referenced until its batch is collected
            futs.append((s, e, n, flat, self._dispatch(flat)))
            self.rows += self.PAD
            self.batches += 1
            while len(futs) > self.IN_FLIGHT:
                drain_one()
        while futs:
            drain_one()
        return out

    def predict(self, offsets: np.ndarray, histos: np.ndarray) -> np.ndarray:
        """offsets (N, L), histos (N, L, binsize) -> probs (N,) rounded/clipped like
        the reference (call_mods_freq_bam.py:302)."""
        # float32 end-to-end: the reference keeps torch's float32 logits through
        # round/clip and the freq.txt strings inherit float32 repr (lines 302,402)
        return np.round(np.clip(self.raw(offsets, histos), 0, 1), 6)


def _aggregate_window_inputs(refposes: list[int], histos: list[np.ndarray],
                             seq_len: int, only_close: bool):
    """Build the 11-site sliding windows (call_mods_freq_bam.py:265-305)."""
    from numpy.lib.stride_tricks import sliding_window_view

    pad_len = seq_len // 2
    histos_mat = np.pad(np.stack(histos), pad_width=((pad_len, pad_len), (0, 0)),
                        mode="constant", constant_values=0)
    histos_mat = np.swapaxes(sliding_window_view(histos_mat, seq_len, axis=0), 1, 2)
    refposes = np.asarray(refposes)
    if not only_close:
        pos_mat = np.pad(refposes, pad_width=(pad_len, pad_len), mode="constant",
                         constant_values=(refposes[0] - 1000, refposes[-1] + 1000))
        pos_mat = sliding_window_view(pos_mat, seq_len)
        center = np.repeat(refposes, seq_len).reshape((-1, seq_len))
        pos_mat = np.absolute(np.subtract(pos_mat, center))
    else:
        pos_mat = np.pad(refposes, pad_width=(pad_len + 1, pad_len), mode="constant",
                         constant_values=(refposes[0] - 1000, refposes[-1] + 1000))
        pos_mat = np.diff(pos_mat)
        pos_mat = (pos_mat == 2).astype(int)
        pos_mat = sliding_window_view(pos_mat, seq_len)
    return pos_mat, histos_mat


def site_stats_from_modinfo(refpos2modinfo: dict, cfg: FreqBamConfig,
                            want_hist: bool) -> dict:
    """{refpos: (counts (3,3) int64, hist (3,binsize) int64 | None)} — the
    ADDITIVE per-site per-group [all, hp1, hp2] statistics from which both
    count-mode and aggregate-mode rows are computed: counts = [raw calls,
    prob_cf-passing calls, modified calls], hist = raw prob histograms
    (call_mods_freq_bam.py:200-237). Additivity is what lets multi-host
    partial tables merge with one psum (parallel/distributed.py)."""
    out = {}
    for pos, vals in refpos2modinfo.items():
        counts = np.zeros((3, 3), np.int64)
        probs: dict[int, list] = {0: [], 1: [], 2: []}
        for p, hap in vals:
            groups = (0, hap) if (not cfg.no_hap and hap in (1, 2)) else (0,)
            for g in groups:
                counts[g, 0] += 1
                if abs(p - (1 - p)) >= cfg.prob_cf:
                    counts[g, 1] += 1
                    if p > 0.5:
                        counts[g, 2] += 1
                if want_hist:
                    probs[g].append(p)
        hist = None
        if want_hist:
            hist = np.zeros((3, cfg.bin_size), np.int64)
            for g in range(3):
                if probs[g]:
                    hist[g] = np.histogram(probs[g], bins=cfg.bin_size,
                                           range=[0, 1])[0]
        out[pos] = (counts, hist)
    return out


def call_modfreq_from_stats(site_stats: dict, cfg: FreqBamConfig,
                            aggr: "AggrPredictor | None"):
    """-> [(refpos, info_all, info_hp1, info_hp2)] with info=(cov, met, freq);
    parity with call_mods_freq_bam.py:308-454, computed from the additive
    per-site stats of `site_stats_from_modinfo` (local or psum-merged)."""
    all_refposes = sorted(site_stats.keys())
    if cfg.call_mode == "count":
        out = []
        for refpos in all_refposes:
            counts, _hist = site_stats[refpos]
            infos = []
            for g in range(3):
                raw = int(counts[g, 0])
                infos.append(cal_modfreq_from_counts(
                    raw, int(counts[g, 1]), int(counts[g, 2]), cfg.no_amb_cov)
                    if raw else None)
            out.append((refpos, infos[0], infos[1], infos[2]))
        return out
    if cfg.call_mode != "aggregate":
        raise ValueError("wrong --call_mode")

    result = {rp: [None, None, None] for rp in all_refposes}
    for g in range(3):
        hp_pos, hp_hist, hp_cov = [], [], []
        for refpos in all_refposes:
            counts, hist = site_stats[refpos]
            raw = int(counts[g, 0])
            if raw == 0:
                continue
            if raw >= cfg.cov_cf:
                # normalized histogram from the (merged) raw histogram — equals
                # get_normalized_histo on the full prob list (lines 221-237)
                h = hist[g]
                hp_pos.append(refpos)
                hp_hist.append(np.round(h / np.linalg.norm(h), 6))
                hp_cov.append(raw)
            else:
                result[refpos][g] = cal_modfreq_from_counts(
                    raw, int(counts[g, 1]), int(counts[g, 2]), cfg.no_amb_cov)
        if hp_pos:
            pos_mat, histos_mat = _aggregate_window_inputs(
                hp_pos, hp_hist, cfg.seq_len, cfg.only_close)
            probs = aggr.predict(pos_mat.astype(np.float32),
                                 histos_mat.astype(np.float32))
            for k, pos in enumerate(hp_pos):
                cov = hp_cov[k]
                mp = probs[k]
                if cfg.discrete:
                    d_cnt, _, d_mp = discretize_score(mp, cov)
                    result[pos][g] = (cov, d_cnt, d_mp)
                else:
                    result[pos][g] = (cov, round(cov * mp, 2), mp)
    return [(rp, result[rp][0], result[rp][1], result[rp][2]) for rp in all_refposes]


def call_modfreq_of_one_region(refpos2modinfo: dict, cfg: FreqBamConfig,
                               aggr: "AggrPredictor | None"):
    """Single-host region path: per-site stats then shared row math."""
    stats = site_stats_from_modinfo(refpos2modinfo, cfg,
                                    want_hist=cfg.call_mode == "aggregate")
    return call_modfreq_from_stats(stats, cfg, aggr)


# ---------------------------------------------------------------------------------------
# the linear-scan accumulator
# ---------------------------------------------------------------------------------------


def _moddict_arrays(rec, modbase="C", modification="m"):
    """(positions, probs) arrays of a record's mod calls in alignment-strand coords.
    Parity with _get_moddict (call_mods_freq_bam.py:126-197)."""
    mm = ml = None
    try:
        mm = rec.get_tag("MM")
        ml = rec.get_tag("ML")
    except KeyError:
        return np.empty(0, np.int64), np.empty(0, np.float64)
    deltas = parse_mm_tag(mm, modbase, modification)
    if deltas is None:
        return np.empty(0, np.int64), np.empty(0, np.float64)
    fwd = rec.get_forward_sequence()
    try:
        d = moddict_from_mm_ml(deltas, np.asarray(ml), seq_to_bytes(fwd),
                               rec.is_reverse, modbase)
    except (IndexError, AssertionError) as e:
        LOGGER.warning("read %s: %s", rec.qname, e)
        return np.empty(0, np.int64), np.empty(0, np.float64)
    if not d:
        return np.empty(0, np.int64), np.empty(0, np.float64)
    pos = np.fromiter(d.keys(), np.int64, len(d))
    probs = np.fromiter(d.values(), np.float64, len(d))
    order = np.argsort(pos)
    return pos[order], probs[order]


class _ContigAcc:
    """Per-contig accumulation of (refpos -> [(prob, hap)]) for fwd and rev strands."""

    __slots__ = ("fwd", "rev")

    def __init__(self):
        self.fwd: dict[int, list] = {}
        self.rev: dict[int, list] = {}


def scan_bam_accumulate(cfg: FreqBamConfig, dnacontigs: dict[str, str],
                        motifs_filter,
                        owned_regions: dict[str, list] | None = None,
                        read_shard: tuple[int, int] | None = None,
                        flush_cb=None,
                        accs: dict[str, "_ContigAcc"] | None = None,
                        scoped_regions: dict[str, list] | None = None
                        ) -> dict[str, _ContigAcc]:
    """One pass over the BAM: filters + MM/ML decode + aligned-pairs walk
    (parity with _readmods_to_bed_of_one_region's per-read block, lines 488-540).

    owned_regions: optional {contig: [(start, end), ...]} — reads whose aligned
    span overlaps no owned interval are skipped (multi-process partitioning;
    site emission is additionally gated by the owned chunk loop, so a straddling
    read contributing a few out-of-range sites costs memory, never correctness).

    read_shard: optional (process_id, num_processes) — keep only reads this
    process owns by stable qname hash (collective --dist_coordinator mode:
    every process sees every site partially; the psum merge reconstitutes the
    global per-site table).

    flush_cb: optional streaming hook for COORDINATE-SORTED inputs —
    ``flush_cb(contig, frontier_pos)`` fires as the scan advances (and
    ``flush_cb(contig, None)`` when a contig finishes). Later records start at
    or after the frontier, so every site below it is final: the callback may
    convert completed genome chunks to rows and POP them from ``accs``,
    bounding read-level memory to the active window instead of the whole
    genome (the reference bounds memory by BAI-fetching 500kb regions instead,
    call_mods_freq_bam.py:597-614). Sort order is verified while scanning;
    a violation raises (flushed chunks could otherwise silently lose calls).

    scoped_regions: optional {contig: [(start, end), ...]} — read the BAM
    through the .bai index, decoding ONLY records overlapping the scope
    (the reference's fetch-per-region access pattern,
    call_mods_freq_bam.py:600-614) instead of linearly scanning the whole
    file. Used for --contigs subsets and share-nothing chunk ownership, where
    a full scan costs O(whole BAM) per process. Mutually exclusive with
    flush_cb (records from overlapping spans arrive slightly out of global
    coordinate order; scope already bounds memory).
    """
    if scoped_regions is not None and flush_cb is not None:
        raise ValueError("scoped_regions and flush_cb are mutually exclusive")
    if read_shard is not None:
        from ..parallel.distributed import owns_read
    modbase = "C" if cfg.modtype == "5mC" else "-"
    modification = "m"
    if accs is None:
        accs = {}
    refsites: dict[str, tuple[set, set]] = {}
    reader = BamReader(cfg.input_bam)
    refnames = [r[0] for r in reader.header.references]
    if cfg.refsites_all:
        for contig in dnacontigs:
            fwd_sites = set(get_refloc_of_methysite_in_motif(
                dnacontigs[contig], motifs_filter, cfg.mod_loc))
            rev_scan = get_refloc_of_methysite_in_motif(
                complement_seq(dnacontigs[contig]), motifs_filter, cfg.mod_loc)
            clen = len(dnacontigs[contig])
            rev_sites = set(clen - 1 - x for x in rev_scan)
            refsites[contig] = (fwd_sites, rev_sites)

    cnt_all = cnt_used = 0
    cur_rid = -1
    last_pos = -1
    records = reader
    if scoped_regions is not None:
        from ..bamio.bai import fetch_scoped

        reader.close()
        records = fetch_scoped(cfg.input_bam, scoped_regions)
    for rec in records:
        if rec.ref_id < 0:
            continue
        contig = refnames[rec.ref_id]
        if flush_cb is not None:
            if rec.ref_id != cur_rid:
                if rec.ref_id < cur_rid:
                    raise ValueError(
                        "input BAM is not coordinate-sorted (contig {} after "
                        "{}) though its header claims SO:coordinate".format(
                            contig, refnames[cur_rid]))
                if cur_rid >= 0:
                    flush_cb(refnames[cur_rid], None)
                cur_rid = rec.ref_id
                last_pos = -1
            elif rec.pos < last_pos:
                raise ValueError(
                    "input BAM is not coordinate-sorted ({}:{} after {}) "
                    "though its header claims SO:coordinate".format(
                        contig, rec.pos, last_pos))
            last_pos = rec.pos
            flush_cb(contig, rec.pos)
        if contig not in dnacontigs:
            continue
        cnt_all += 1
        if rec.is_unmapped or rec.is_secondary or rec.is_duplicate:
            continue
        if cfg.no_supplementary and rec.is_supplementary:
            continue
        if rec.mapq < cfg.mapq:
            continue
        # ownership check BEFORE the cigar-stats walk: in sharded/dist mode
        # every rank scans the full BAM, so (P-1)/P of reads drop here and
        # must not pay the per-read identity computation first
        if read_shard is not None and not owns_read(rec.qname, read_shard[0],
                                                    read_shard[1]):
            continue
        if compute_pct_identity(rec.get_cigar_stats()) < cfg.identity:
            continue
        if owned_regions is not None:
            spans = owned_regions.get(contig)
            if not spans:
                continue
            r_end = rec.reference_end if rec.cigar else rec.pos + 1
            if not any(s < r_end and rec.pos < e for s, e in spans):
                continue
        try:
            hap = int(rec.get_tag(cfg.hap_tag))
        except (KeyError, ValueError, TypeError):
            hap = 0
        modpos, modprobs = _moddict_arrays(rec, modbase, modification)
        matches_only = not cfg.refsites_all
        pairs = aligned_pairs_from_cigar(rec.cigar, rec.pos, matches_only)
        if cfg.base_clip > 0:
            pairs = pairs[cfg.base_clip : -cfg.base_clip]
        if len(pairs) == 0:
            cnt_used += 1
            continue
        q = pairs[:, 0]
        r = pairs[:, 1]
        acc = accs.setdefault(contig, _ContigAcc())
        target = acc.rev if rec.is_reverse else acc.fwd
        rvalid = r >= 0
        # q positions carrying mod calls
        qi = np.searchsorted(modpos, q)
        has_mod = np.zeros(len(q), dtype=bool)
        inb = (qi < len(modpos)) & (q >= 0)
        has_mod[inb] = modpos[np.clip(qi, 0, max(len(modpos) - 1, 0))][inb] == q[inb]
        sel = rvalid & has_mod
        for rr, p in zip(r[sel], modprobs[qi[sel]]):
            target.setdefault(int(rr), []).append((p, hap))
        if cfg.refsites_all:
            fwd_sites, rev_sites = refsites[contig]
            siteset = rev_sites if rec.is_reverse else fwd_sites
            sel2 = rvalid & ~has_mod
            for rr in r[sel2]:
                if int(rr) in siteset:
                    target.setdefault(int(rr), []).append((0.0, hap))
        cnt_used += 1
    reader.close()
    LOGGER.info("scanned %d records, used %d", cnt_all, cnt_used)
    return accs


# ---------------------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------------------


def _chunk_site_tables(accs: dict, sorted_acc: dict, ref_name: str,
                       ref_start: int, ref_end: int, combine: bool):
    """(fwd_table, rev_table) of {refpos: [(prob, hap)]} for one genome chunk,
    sliced by searchsorted from the per-contig accumulators; CG combining maps a
    rev-strand site r onto fwd site r-1 (call_mods_freq_bam.py:547-556)."""
    acc = accs.get(ref_name)
    if acc is None:
        return {}, {}
    fwd_pos, rev_pos = sorted_acc[ref_name]
    fs, fe = np.searchsorted(fwd_pos, [ref_start, ref_end])
    rs, re_ = np.searchsorted(rev_pos, [ref_start, ref_end])
    refposinfo = {int(p): acc.fwd[int(p)] for p in fwd_pos[fs:fe]}
    refposinfo_rev = {int(p): acc.rev[int(p)] for p in rev_pos[rs:re_]}
    return _combine_cg_tables(refposinfo, refposinfo_rev, combine)


def _combine_cg_tables(refposinfo: dict, refposinfo_rev: dict, combine: bool):
    """CG combining: rev-strand site r merges onto fwd site r-1
    (call_mods_freq_bam.py:547-556). Shared by the full-scan and streaming
    table builders — the streaming path's bit-identity guarantee requires
    both to apply the exact same merge."""
    if combine:
        for rp, vals in refposinfo_rev.items():
            if rp == 0:
                continue
            base = refposinfo.get(rp - 1)
            refposinfo[rp - 1] = ((list(base) + list(vals))
                                  if base is not None else list(vals))
        refposinfo_rev = {}
    return refposinfo, refposinfo_rev


def _pop_chunk_tables(accs: dict, ref_name: str, ref_start: int, ref_end: int,
                      combine: bool):
    """Streaming-mode equivalent of _chunk_site_tables: builds the chunk's
    (fwd, rev) tables AND pops the entries from the live accumulator, freeing
    the flushed window. Iterates only the active-window keys (flushed keys are
    gone), so the total cost over all chunks is O(total sites). Table contents
    and insertion order match _chunk_site_tables exactly (fwd ascending, then
    rev merged ascending)."""
    acc = accs.get(ref_name)
    if acc is None:
        return {}, {}
    fwd_keys = sorted(p for p in acc.fwd if ref_start <= p < ref_end)
    rev_keys = sorted(p for p in acc.rev if ref_start <= p < ref_end)
    refposinfo = {p: acc.fwd.pop(p) for p in fwd_keys}
    refposinfo_rev = {p: acc.rev.pop(p) for p in rev_keys}
    return _combine_cg_tables(refposinfo, refposinfo_rev, combine)


def _dist_emit_chunks(cfg: FreqBamConfig, accs: dict, sorted_acc: dict,
                      ref_chunks: list, combine: bool,
                      aggr: "AggrPredictor | None", emit_rows) -> None:
    """Collective per-chunk frequency merge (--dist_coordinator mode).

    Two all-reduces per active chunk (``psum_site_counts``), both with
    rank-identical shapes:
    1. a flat [max_span*2, 1] (position, strand) PRESENCE vector — its global
       sum gives every rank the same ordered list of occupied sites (CpG sites
       are a few % of positions, so shipping dense per-site STATS would be
       ~25-50x the necessary bytes in aggregate mode);
    2. a site-PACKED [n_sites_padded, 3 hap-groups * K] stats table (K = 3
       counts [+ bin_size histogram bins in aggregate mode]), padded to
       power-of-two buckets of at least 256 rows (O(log) distinct shapes, as
       the JAX package's compiled psum has).
    Rank 0 turns merged tables into bedMethyl rows. One up-front presence
    all-reduce lets all ranks skip empty chunks consistently. Collective-order
    safety: every rank iterates the same chunk list and issues the same
    all-reduce sequence with the same shapes (site lists and pad buckets
    derive from collective results, never from local data).
    """
    psum_site_counts = distributed.psum_site_counts
    is_main = distributed.rank == 0
    want_hist = cfg.call_mode == "aggregate"
    K = 3 + (cfg.bin_size if want_hist else 0)
    # +1: CG-straddle boundary fix can extend a chunk by one base;
    # +1: combining can land a row at ref_start-1 (index 0)
    max_span = cfg.chunk_len + 2

    # presence from the accumulator index spans alone — building the per-chunk
    # site tables here would hold every chunk's table (and, with CG combining,
    # a second copy of the whole accumulator) in memory for the entire emit
    # loop; only one chunk's table is ever needed at a time (built below)
    presence = np.zeros((len(ref_chunks), 1), np.float32)
    for i, (contig, s, e) in enumerate(ref_chunks):
        if contig in sorted_acc:
            fwd_pos, rev_pos = sorted_acc[contig]
            fs, fe = np.searchsorted(fwd_pos, [s, e])
            rs, re_ = np.searchsorted(rev_pos, [s, e])
            presence[i, 0] = (fe - fs) + (re_ - rs)
    active = psum_site_counts(presence)[:, 0] > 0

    for i, (contig, s, e) in enumerate(ref_chunks):
        if not active[i]:
            continue
        tables = _chunk_site_tables(accs, sorted_acc, contig, s, e, combine)
        stats_by_strand = [
            site_stats_from_modinfo(t, cfg, want_hist) if t else {}
            for t in tables
        ]
        # all-reduce 1: global (position, strand) presence -> shared site list
        pres = np.zeros((max_span * 2, 1), np.float32)
        for strand_idx, stats in enumerate(stats_by_strand):
            for pos in stats:
                pres[(pos - s + 1) * 2 + strand_idx, 0] = 1.0
        flat_sites = np.nonzero(psum_site_counts(pres)[:, 0] > 0)[0]
        n_sites = len(flat_sites)
        padded = max(256, 1 << (n_sites - 1).bit_length())
        # all-reduce 2: packed per-site stats at the shared site order
        local = np.zeros((padded, 3 * K), np.float32)
        row_of = {int(f): r for r, f in enumerate(flat_sites)}
        for strand_idx, stats in enumerate(stats_by_strand):
            for pos, (counts, hist) in stats.items():
                row = local[row_of[(pos - s + 1) * 2 + strand_idx]]
                row = row.reshape(3, K)
                row[:, :3] = counts
                if want_hist:
                    row[:, 3:] = hist
        merged = psum_site_counts(local)
        if not is_main:
            continue
        merged = merged[:n_sites].reshape(n_sites, 3, K)
        for strand_idx, strand_char in ((0, "+"), (1, "-")):
            site_stats = {}
            for r in np.nonzero(flat_sites % 2 == strand_idx)[0]:
                m = merged[r]
                counts = np.rint(m[:, :3]).astype(np.int64)
                hist = np.rint(m[:, 3:]).astype(np.int64) if want_hist else None
                pos = int(s - 1 + flat_sites[r] // 2)
                site_stats[pos] = (counts, hist)
            if site_stats:
                emit_rows(call_modfreq_from_stats(site_stats, cfg, aggr),
                          contig, strand_char)


def _write_one_line(beditem, wf, is_bed):
    ref_name, refpos, strand, cov, met, metprob = beditem
    if is_bed:
        wf.write("\t".join([
            ref_name, str(refpos), str(refpos + 1), ".", str(cov), strand,
            str(refpos), str(refpos + 1), "0,0,0", str(cov),
            str(int(round(metprob * 100 + 0.001, 0)))]) + "\n")
    else:
        wf.write("\t".join([
            ref_name, str(refpos), str(refpos + 1), strand, ".", ".", str(met),
            str(cov - met), str(cov), str(round(metprob + 0.000001, 4)), "."]) + "\n")


def call_mods_frequency_from_bamfile(cfg: FreqBamConfig) -> list[str]:
    """Run call_freqb; returns the list of written output paths (none on the
    ranks other than 0 of a --dist_coordinator group, which this process
    joins and leaves)."""
    if cfg.dist_coordinator is not None and cfg.num_processes > 1:
        distributed.init_multihost(
            cfg.dist_coordinator, cfg.num_processes, cfg.process_id,
            cfg.device if cfg.call_mode == "aggregate" else "cpu")
        try:
            return _call_mods_frequency(cfg)
        finally:
            distributed.teardown()
    return _call_mods_frequency(cfg)


def _call_mods_frequency(cfg: FreqBamConfig) -> list[str]:
    t0 = time.time()
    if not cfg.input_bam.endswith(".bam"):
        raise ValueError("--input_bam not a bam file!")
    if not os.path.exists(cfg.input_bam):
        raise ValueError("--input_bam does not exist!")
    if not os.path.exists(cfg.ref):
        raise ValueError("--ref does not exist!")
    dnacontigs = DNAReference(cfg.ref).getcontigs()
    motifs = get_motif_seqs(cfg.motifs)
    motifs_filter = None
    if cfg.refsites_only or cfg.refsites_all:
        motifs_filter = motifs
        LOGGER.info("[###] --refsites_only/--refsites_all: keeping only reference "
                    "%s sites", motifs_filter)

    dist = cfg.dist_coordinator is not None and cfg.num_processes > 1
    if cfg.dist_coordinator is not None and cfg.num_processes <= 1:
        # silently falling back would make N ranks each run a FULL
        # single-process scan onto the same output prefix
        raise ValueError("--dist_coordinator requires --num_processes > 1 "
                         "(got {})".format(cfg.num_processes))
    if cfg.num_processes > 1 and not 0 <= cfg.process_id < cfg.num_processes:
        raise ValueError("--process_id must be in [0, num_processes)")
    is_main = distributed.rank == 0
    aggr = None
    if cfg.call_mode == "aggregate" and (not dist or is_main):
        # dist mode: only rank 0 computes rows, on its own card
        aggr = AggrPredictor(dataclasses.replace(cfg, device=str(distributed.device))
                             if dist else cfg)
    ref_chunks = get_reference_chunks(dnacontigs, cfg.contigs, cfg.chunk_len, cfg.motifs)
    owned_regions = None
    read_shard = None
    if dist:
        # collective mode: shard the READ stream; all ranks keep the full chunk
        # list (they must issue the same all-reduce sequence)
        read_shard = (cfg.process_id, cfg.num_processes)
        LOGGER.info("dist process %d/%d: read-sharded scan + all-reduce merge",
                    cfg.process_id, cfg.num_processes)
    elif cfg.num_processes > 1:
        from ..parallel.distributed import partition_chunks

        ref_chunks = partition_chunks(ref_chunks, cfg.process_id, cfg.num_processes)
        owned_regions = {}
        for contig, s, e in ref_chunks:
            owned_regions.setdefault(contig, []).append((s, e))
        LOGGER.info("process %d/%d owns %d genome chunks", cfg.process_id,
                    cfg.num_processes, len(ref_chunks))
    # motif filter window params (lines 464-471)
    fwd_s = fwd_e = rev_s = rev_e = None
    mf_set = None
    if motifs_filter is not None:
        len_motif = len(motifs_filter[0])
        fwd_s = -cfg.mod_loc
        fwd_e = len_motif - cfg.mod_loc
        rev_s = -(len_motif - 1 - cfg.mod_loc)
        rev_e = cfg.mod_loc + 1
        mf_set = set(motifs_filter)

    bed_all: list = []
    bed_hp1: list = []
    bed_hp2: list = []

    def emit_rows(rows, ref_name, strand_char, sinks=None):
        """Append (cov, met, freq) rows, applying the reference-motif filter
        (call_mods_freq_bam.py:565-585)."""
        sink_all, sink_hp1, sink_hp2 = sinks or (bed_all, bed_hp1, bed_hp2)
        for refpos, total_info, hp1_info, hp2_info in rows:
            if mf_set is not None:
                if strand_char == "+":
                    motif_seq = dnacontigs[ref_name][(refpos + fwd_s):(refpos + fwd_e)]
                else:
                    motif_seq = complement_seq(
                        dnacontigs[ref_name][(refpos + rev_s):(refpos + rev_e)])
                if motif_seq not in mf_set:
                    continue
            for info, bed in ((total_info, sink_all), (hp1_info, sink_hp1),
                              (hp2_info, sink_hp2)):
                if info is not None:
                    bed.append((ref_name, refpos, strand_char,
                                info[0], info[1], info[2]))

    combine = cfg.motifs == "CG" and not cfg.no_comb
    # streaming: for coordinate-sorted inputs (call_mods' sorted output, pbmm2
    # --sort, samtools sort — header SO:coordinate), completed genome chunks
    # convert to rows DURING the scan and their per-read (prob, hap) lists are
    # freed, so read-level memory is O(active window), not O(genome x coverage)
    # — the scalability equivalent of the reference's per-region BAI fetching.
    # Rows are assembled in ref_chunks order afterwards, so outputs are
    # bit-identical to the full-scan path. dist mode keeps the full scan (all
    # ranks must issue one identical all-reduce sequence after the pass).
    streaming = False
    sorted_hdr = False
    if not dist:
        hdr_reader = BamReader(cfg.input_bam)
        # parse the @HD line's SO: field only — a @PG/@CO line mentioning
        # "SO:coordinate" must not enable streaming on an unsorted file
        for hline in hdr_reader.header.text.splitlines():
            if hline.startswith("@HD"):
                sorted_hdr = "SO:coordinate" in hline.split("\t")
                break
        hdr_reader.close()
        streaming = sorted_hdr
    # BAI-scoped read access (reference behavior: fetch-per-region,
    # call_mods_freq_bam.py:600-614): when the run only touches a subset of
    # the genome — --contigs, or share-nothing chunk ownership — and the BAM
    # is sorted with an existing .bai, decode ONLY the scoped records instead
    # of linearly scanning the whole file. Index must pre-exist: concurrent
    # share-nothing ranks must not race to build the same .bai. Scope already
    # bounds memory, so this takes precedence over streaming.
    scoped_regions = None
    if sorted_hdr and not dist and os.path.exists(cfg.input_bam + ".bai"):
        if owned_regions is not None:
            scope = {c: sp for c, sp in owned_regions.items() if sp}
        elif cfg.contigs:
            chunk_contigs = {c for c, _s, _e in ref_chunks}
            scope = ({c: [(0, len(dnacontigs[c]))] for c in chunk_contigs}
                     if chunk_contigs != set(dnacontigs) else None)
        else:
            scope = None
        if scope:
            scoped_regions = scope
            streaming = False
            LOGGER.info("BAI-scoped scan: %d contig(s), %d span(s)",
                        len(scope), sum(len(v) for v in scope.values()))
    if streaming:
        from collections import deque as _deque

        chunks_by_contig: dict[str, _deque] = {}
        for idx, (c, s, e) in enumerate(ref_chunks):
            chunks_by_contig.setdefault(c, _deque()).append((s, e, idx))
        chunk_rows: dict[int, tuple] = {}
        live_accs: dict[str, _ContigAcc] = {}

        def process_chunk(contig, s, e, idx):
            refposinfo, refposinfo_rev = _pop_chunk_tables(
                live_accs, contig, s, e, combine)
            sinks = ([], [], [])
            if refposinfo:
                emit_rows(call_modfreq_of_one_region(refposinfo, cfg, aggr),
                          contig, "+", sinks)
            if refposinfo_rev:
                emit_rows(call_modfreq_of_one_region(refposinfo_rev, cfg, aggr),
                          contig, "-", sinks)
            chunk_rows[idx] = sinks

        def flush_cb(contig, frontier):
            dq = chunks_by_contig.get(contig)
            if not dq:
                return
            # +2: CG-straddle boundary fix (+1) and rev->fwd combining (+1) can
            # each reach one base past the chunk end
            while dq and (frontier is None or dq[0][1] + 2 <= frontier):
                s, e, idx = dq.popleft()
                process_chunk(contig, s, e, idx)

        scan_bam_accumulate(cfg, dnacontigs,
                            set(motifs) if motifs_filter else None,
                            owned_regions, read_shard, flush_cb, live_accs)
        for contig, dq in chunks_by_contig.items():
            while dq:  # tail chunks + contigs with no (owned) reads
                s, e, idx = dq.popleft()
                process_chunk(contig, s, e, idx)
        for idx in range(len(ref_chunks)):
            sinks = chunk_rows.get(idx)
            if sinks:
                bed_all.extend(sinks[0])
                bed_hp1.extend(sinks[1])
                bed_hp2.extend(sinks[2])
    else:
        accs = scan_bam_accumulate(cfg, dnacontigs,
                                   set(motifs) if motifs_filter else None,
                                   owned_regions, read_shard,
                                   scoped_regions=scoped_regions)
        # sort each contig's site positions ONCE; chunks then slice by
        # searchsorted (the per-chunk dict-comprehension alternative rescans
        # every contig site per chunk: O(sites x chunks), quadratic at genome
        # scale)
        sorted_acc: dict[str, tuple] = {}
        for contig, acc in accs.items():
            fwd_pos = np.fromiter(acc.fwd.keys(), np.int64, len(acc.fwd))
            fwd_pos.sort()
            rev_pos = np.fromiter(acc.rev.keys(), np.int64, len(acc.rev))
            rev_pos.sort()
            sorted_acc[contig] = (fwd_pos, rev_pos)
        if dist:
            _dist_emit_chunks(cfg, accs, sorted_acc, ref_chunks, combine, aggr,
                              emit_rows)
        else:
            for ref_name, ref_start, ref_end in ref_chunks:
                refposinfo, refposinfo_rev = _chunk_site_tables(
                    accs, sorted_acc, ref_name, ref_start, ref_end, combine)
                if refposinfo:
                    emit_rows(call_modfreq_of_one_region(refposinfo, cfg, aggr),
                              ref_name, "+")
                if refposinfo_rev:
                    emit_rows(call_modfreq_of_one_region(refposinfo_rev, cfg,
                                                         aggr),
                              ref_name, "-")

    LAST_RUN.clear()
    LAST_RUN.update(sites=len(bed_all), rows=aggr.rows if aggr else 0,
                    batches=aggr.batches if aggr else 0,
                    world=distributed.world, backend=distributed.backend,
                    allreduce_calls=distributed.allreduce_calls,
                    allreduce_bytes=distributed.allreduce_bytes,
                    allreduce_seconds=distributed.allreduce_seconds)
    if dist and not is_main:
        LAST_RUN.update(seconds=time.time() - t0)
        LOGGER.info("[main]call_freq_bam rank %d done (rank 0 writes) in %.1f "
                    "seconds", cfg.process_id, time.time() - t0)
        return []
    fext = "bed" if cfg.bed else "freq.txt"
    outputs = []
    for tag, items in (("all", bed_all), ("hp1", bed_hp1), ("hp2", bed_hp2)):
        path = cfg.output + ".{}.{}.{}".format(cfg.call_mode, tag, fext)
        if cfg.sort or cfg.gzip:
            # reference sorts whenever sorting OR gzipping (a tabix-indexed file
            # must be coordinate-sorted; call_mods_freq_bam.py:668-676)
            items = sorted(items, key=lambda x: (x[0], x[1]))
        with open(path, "w") as wf:
            for item in items:
                _write_one_line(item, wf, cfg.bed)
        if is_file_empty(path):
            os.remove(path)
            continue
        if cfg.gzip:
            from ..bamio.bgzf import BgzfWriter

            with open(path, "rb") as rf, BgzfWriter(path + ".gz") as w:
                w.write(rf.read())
            os.remove(path)
            path += ".gz"
            # tabix-index bgzipped outputs (reference: pysam.tabix_index,
            # call_mods_freq_bam.py:674)
            try:
                from ..bamio.tabix import build_tabix_index

                build_tabix_index(path)
            except Exception:  # noqa: BLE001
                LOGGER.warning("failed tabix-indexing %s", path)
        outputs.append(path)
    LAST_RUN.update(seconds=time.time() - t0)
    LOGGER.info("[main]call_freq_bam costs %.1f seconds", time.time() - t0)
    return outputs

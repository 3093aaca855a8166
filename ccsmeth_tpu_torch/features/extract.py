"""Vectorized per-read 21-mer feature extraction.

Semantics parity with the reference hot loop
(ccsmeth/extract_features.py:261-406,
``extract_features_from_double_strand_read``), redesigned for TPU feeding: a read
yields fixed-width numpy arrays (n_sites, seq_len) per channel directly — no
per-site Python loops and no string TSV detour on the hot path. TSV emission for
the ``extract`` subcommand is a separate formatting step
(:func:`features_to_tsv_rows`, parity with extract_features.py:434-466).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..bamio.bam import BamRecord
from ..utils.codecs import (
    BYTE2CODE,
    codecv1_decode,
    compute_pct_identity,
    get_q2tloc_from_cigar,
    motif_hits,
    normalize_signals,
)
from ..utils.constants import BYTE_COMPLEMENT


@dataclasses.dataclass(frozen=True)
class ExtractConfig:
    """Flags of the reference's EXTRACTION groups (ccsmeth.py extract/call_mods)."""

    mode: str = "denovo"  # denovo | align
    seq_len: int = 21
    motifs: str = "CG"
    mod_loc: int = 0
    methy_label: int = 1
    norm: str = "zscore"
    no_decode: bool = False
    is_sn: bool = False
    is_map: bool = False
    mapq: int = 1
    identity: float = 0.0
    no_supplementary: bool = False
    skip_unmapped: bool = True
    holes_batch: int = 50


class ReadFeatures:
    """Columnar features of one read's motif sites (n = number of sites kept)."""

    __slots__ = (
        "read_name", "chrom", "strand", "locs", "chrom_pos",
        "fkmer", "fipd", "fpw", "npass_fwd", "fmap",
        "rkmer", "ripd", "rpw", "npass_rev", "rmap",
        "sn", "label",
        "fkmer_bytes", "rkmer_bytes",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))

    @property
    def n_sites(self) -> int:
        return len(self.locs)


def _decode_normalize(vals: np.ndarray, cfg: ExtractConfig) -> np.ndarray:
    v = np.asarray(vals, dtype=np.int64)
    if not cfg.no_decode:
        v = codecv1_decode(v)
    return normalize_signals(v, cfg.norm)


def _q2t_mapinfo(q2t: np.ndarray, q_codes: np.ndarray, t_codes: np.ndarray) -> np.ndarray:
    """Vectorized _get_q2t_mapinfo (extract_features.py:202-220): 3-bit map feature
    per aligned-query position (+1 insertion, +2 deletion-before, +4 mismatch)."""
    n = len(q2t)
    m = np.zeros(n, dtype=np.int32)
    ins = q2t == -1
    valid = ~ins
    valid[-1] = False  # last entry (the alen sentinel) gets no mismatch/del check here
    # mismatch: q base != t base at mapped loc (case-insensitive via code compare)
    mm = np.zeros(n, dtype=bool)
    idx = np.flatnonzero(valid[:-1])
    if idx.size:
        mm_idx = idx[q_codes[idx] != t_codes[q2t[idx]]]
        mm[mm_idx] = True
    m[ins] = 1
    m[mm] += 4
    # deletion flag for idx>=1: prev mapped and not consecutive
    if n > 2:
        cur = np.arange(1, n - 1)
        dele = (~ins[cur]) & (~ins[cur - 1]) & (q2t[cur] != q2t[cur - 1] + 1)
        m[cur[dele]] += 2
    # index 0 special-case: reference uses elif (mismatch only when not insertion) and
    # no deletion check — already satisfied: ins[0] forces m[0]=1, else mismatch only.
    return m


def _window_gather(arr: np.ndarray, centers: np.ndarray, num_bases: int) -> np.ndarray:
    """arr (L,), centers (n,) -> (n, 2*num_bases+1); centers are pre-filtered in range."""
    idx = centers[:, None] + np.arange(-num_bases, num_bases + 1)[None, :]
    return arr[idx]


def _window_gather_padded(arr: np.ndarray, centers: np.ndarray, num_bases: int,
                          pad_value) -> np.ndarray:
    """Like _window_gather but clamps out-of-range positions to ``pad_value``
    (used by map features, extract_features.py:223-258)."""
    n = len(arr)
    idx = centers[:, None] + np.arange(-num_bases, num_bases + 1)[None, :]
    out = np.full(idx.shape, pad_value, dtype=arr.dtype)
    ok = (idx >= 0) & (idx < n)
    out[ok] = arr[np.clip(idx, 0, n - 1)][ok]
    return out


def extract_read_features(rec: BamRecord, motifs: list[str], cfg: ExtractConfig,
                          dnacontigs: dict[str, str] | None = None,
                          holeids_e=None, holeids_ne=None,
                          refname: str | None = None) -> ReadFeatures | None:
    """Extract all motif-site features of one read; None if the read is filtered.

    Follows extract_features.py:261-406 step-for-step (filters -> kinetics decode ->
    normalize -> motif scan -> two-strand window slicing -> ref-coordinate mapping),
    vectorized across sites.
    """
    if holeids_e is not None and rec.qname not in holeids_e:
        return None
    if holeids_ne is not None and rec.qname in holeids_ne:
        return None
    align = cfg.mode == "align"
    if align:
        if rec.is_unmapped or rec.is_secondary or rec.is_duplicate:
            return None
        if cfg.no_supplementary and rec.is_supplementary:
            return None
        if rec.mapq < cfg.mapq:
            return None
        if compute_pct_identity(rec.get_cigar_stats()) < cfg.identity:
            return None

    fwd_seq = rec.get_forward_sequence()
    L = len(fwd_seq)
    seq_bytes = np.frombuffer(fwd_seq.encode("ascii"), dtype=np.uint8)
    # seq_rc = reverse complement of the forward read seq (extract_features.py:289)
    rc_bytes = BYTE_COMPLEMENT[seq_bytes][::-1]

    reverse = rec.is_reverse
    if reverse:
        seq_start = L - rec.query_alignment_end
        seq_end = L - rec.query_alignment_start
    else:
        seq_start = rec.query_alignment_start
        seq_end = rec.query_alignment_end

    q_to_r = None
    q_to_r_map = None
    if align:
        strand_code = -1 if reverse else 1
        q_to_r = get_q2tloc_from_cigar(rec.cigar, strand_code, seq_end - seq_start)
        if cfg.is_map:
            refseq = dnacontigs[refname][rec.pos : rec.reference_end]
            if reverse:
                from ..utils.codecs import complement_seq

                refseq = complement_seq(refseq)
            t_codes = BYTE2CODE[np.frombuffer(refseq.encode("ascii"), np.uint8)]
            q_codes = BYTE2CODE[seq_bytes[seq_start:seq_end]]
            q_to_r_map = _q2t_mapinfo(q_to_r, q_codes, t_codes)

    # kinetics tags (extract_features.py:108-123,314-334)
    try:
        fi = rec.get_tag("fi")
        ri = rec.get_tag("ri")
        fp = rec.get_tag("fp")
        rp = rec.get_tag("rp")
    except KeyError:
        return None
    if len(fi) != L or len(fp) != L or len(ri) != L or len(rp) != L:
        return None
    ipd_fwd = _decode_normalize(fi, cfg)
    ipd_rev = _decode_normalize(ri, cfg)
    pw_fwd = _decode_normalize(fp, cfg)
    pw_rev = _decode_normalize(rp, cfg)

    npass_fwd = rec.get_tag("fn") if rec.has_tag("fn") else 0
    npass_rev = rec.get_tag("rn") if rec.has_tag("rn") else 0
    sn = None
    if cfg.is_sn:
        sn = np.around(np.asarray(rec.get_tag("sn") if rec.has_tag("sn") else [], dtype=float), 6)

    # motif scan on the forward sequence (extract_features.py:341-349)
    motif_len = len(motifs[0])
    rev_offset_loc = (motif_len - 1 - cfg.mod_loc) - cfg.mod_loc
    locs = motif_hits(seq_bytes, motifs, cfg.mod_loc)
    num_bases = (cfg.seq_len - 1) // 2
    rev_locs = locs + rev_offset_loc
    rev_in_rev = L - 1 - rev_locs
    keep = (
        (locs >= num_bases) & (locs < L - num_bases)
        & (rev_in_rev >= num_bases) & (rev_in_rev < L - num_bases)
    )
    locs = locs[keep]
    rev_locs = rev_locs[keep]
    rev_in_rev = rev_in_rev[keep]

    chrom = "."
    strand = "."
    if align:
        chrom = refname
        strand = "-" if reverse else "+"
        in_aligned = (locs >= seq_start) & (locs < seq_end)
        if cfg.skip_unmapped:
            locs = locs[in_aligned]
            rev_locs = rev_locs[in_aligned]
            rev_in_rev = rev_in_rev[in_aligned]
            in_aligned = np.ones(len(locs), dtype=bool)
    if len(locs) == 0:
        return None

    fkmer = _window_gather(seq_bytes, locs, num_bases)
    fipd = _window_gather(ipd_fwd, locs, num_bases)
    fpw = _window_gather(pw_fwd, locs, num_bases)
    rkmer = _window_gather(rc_bytes, rev_in_rev, num_bases)
    ripd = _window_gather(ipd_rev, rev_in_rev, num_bases)
    rpw = _window_gather(pw_rev, rev_in_rev, num_bases)

    chrom_pos = np.full(len(locs), -1, dtype=np.int64)
    fmap = rmap = None
    if align:
        offset = locs - seq_start
        ok = in_aligned.copy()
        mapped = np.zeros(len(locs), dtype=bool)
        if ok.any():
            q2r_vals = q_to_r[offset[ok]]
            mp = q2r_vals != -1
            sel = np.flatnonzero(ok)[mp]
            if reverse:
                chrom_pos[sel] = rec.reference_end - 1 - q2r_vals[mp]
            else:
                chrom_pos[sel] = q2r_vals[mp] + rec.pos
            mapped[sel] = True
        if cfg.is_map:
            # map windows over q_to_r_map[:-1], pad 1; rkmer_map flipped
            # (extract_features.py:223-258,385-393)
            base = q_to_r_map[:-1]
            fmap = np.ones((len(locs), cfg.seq_len), dtype=np.int32)
            rmap = np.ones((len(locs), cfg.seq_len), dtype=np.int32)
            if ok.any():
                off_rev = rev_locs - seq_start
                fmap[ok] = _window_gather_padded(base, offset[ok], num_bases, 1)
                rmap[ok] = _window_gather_padded(base, off_rev[ok], num_bases, 1)[:, ::-1]

    return ReadFeatures(
        read_name=rec.qname, chrom=chrom, strand=strand,
        locs=locs, chrom_pos=chrom_pos,
        fkmer=BYTE2CODE[fkmer], fipd=fipd, fpw=fpw, npass_fwd=npass_fwd, fmap=fmap,
        rkmer=BYTE2CODE[rkmer], ripd=ripd, rpw=rpw, npass_rev=npass_rev, rmap=rmap,
        sn=sn, label=cfg.methy_label,
        fkmer_bytes=fkmer, rkmer_bytes=rkmer,
    )


# ---------------------------------------------------------------------------------------
# TSV compatibility (extract subcommand; format parity with _features_to_str,
# extract_features.py:434-466)
# ---------------------------------------------------------------------------------------


def _vec_str(row: np.ndarray) -> str:
    return ",".join(str(x) for x in row)


def features_to_tsv_rows(rf: ReadFeatures, is_sn: bool, is_map: bool) -> list[str]:
    rows = []
    sn_str = _vec_str(rf.sn) if (is_sn and rf.sn is not None) else "."
    for i in range(rf.n_sites):
        fmap_str = _vec_str(rf.fmap[i]) if (is_map and rf.fmap is not None) else "."
        rmap_str = _vec_str(rf.rmap[i]) if (is_map and rf.rmap is not None) else "."
        rows.append("\t".join([
            rf.chrom, str(int(rf.chrom_pos[i])), rf.strand, rf.read_name, str(int(rf.locs[i])),
            rf.fkmer_bytes[i].tobytes().decode("ascii"), str(rf.npass_fwd),
            _vec_str(rf.fipd[i]), ".", _vec_str(rf.fpw[i]), ".", sn_str, fmap_str,
            rf.rkmer_bytes[i].tobytes().decode("ascii"), str(rf.npass_rev),
            _vec_str(rf.ripd[i]), ".", _vec_str(rf.rpw[i]), ".", sn_str, rmap_str,
            str(rf.label),
        ]))
    return rows

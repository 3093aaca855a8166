"""Pure, vectorized codecs of the ccsmeth data path.

These define bit-equality with the reference (PengNi/ccsmeth v0.5.0); each function
cites the reference semantics it reproduces (file:line under ccsmeth/).
All hot-path variants operate on numpy arrays (no per-base Python loops).
"""

from __future__ import annotations

import math
import re
from typing import Iterable, Sequence

import numpy as np

from .constants import (
    BASEPAIRS,
    BASEPAIRS_RNA,
    BYTE2CODE,
    BYTE_COMPLEMENT,
    IUPAC_ALPHABETS,
    IUPAC_ALPHABETS_RNA,
)

# ---------------------------------------------------------------------------------------
# CodecV1: PacBio 8-bit kinetics code -> frame count (process_utils.py:400-449)
# codes 0-63 identity; 64-127 -> 64..190 step 2; 128-191 -> 192..444 step 4;
# 192-255 -> 448..952 step 8.
# ---------------------------------------------------------------------------------------


def codecv1_table() -> np.ndarray:
    """256-entry LUT, dtype int32."""
    codes = np.arange(256, dtype=np.int64)
    frames = np.where(
        codes < 64,
        codes,
        np.where(
            codes < 128,
            64 + (codes - 64) * 2,
            np.where(codes < 192, 192 + (codes - 128) * 4, 448 + (codes - 192) * 8),
        ),
    )
    return frames.astype(np.int32)


CODECV1_LUT = codecv1_table()


def codecv1_decode(codes: np.ndarray) -> np.ndarray:
    """Decode 8-bit kinetics codes to frame counts (extract_features.py:326-330)."""
    return CODECV1_LUT[np.asarray(codes, dtype=np.int64)]


# ---------------------------------------------------------------------------------------
# Sequence utilities
# ---------------------------------------------------------------------------------------


def seq_to_code(seq: str) -> np.ndarray:
    """ASCII sequence -> 5-way base codes (uint8), everything ambiguous -> 4 (N)."""
    b = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return BYTE2CODE[b]


def seq_to_bytes(seq: str) -> np.ndarray:
    return np.frombuffer(seq.encode("ascii"), dtype=np.uint8)


def bytes_to_seq(arr: np.ndarray) -> str:
    return arr.tobytes().decode("ascii")


def complement_seq(base_seq: str, seq_type: str = "DNA") -> str:
    """Reverse-complement (note: the reference's ``complement_seq`` REVERSES too;
    process_utils.py:106-118). Unknown letters map to N."""
    if seq_type == "DNA":
        pairs = BASEPAIRS
    elif seq_type == "RNA":
        pairs = BASEPAIRS_RNA
    else:
        raise ValueError("the seq_type must be DNA or RNA")
    if seq_type == "DNA":
        b = np.frombuffer(base_seq.encode("ascii"), dtype=np.uint8)
        return BYTE_COMPLEMENT[b][::-1].tobytes().decode("ascii")
    return "".join(pairs.get(x, "N") for x in reversed(base_seq))


# ---------------------------------------------------------------------------------------
# Motifs (process_utils.py:122-170)
# ---------------------------------------------------------------------------------------


def _convert_motif_seq(ori_seq: str, is_dna: bool = True) -> list[str]:
    """Expand one IUPAC motif into all concrete sequences (process_utils.py:140-161)."""
    table = IUPAC_ALPHABETS if is_dna else IUPAC_ALPHABETS_RNA
    seqs = [""]
    for bbase in ori_seq:
        seqs = [s + nb for s in seqs for nb in table[bbase]]
    return seqs


def get_motif_seqs(motifs: str, is_dna: bool = True) -> list[str]:
    """Expand a comma-separated IUPAC motif string (process_utils.py:164-170)."""
    out: list[str] = []
    for ori_motif in motifs.strip().split(","):
        out += _convert_motif_seq(ori_motif.strip().upper(), is_dna)
    return out


def get_refloc_of_methysite_in_motif(
    seqstr: str, motifset: Iterable[str], methyloc_in_motif: int = 0
) -> list[str]:
    """Scan a sequence for motif hits; returns 0-based mod-base locations
    (process_utils.py:122-137). Kept for API parity; hot path uses
    :func:`motif_hits_in_codes`."""
    motifset = set(motifset)
    motiflen = len(next(iter(motifset)))
    return [
        i + methyloc_in_motif
        for i in range(0, len(seqstr) - motiflen + 1)
        if seqstr[i : i + motiflen] in motifset
    ]


def motif_hits(seq_bytes: np.ndarray, motifs: Sequence[str], mod_loc: int = 0) -> np.ndarray:
    """Vectorized motif scan over an ASCII byte array.

    Returns sorted 0-based positions of the mod base (motif start + mod_loc), matching
    get_refloc_of_methysite_in_motif semantics. Case-sensitive like the reference
    (read sequences are uppercase by convention).
    """
    n = seq_bytes.shape[0]
    mlen = len(motifs[0])
    if n < mlen:
        return np.empty(0, dtype=np.int64)
    hit = np.zeros(n - mlen + 1, dtype=bool)
    for motif in motifs:
        m = np.frombuffer(motif.encode("ascii"), dtype=np.uint8)
        cur = np.ones(n - mlen + 1, dtype=bool)
        for j in range(mlen):
            cur &= seq_bytes[j : n - mlen + 1 + j] == m[j]
        hit |= cur
    return np.flatnonzero(hit) + mod_loc


# ---------------------------------------------------------------------------------------
# Kinetics normalization (extract_features.py:181-199)
# ---------------------------------------------------------------------------------------

_MAD_C = 0.6744897501960817  # Gaussian consistency constant used by statsmodels mad


def normalize_signals(signals: np.ndarray, normalize_method: str = "zscore") -> np.ndarray:
    """Per-read kinetics normalization, bit-matching extract_features.py:181-199.

    methods: zscore | min-max | min-mean | mad | none. Output rounded to 6 decimals
    with numpy half-even rounding (np.around), like the reference.
    """
    signals = np.asarray(signals)
    if normalize_method == "none":
        return np.around(signals, decimals=6)
    if normalize_method == "zscore":
        sshift, sscale = np.mean(signals), np.std(signals)
    elif normalize_method == "min-max":
        sshift, sscale = np.min(signals), np.max(signals) - np.min(signals)
    elif normalize_method == "min-mean":
        sshift, sscale = np.min(signals), np.mean(signals)
    elif normalize_method == "mad":
        med = np.median(signals)
        sshift, sscale = med, float(np.median(np.abs(signals - med)) / _MAD_C)
    else:
        raise ValueError("normalize_method must be one of zscore/min-max/min-mean/mad/none")
    if sscale == 0.0:
        norm = np.zeros(len(signals), dtype=np.float64)
    else:
        norm = (signals - sshift) / sscale
    return np.around(norm, decimals=6)


# ---------------------------------------------------------------------------------------
# CIGAR (process_utils.py:174-226)
# ---------------------------------------------------------------------------------------


def compute_pct_identity(cigar_stats: np.ndarray) -> float:
    """Fraction of M+= ops among non-clip ops (process_utils.py:174-186)."""
    try:
        nalign = int(sum(cigar_stats[i] for i in range(10) if i not in (4, 5)))
        nmatch = int(cigar_stats[0] + cigar_stats[7])
        return nmatch / float(nalign)
    except (IndexError, ZeroDivisionError):
        return 0.0


def get_q2tloc_from_cigar(
    cigar_tuples: Sequence[tuple[int, int]], strand: int, seq_len: int
) -> np.ndarray:
    """Query-pos -> ref-pos mapping over the aligned portion of a read.

    Mirrors process_utils.py:190-226 (megalodon-derived): -1 insertion, -2 invalid;
    output has seq_len+1 entries, last = total ref span. ``strand`` is 1/-1; on -1 the
    cigar is walked reversed. Vectorized per-op (ops are few; fills are numpy slices).
    """
    q_to_r = np.full(seq_len + 1, -2, dtype=np.int32)
    r_pos, q_pos = 0, 0
    ops = cigar_tuples if strand == 1 else cigar_tuples[::-1]
    for op, op_len in ops:
        if op == 1:  # insertion
            q_to_r[q_pos : q_pos + op_len] = -1
            q_pos += op_len
        elif op in (2, 3):  # deletion / ref skip
            r_pos += op_len
        elif op in (0, 7, 8):  # aligned
            q_to_r[q_pos : q_pos + op_len] = np.arange(r_pos, r_pos + op_len, dtype=np.int32)
            q_pos += op_len
            r_pos += op_len
        elif op == 6:  # padding
            pass
    q_to_r[q_pos] = r_pos
    if q_to_r[-1] == -2:
        raise ValueError(
            "Invalid cigar string encountered. Reference length: {}  Cigar "
            "implied reference length: {}".format(seq_len, r_pos)
        )
    return q_to_r


def aligned_pairs_from_cigar(
    cigar_tuples: Sequence[tuple[int, int]], ref_start: int, matches_only: bool = True
) -> np.ndarray:
    """(q_pos, r_pos) pairs like pysam get_aligned_pairs, vectorized.

    Returns an (N, 2) int64 array. With matches_only, only M/=/X columns appear.
    Without it, insertions have r_pos=-1 and deletions q_pos=-1 (None in pysam).
    Soft-clipped bases are consumed in q but never emitted (pysam semantics — soft
    clips ARE reported by pysam with r_pos None; callers here only use pairs where
    both are valid or refsites_all deletion columns, see pipeline/call_freq_bam.py).
    """
    qs: list[np.ndarray] = []
    rs: list[np.ndarray] = []
    q, r = 0, ref_start
    for op, ln in cigar_tuples:
        if op in (0, 7, 8):
            qs.append(np.arange(q, q + ln, dtype=np.int64))
            rs.append(np.arange(r, r + ln, dtype=np.int64))
            q += ln
            r += ln
        elif op in (1, 4):  # insertion / softclip: consumes query
            if not matches_only:
                qs.append(np.arange(q, q + ln, dtype=np.int64))
                rs.append(np.full(ln, -1, dtype=np.int64))
            q += ln
        elif op in (2, 3):  # deletion / ref skip: consumes ref
            if not matches_only:
                qs.append(np.full(ln, -1, dtype=np.int64))
                rs.append(np.arange(r, r + ln, dtype=np.int64))
            r += ln
        # 5 (hardclip), 6 (pad): consume nothing
    if not qs:
        return np.empty((0, 2), dtype=np.int64)
    return np.stack([np.concatenate(qs), np.concatenate(rs)], axis=1)


_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=XB])")
_CIGAR_CODE = {c: i for i, c in enumerate("MIDNSHP=XB")}


def parse_cigar_string(cigar: str) -> list[tuple[int, int]]:
    """SAM cigar string -> [(op_code, length)]."""
    if cigar in ("*", ""):
        return []
    return [(_CIGAR_CODE[c], int(n)) for n, c in _CIGAR_RE.findall(cigar)]


def cigar_stats_from_tuples(cigar_tuples: Sequence[tuple[int, int]]) -> np.ndarray:
    """Per-op base counts like pysam get_cigar_stats()[0] (first 10 entries; NM excluded)."""
    stats = np.zeros(11, dtype=np.int64)
    for op, ln in cigar_tuples:
        stats[op] += ln
    return stats


# ---------------------------------------------------------------------------------------
# MM/ML modbam tags (_bam2modbam.py:187-226, call_mods_freq_bam.py:102-170)
# ---------------------------------------------------------------------------------------


def convert_locs_to_mmtag(locs: Sequence[int], seq_fwdseq_bytes: np.ndarray, base: str = "C") -> list[int]:
    """Forward-strand mod-base positions -> MM delta encoding (_bam2modbam.py:187-203).

    ``locs`` must be sorted positions that are all ``base`` in the forward sequence;
    raises AssertionError otherwise (callers skip the read), like the reference.
    """
    assert len(locs) > 0
    base_alllocs = np.flatnonzero(seq_fwdseq_bytes == ord(base))
    locs_arr = np.asarray(locs, dtype=np.int64)
    orders = np.searchsorted(base_alllocs, locs_arr)
    assert orders[-1] < len(base_alllocs) and np.all(base_alllocs[orders] == locs_arr)
    deltas = np.empty(len(orders), dtype=np.int64)
    deltas[0] = orders[0]
    deltas[1:] = np.diff(orders) - 1
    return deltas.tolist()


def convert_probs_to_mltag(probs: Sequence[float]) -> list[int]:
    """prob -> ML byte: floor(p*256), capped 255 (_bam2modbam.py:206-208)."""
    return [math.floor(p * 256) if p < 1 else 255 for p in probs]


def ml_to_prob(ml_value: int) -> float:
    """ML byte -> prob: round(ml/256 + 1e-6, 6), 0 stays 0 (call_mods_freq_bam.py:102-107)."""
    return round(ml_value / 256.0 + 0.000001, 6) if ml_value > 0 else 0


def parse_mm_tag(mmtag: str, modbase: str = "C", modification: str = "m") -> list[int] | None:
    """Extract the delta list for ``modbase+modification`` from an MM tag string.

    Mirrors call_mods_freq_bam.py:140-151 (handles optional '?'/'.' skip-scheme char).
    Returns None when the tag lacks the requested modification.
    """
    for x in mmtag.split(";"):
        if x.startswith(modbase + "+" + modification):
            start_index = len(modbase) + 1 + len(modification)
            if len(x) > start_index and x[start_index] in "?.":
                start_index += 1
            if len(x) > start_index and x[start_index] == ",":
                start_index += 1
                return [int(y) for y in x[start_index:].split(",")]
            return None
    return None


def moddict_from_mm_ml(
    mm_deltas: Sequence[int],
    ml_values: Sequence[int],
    fwd_seq_bytes: np.ndarray,
    is_reverse: bool,
    modbase: str = "C",
) -> dict[int, float]:
    """MM deltas + ML bytes -> {query_pos(alignment strand): prob}.

    Mirrors call_mods_freq_bam.py:152-163: delta-decode to ranks among all modbase
    occurrences in the FORWARD sequence, map to positions, flip coords for reverse
    reads, ML byte -> prob via :func:`ml_to_prob`. Raises IndexError when ranks run
    past the sequence's modbase count and AssertionError on MM/ML length mismatch
    (callers warn+return {}).
    """
    modbases_all = np.flatnonzero(fwd_seq_bytes == ord(modbase))
    ranks = np.cumsum(np.asarray(mm_deltas, dtype=np.int64) + 1) - 1
    if len(ranks) and ranks[-1] >= len(modbases_all):
        raise IndexError("MM tag length does not match length of modbases in read")
    positions = modbases_all[ranks]
    assert len(positions) == len(ml_values)
    seq_len = len(fwd_seq_bytes)
    if is_reverse:
        positions = seq_len - 1 - positions
    return {int(p): ml_to_prob(int(v)) for p, v in zip(positions, ml_values)}

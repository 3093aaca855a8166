"""BAM record parsing/writing over BGZF, plus SAM text read support.

First-party replacement for the pysam surface the reference leans on
(pysam.AlignmentFile / AlignedSegment: ccsmeth/extract_features.py:60-126,
call_modifications.py:410-462). Tag arrays decode straight into numpy (zero-copy views
of the record buffer) so kinetics vectors feed the vectorized feature extractor without
per-element Python.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterator, Sequence

import numpy as np

from .bgzf import BgzfReader, BgzfWriter
from ..utils.codecs import cigar_stats_from_tuples, complement_seq, parse_cigar_string

BAM_MAGIC = b"BAM\x01"

# 4-bit nibble -> base char ("=ACMGRSVTWYHKDBN")
_NIB2BASE = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
_BASE2NIB = np.full(256, 15, dtype=np.uint8)  # unknown -> N
for _i, _ch in enumerate(b"=ACMGRSVTWYHKDBN"):
    _BASE2NIB[_ch] = _i
    _BASE2NIB[ord(chr(_ch).lower())] = _i

_CIGAR_OPS = "MIDNSHP=X"

_TAG_FMT = {
    ord("c"): ("<b", 1), ord("C"): ("<B", 1),
    ord("s"): ("<h", 2), ord("S"): ("<H", 2),
    ord("i"): ("<i", 4), ord("I"): ("<I", 4),
    ord("f"): ("<f", 4), ord("A"): ("c", 1),
}
_B_DTYPE = {
    ord("c"): np.int8, ord("C"): np.uint8,
    ord("s"): np.int16, ord("S"): np.uint16,
    ord("i"): np.int32, ord("I"): np.uint32,
    ord("f"): np.float32,
}
_DTYPE_B = {np.dtype(v): chr(k) for k, v in _B_DTYPE.items()}

FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FDUP = 0x400
FSUPPLEMENTARY = 0x800


class BamHeader:
    """SAM header text + reference dictionary."""

    def __init__(self, text: str = "", references: Sequence[tuple[str, int]] = ()):
        self.text = text
        self.references = list(references)
        self._name2id = {name: i for i, (name, _l) in enumerate(self.references)}

    def refid(self, name: str | None) -> int:
        if name is None or name in ("*", "="):
            return -1
        return self._name2id[name]

    def refname(self, rid: int) -> str | None:
        if rid < 0:
            return None
        return self.references[rid][0]

    def add_pg(self, pn: str, pg_id: str, vn: str, cl: str) -> "BamHeader":
        """Append an @PG line (reference adds a ccsmeth @PG entry,
        call_modifications.py:445)."""
        pp = None
        for line in self.text.splitlines():
            if line.startswith("@PG"):
                for f in line.split("\t"):
                    if f.startswith("ID:"):
                        pp = f[3:]
        entry = "@PG\tID:{}\tPN:{}".format(pg_id, pn)
        if pp:
            entry += "\tPP:{}".format(pp)
        entry += "\tVN:{}\tCL:{}".format(vn, cl)
        text = self.text
        if text and not text.endswith("\n"):
            text += "\n"
        return BamHeader(text + entry + "\n", self.references)

    @classmethod
    def from_sam_text(cls, text: str) -> "BamHeader":
        refs = []
        for line in text.splitlines():
            if line.startswith("@SQ"):
                name, ln = None, None
                for f in line.split("\t")[1:]:
                    if f.startswith("SN:"):
                        name = f[3:]
                    elif f.startswith("LN:"):
                        ln = int(f[3:])
                if name is not None and ln is not None:
                    refs.append((name, ln))
        return cls(text, refs)


@dataclass
class BamRecord:
    """One alignment record. ``seq`` is the stored (alignment-strand) sequence."""

    qname: str = "*"
    flag: int = 4
    ref_id: int = -1
    pos: int = -1  # 0-based leftmost
    mapq: int = 255
    cigar: list[tuple[int, int]] = field(default_factory=list)
    rnext_id: int = -1
    pnext: int = -1
    tlen: int = 0
    seq: str = ""
    qual: np.ndarray | None = None  # phred values, None when '*'
    tags: list[tuple[str, str, object]] = field(default_factory=list)  # (tag, type, value)

    # -- flags ------------------------------------------------------------------
    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FSECONDARY)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & FDUP)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FSUPPLEMENTARY)

    # -- derived ----------------------------------------------------------------
    def get_forward_sequence(self) -> str:
        """Original-strand sequence (pysam get_forward_sequence semantics)."""
        return complement_seq(self.seq) if self.is_reverse else self.seq

    @property
    def query_length(self) -> int:
        return len(self.seq)

    @property
    def reference_length(self) -> int:
        """Ref bases consumed by the alignment (M/D/N/=/X)."""
        return sum(ln for op, ln in self.cigar if op in (0, 2, 3, 7, 8))

    @property
    def reference_end(self) -> int:
        return self.pos + self.reference_length

    @property
    def query_alignment_start(self) -> int:
        """First aligned base in query coords (skips leading soft/hard clips)."""
        s = 0
        for op, ln in self.cigar:
            if op == 4:
                s += ln
            elif op == 5:
                continue
            else:
                break
        return s

    @property
    def query_alignment_end(self) -> int:
        e = len(self.seq)
        for op, ln in reversed(self.cigar):
            if op == 4:
                e -= ln
            elif op == 5:
                continue
            else:
                break
        return e

    def get_cigar_stats(self) -> np.ndarray:
        return cigar_stats_from_tuples(self.cigar)

    # -- tags --------------------------------------------------------------------
    def get_tag(self, tag: str):
        for t, _ty, v in self.tags:
            if t == tag:
                return v
        raise KeyError(tag)

    def has_tag(self, tag: str) -> bool:
        return any(t == tag for t, _ty, _v in self.tags)

    def set_tag(self, tag: str, ty: str, value) -> None:
        self.tags = [t for t in self.tags if t[0] != tag]
        self.tags.append((tag, ty, value))

    def drop_tags(self, names) -> None:
        names = set(names)
        self.tags = [t for t in self.tags if t[0] not in names]


# ---------------------------------------------------------------------------------------
# binary decode/encode
# ---------------------------------------------------------------------------------------


def decode_record(buf: bytes, header: BamHeader) -> BamRecord:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar_op, flag, l_seq, next_ref, next_pos,
     tlen) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
    off = 32
    qname = buf[off : off + l_read_name - 1].decode("ascii")
    off += l_read_name
    cigar_raw = np.frombuffer(buf, dtype=np.uint32, count=n_cigar_op, offset=off)
    cigar = [(int(c & 0xF), int(c >> 4)) for c in cigar_raw]
    off += 4 * n_cigar_op
    nbytes_seq = (l_seq + 1) // 2
    seq_packed = np.frombuffer(buf, dtype=np.uint8, count=nbytes_seq, offset=off)
    nibs = np.empty(nbytes_seq * 2, dtype=np.uint8)
    nibs[0::2] = seq_packed >> 4
    nibs[1::2] = seq_packed & 0xF
    seq = _NIB2BASE[nibs[:l_seq]].tobytes().decode("ascii")
    off += nbytes_seq
    qual_raw = np.frombuffer(buf, dtype=np.uint8, count=l_seq, offset=off)
    qual = None if (l_seq > 0 and qual_raw[0] == 0xFF) else qual_raw.copy()
    off += l_seq
    tags = _decode_tags(buf, off)
    return BamRecord(qname, flag, ref_id, pos, mapq, cigar, next_ref, next_pos, tlen,
                     seq, qual, tags)


def _decode_tags(buf: bytes, off: int) -> list[tuple[str, str, object]]:
    tags: list[tuple[str, str, object]] = []
    n = len(buf)
    while off + 3 <= n:
        tag = buf[off : off + 2].decode("ascii")
        ty = buf[off + 2]
        off += 3
        if ty in _TAG_FMT and ty != ord("A"):
            fmt, sz = _TAG_FMT[ty]
            (val,) = struct.unpack_from(fmt, buf, off)
            off += sz
            tags.append((tag, chr(ty), val))
        elif ty == ord("A"):
            tags.append((tag, "A", chr(buf[off])))
            off += 1
        elif ty in (ord("Z"), ord("H")):
            end = buf.index(b"\x00", off)
            tags.append((tag, chr(ty), buf[off:end].decode("ascii")))
            off = end + 1
        elif ty == ord("B"):
            sub = buf[off]
            (count,) = struct.unpack_from("<I", buf, off + 1)
            dt = _B_DTYPE[sub]
            arr = np.frombuffer(buf, dtype=dt, count=count, offset=off + 5).copy()
            tags.append((tag, "B" + chr(sub), arr))
            off += 5 + count * np.dtype(dt).itemsize
        else:
            raise ValueError("unknown tag type {!r} for tag {}".format(chr(ty), tag))
    return tags


def encode_record(rec: BamRecord) -> bytes:
    l_read_name = len(rec.qname) + 1
    l_seq = len(rec.seq)
    nbytes_seq = (l_seq + 1) // 2
    parts = [b""]  # placeholder for fixed header
    parts.append(rec.qname.encode("ascii") + b"\x00")
    cigar_raw = np.array([(ln << 4) | op for op, ln in rec.cigar], dtype=np.uint32)
    parts.append(cigar_raw.tobytes())
    if l_seq:
        nibs = _BASE2NIB[np.frombuffer(rec.seq.encode("ascii"), dtype=np.uint8)]
        if l_seq % 2:
            nibs = np.append(nibs, 0)
        packed = (nibs[0::2] << 4) | nibs[1::2]
        parts.append(packed.astype(np.uint8).tobytes())
        if rec.qual is None:
            parts.append(b"\xff" * l_seq)
        else:
            parts.append(np.asarray(rec.qual, dtype=np.uint8).tobytes())
    parts.append(_encode_tags(rec.tags))
    # reg2bin over [pos, end)
    end = rec.reference_end if (rec.flag & FUNMAP) == 0 and rec.cigar else rec.pos + 1
    bin_ = _reg2bin(rec.pos if rec.pos >= 0 else 0, end if end > rec.pos else rec.pos + 1)
    fixed = struct.pack(
        "<iiBBHHHiiii", rec.ref_id, rec.pos, l_read_name, rec.mapq, bin_,
        len(rec.cigar), rec.flag, l_seq, rec.rnext_id, rec.pnext, rec.tlen,
    )
    parts[0] = fixed
    body = b"".join(parts)
    return struct.pack("<I", len(body)) + body


def _encode_tags(tags) -> bytes:
    out = bytearray()
    for tag, ty, val in tags:
        out += tag.encode("ascii")
        if ty == "A":
            out += b"A" + val.encode("ascii")[:1]
        elif ty in ("c", "C", "s", "S", "i", "I", "f"):
            out += ty.encode("ascii") + struct.pack(_TAG_FMT[ord(ty)][0], val)
        elif ty in ("Z", "H"):
            out += ty.encode("ascii") + val.encode("ascii") + b"\x00"
        elif ty.startswith("B"):
            if len(ty) == 2:
                sub = ty[1]
                arr = np.asarray(val, dtype=_B_DTYPE[ord(sub)])
            else:
                arr = np.asarray(val)
                sub = _DTYPE_B[arr.dtype]
            out += b"B" + sub.encode("ascii") + struct.pack("<I", arr.size) + arr.tobytes()
        else:
            raise ValueError("cannot encode tag type {!r}".format(ty))
    return bytes(out)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


# ---------------------------------------------------------------------------------------
# file objects
# ---------------------------------------------------------------------------------------


class BamReader:
    """Sequential BAM/SAM reader. ``mode`` is inferred from the file content."""

    def __init__(self, path: str, span_bytes: int | None = None):
        self.path = path
        if path.endswith(".sam"):
            self._sam = open(path, "r")
            header_lines = []
            self._pending: str | None = None
            for line in self._sam:
                if line.startswith("@"):
                    header_lines.append(line.rstrip("\n"))
                else:
                    self._pending = line
                    break
            self.header = BamHeader.from_sam_text("\n".join(header_lines) + "\n" if header_lines else "")
            self._bgzf = None
        else:
            self._sam = None
            self._bgzf = BgzfReader(path, span_bytes=span_bytes)
            magic = self._bgzf.read_exact(4)
            if magic != BAM_MAGIC:
                raise ValueError("{} is not a BAM file".format(path))
            (l_text,) = struct.unpack("<i", self._bgzf.read_exact(4))
            text = self._bgzf.read_exact(l_text).split(b"\x00")[0].decode("ascii")
            (n_ref,) = struct.unpack("<i", self._bgzf.read_exact(4))
            refs = []
            for _ in range(n_ref):
                (l_name,) = struct.unpack("<i", self._bgzf.read_exact(4))
                name = self._bgzf.read_exact(l_name)[:-1].decode("ascii")
                (l_ref,) = struct.unpack("<i", self._bgzf.read_exact(4))
                refs.append((name, l_ref))
            self.header = BamHeader(text, refs)

    def __iter__(self) -> Iterator[BamRecord]:
        if self._sam is not None:
            if self._pending is not None:
                yield _parse_sam_line(self._pending, self.header)
                self._pending = None
            for line in self._sam:
                if line.strip():
                    yield _parse_sam_line(line, self.header)
            return
        while True:
            szb = self._bgzf.read(4)
            if len(szb) == 0:
                return
            if len(szb) < 4:
                raise EOFError("truncated BAM record")
            (block_size,) = struct.unpack("<I", szb)
            buf = self._bgzf.read_exact(block_size)
            yield decode_record(buf, self.header)

    def close(self) -> None:
        if self._sam is not None:
            self._sam.close()
        if self._bgzf is not None:
            self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _parse_sam_line(line: str, header: BamHeader) -> BamRecord:
    f = line.rstrip("\n").split("\t")
    qual = None if f[10] == "*" else np.frombuffer(f[10].encode("ascii"), np.uint8) - 33
    rec = BamRecord(
        qname=f[0], flag=int(f[1]), ref_id=header.refid(f[2]) if f[2] != "*" else -1,
        pos=int(f[3]) - 1, mapq=int(f[4]), cigar=parse_cigar_string(f[5]),
        rnext_id=header.refid(f[6]) if f[6] not in ("*", "=") else (-1 if f[6] == "*" else header.refid(f[2])),
        pnext=int(f[7]) - 1, tlen=int(f[8]), seq="" if f[9] == "*" else f[9],
        qual=None if qual is None else qual.copy(),
    )
    for tagstr in f[11:]:
        tag, ty, val = tagstr.split(":", 2)
        if ty == "i":
            rec.tags.append((tag, "i", int(val)))
        elif ty == "f":
            rec.tags.append((tag, "f", float(val)))
        elif ty in ("Z", "H", "A"):
            rec.tags.append((tag, ty, val))
        elif ty == "B":
            sub = val[0]
            vals = val[2:] if len(val) > 1 and val[1] == "," else val[1:]
            arr = np.array(
                [float(x) for x in vals.split(",")] if sub == "f" else [int(x) for x in vals.split(",")],
                dtype=_B_DTYPE[ord(sub)],
            )
            rec.tags.append((tag, "B" + sub, arr))
        else:
            raise ValueError("unknown SAM tag type " + ty)
    return rec


class BamWriter:
    def __init__(self, path: str, header: BamHeader, compresslevel: int = 6,
                 span_bytes: int | None = None):
        self._bgzf = BgzfWriter(path, compresslevel, span_bytes=span_bytes)
        self.header = header
        text = header.text.encode("ascii")
        self._bgzf.write(BAM_MAGIC)
        self._bgzf.write(struct.pack("<i", len(text)))
        self._bgzf.write(text)
        self._bgzf.write(struct.pack("<i", len(header.references)))
        for name, ln in header.references:
            nb = name.encode("ascii") + b"\x00"
            self._bgzf.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))

    def write(self, rec: BamRecord) -> None:
        self._bgzf.write(encode_record(rec))

    def write_raw(self, raw: bytes) -> None:
        """Write an already-encoded record blob (no 4-byte size prefix) —
        bit-faithful pass-through for sort/merge/filter tooling."""
        self._bgzf.write(struct.pack("<I", len(raw)))
        self._bgzf.write(raw)

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _iter_raw_records(bgzf: BgzfReader) -> Iterator[bytes]:
    """Encoded record blobs (without the 4-byte block_size prefix) from a BGZF
    stream positioned at the first record."""
    while True:
        szb = bgzf.read(4)
        if len(szb) == 0:
            return
        if len(szb) < 4:
            raise EOFError("truncated BAM record")
        (block_size,) = struct.unpack("<I", szb)
        yield bgzf.read_exact(block_size)


def _raw_sort_key(raw: bytes) -> tuple[int, int]:
    # refID/pos are the first two int32s of an encoded record (SAM spec §4.2);
    # unmapped (refID -1) sorts last, matching samtools coordinate order
    ref_id, pos = struct.unpack_from("<ii", raw, 0)
    return (ref_id if ref_id >= 0 else 1 << 30, pos)


def _header_with_so_coordinate(header: BamHeader) -> BamHeader:
    """Header with @HD SO:coordinate stamped (samtools sort behavior) — lets
    downstream consumers (call_freqb streaming mode) trust the sort order."""
    lines = header.text.splitlines()
    if lines and lines[0].startswith("@HD"):
        fields = [f for f in lines[0].split("\t") if not f.startswith("SO:")]
        lines[0] = "\t".join(fields + ["SO:coordinate"])
    else:
        lines.insert(0, "@HD\tVN:1.6\tSO:coordinate")
    text = "\n".join(lines)
    if text:
        text += "\n"
    return BamHeader(text, header.references)


def sort_bam(in_path: str, out_path: str, compresslevel: int = 6,
             mem_budget_mb: int | None = 512, tmp_dir: str | None = None) -> dict:
    """Coordinate-sort a BAM by (refID, pos) — disk-backed external merge sort,
    replacing the reference's htslib-backed ``pysam.sort`` post-pass
    (ccsmeth/call_modifications.py:592-599; samtools sort -m
    semantics). Records are handled as raw encoded blobs (sort key = the
    leading refID/pos int32 pair), so record images pass through bit-unchanged
    and no decode/encode cost is paid.

    Up to ``mem_budget_mb`` of raw records are buffered; each full buffer is
    sorted (stable) and spilled as a BGZF run file, and the runs are k-way
    merged (``heapq.merge``, stable across runs created in input order) — so
    the output byte stream is IDENTICAL for any budget, including the
    no-spill in-memory fast path (``mem_budget_mb=None``). Live runs are
    consolidated (contiguous-group re-merge, stability-preserving) whenever
    they reach 64, so the merge never holds more than 64 open files no matter
    how small the budget or large the input. Returns
    ``{"records": n, "runs": k}`` — k record-buffer spills (0 = all fit in
    memory).
    """
    import heapq
    import os
    import shutil
    import tempfile

    # bound the codec spans by the budget so "sort in X MB" means the whole
    # pass (reader buffers + record buffer + writer buffers), not just the
    # record buffer
    budget0 = None if mem_budget_mb is None else max(0, int(mem_budget_mb) << 20)
    in_span = (None if budget0 is None
               else min(8 << 20, max(128 << 10, budget0 // 4)))
    # the spill writer's span coexists with the full record buffer: cap it
    # well below the record-buffer share so peak stays ~budget, not 1.5x
    w_span = None if budget0 is None else min(8 << 20,
                                              max(128 << 10, budget0 // 8))
    reader = BamReader(in_path, span_bytes=in_span)
    if reader._bgzf is None:  # SAM text input (test/tooling path): tiny, in-memory
        recs = list(reader)
        reader.close()
        recs.sort(key=lambda r: (r.ref_id if r.ref_id >= 0 else 1 << 30, r.pos))
        with BamWriter(out_path, _header_with_so_coordinate(reader.header),
                       compresslevel) as w:
            for r in recs:
                w.write(r)
        return {"records": len(recs), "runs": 0}

    # record-buffer share: whole budget minus the coexisting codec spans
    budget = (None if budget0 is None
              else max(0, budget0 - w_span - in_span))
    buf: list[bytes] = []
    buf_bytes = 0
    runs: list[str] = []
    tdir: str | None = None
    n_records = 0
    n_spills = 0   # record-buffer spills (reported as "runs")
    n_files = 0    # unique temp-file names (spills + consolidations)
    # never hold more than this many run files open at once: tiny budgets on
    # genome-scale inputs would otherwise accumulate unbounded runs and the
    # final k-way merge would hit the fd limit (EMFILE). When the live list
    # reaches the cap, consolidate it into ONE bigger run; contiguous-group
    # merging with heapq.merge (stable, ties break toward earlier iterators)
    # preserves overall input-order stability, so outputs stay byte-identical.
    max_open_runs = 64

    def _new_run_path() -> str:
        nonlocal tdir, n_files
        if tdir is None:
            tdir = tempfile.mkdtemp(
                prefix=".bamsort.",
                dir=tmp_dir or os.path.dirname(os.path.abspath(out_path)))
        rp = os.path.join(tdir, "run{:07d}.bgzf".format(n_files))
        n_files += 1
        return rp

    def consolidate() -> None:
        nonlocal runs
        rp = _new_run_path()
        run_span = min(1 << 20, max(32 << 10,
                                    (budget0 or 8 << 20) // (len(runs) + 1)))
        readers = [BgzfReader(p, span_bytes=run_span) for p in runs]
        try:
            with BgzfWriter(rp, compresslevel=1, span_bytes=w_span) as w:
                for r in heapq.merge(*(_iter_raw_records(rf) for rf in readers),
                                     key=_raw_sort_key):
                    w.write(struct.pack("<I", len(r)))
                    w.write(r)
        finally:
            for rf in readers:
                rf.close()
        for p in runs:
            os.unlink(p)
        runs = [rp]

    def spill() -> None:
        nonlocal buf, buf_bytes, n_spills
        n_spills += 1
        buf.sort(key=_raw_sort_key)
        rp = _new_run_path()
        with BgzfWriter(rp, compresslevel=1, span_bytes=w_span) as w:  # fast temps
            for r in buf:
                w.write(struct.pack("<I", len(r)))
                w.write(r)
        runs.append(rp)
        buf = []
        buf_bytes = 0
        if len(runs) >= max_open_runs:
            consolidate()

    try:
        for raw in _iter_raw_records(reader._bgzf):
            n_records += 1
            buf.append(raw)
            buf_bytes += len(raw) + 57  # + CPython bytes-object overhead
            if budget is not None and buf_bytes >= budget:
                spill()
        reader.close()
        if not runs:  # everything fit: single in-memory run, no temp IO
            buf.sort(key=_raw_sort_key)
            with BamWriter(out_path, _header_with_so_coordinate(reader.header),
                           compresslevel, span_bytes=w_span) as w:
                for r in buf:
                    w.write_raw(r)
            return {"records": n_records, "runs": 0}
        if buf:
            spill()
        run_span = min(4 << 20, max(32 << 10,
                                    (budget0 or 8 << 20) // (len(runs) + 1)))
        readers = [BgzfReader(rp, span_bytes=run_span) for rp in runs]
        try:
            with BamWriter(out_path, _header_with_so_coordinate(reader.header),
                           compresslevel, span_bytes=w_span) as w:
                for raw in heapq.merge(*(_iter_raw_records(rf) for rf in readers),
                                       key=_raw_sort_key):
                    w.write_raw(raw)
        finally:
            for rf in readers:
                rf.close()
        return {"records": n_records, "runs": n_spills}
    finally:
        if tdir is not None:
            shutil.rmtree(tdir, ignore_errors=True)


def sort_bam_in_memory(in_path: str, out_path: str, compresslevel: int = 6) -> None:
    """Single-run (never-spilling) coordinate sort; kept for small inputs and
    backward compatibility — byte-identical to sort_bam at any budget."""
    sort_bam(in_path, out_path, compresslevel, mem_budget_mb=None)

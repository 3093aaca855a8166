"""BAI index writing/reading + region fetch over BGZF virtual offsets.

Replaces pysam.index / AlignmentFile.fetch(contig, start, stop)
(ccsmeth/utils/process_utils.py:303-311,
call_mods_freq_bam.py:488). The index is built by one linear scan of the finished
BAM: BGZF block boundaries give the compressed->uncompressed offset map, records
give bin/chunk extents (UCSC binning scheme, 16kb linear index windows).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .bam import BamHeader, BamRecord, decode_record, _reg2bin
from .bgzf import BgzfReader

BAI_MAGIC = b"BAI\x01"
LINEAR_SHIFT = 14  # 16kb windows


def _scan_blocks_py(data: bytes):
    """[(coffset, csize, usize)] for each BGZF block (python fallback)."""
    out = []
    off = 0
    n = len(data)
    while off < n:
        if data[off : off + 2] != b"\x1f\x8b":
            raise ValueError("bad BGZF magic at {}".format(off))
        (xlen,) = struct.unpack_from("<H", data, off + 10)
        p = off + 12
        end = p + xlen
        bsize = None
        while p + 4 <= end:
            si1, si2 = data[p], data[p + 1]
            (slen,) = struct.unpack_from("<H", data, p + 2)
            if si1 == 66 and si2 == 67 and slen == 2:
                (bs,) = struct.unpack_from("<H", data, p + 4)
                bsize = bs + 1
            p += 4 + slen
        if bsize is None:
            raise ValueError("BGZF BC subfield missing")
        (isize,) = struct.unpack_from("<I", data, off + bsize - 4)
        out.append((off, bsize, isize))
        off += bsize
    return out


def scan_blocks(data: bytes):
    try:
        from .native import _load

        lib = _load()
        if lib is not None:
            import ctypes

            max_blocks = len(data) // 28 + 2
            offsets = (ctypes.c_ulonglong * max_blocks)()
            csizes = (ctypes.c_uint * max_blocks)()
            usizes = (ctypes.c_uint * max_blocks)()
            n = lib.bgzf_scan_blocks(data, len(data), offsets, csizes, usizes,
                                     max_blocks)
            if n > 0:
                return [(int(offsets[i]), int(csizes[i]), int(usizes[i]))
                        for i in range(n)]
    except Exception:  # noqa: BLE001
        pass
    return _scan_blocks_py(data)


class _RefIndex:
    def __init__(self):
        self.bins: dict[int, list[tuple[int, int]]] = {}
        self.linear: dict[int, int] = {}  # window -> min voffset

    def add(self, rec: BamRecord, v_start: int, v_end: int) -> None:
        end = rec.reference_end if rec.cigar else rec.pos + 1
        bin_ = _reg2bin(rec.pos, max(end, rec.pos + 1))
        chunks = self.bins.setdefault(bin_, [])
        if chunks and chunks[-1][1] == v_start:
            chunks[-1] = (chunks[-1][0], v_end)
        else:
            chunks.append((v_start, v_end))
        for w in range(rec.pos >> LINEAR_SHIFT, ((max(end, rec.pos + 1) - 1)
                                                 >> LINEAR_SHIFT) + 1):
            if w not in self.linear or v_start < self.linear[w]:
                self.linear[w] = v_start


def build_index(bam_path: str, bai_path: str | None = None,
                span_bytes: int = 8 << 20) -> str:
    """Linear-scan the BAM, emit .bai. Requires coordinate-sorted input.

    TRUE streaming build (the htslib ``samtools index`` behavior being
    replaced): compressed bytes are read ``span_bytes`` at a time, framed
    into complete BGZF blocks, parallel-decompressed by the native codec,
    and both the decompressed window and the block-offset tables are
    trimmed as records are consumed — peak memory is ~a few spans no
    matter the BAM size (gated by
    tests/test_bai.py::test_build_index_streams_bounded_memory).
    """
    import bisect

    if bai_path is None:
        bai_path = bam_path + ".bai"

    from .native import decompress_bgzf_bytes, native_available

    use_native = native_available()
    fh = open(bam_path, "rb")
    tail = b""         # partial compressed block carried between spans
    csize_done = 0     # absolute compressed offset of tail[0]
    coffsets: list[int] = []  # per retained block: absolute compressed offset
    cum_u: list[int] = []     # per retained block: absolute uncompressed start
    u_total = 0        # uncompressed bytes decoded so far
    eof_c = [None]     # total compressed size, known at stream end

    def next_span() -> bytes | None:
        """Decompress the next batch of complete blocks, appending their
        offsets to the (windowed) block tables."""
        nonlocal tail, csize_done, u_total
        while True:
            # drain a tail that already frames complete blocks before
            # reading more — else on highly compressible BAMs (where the
            # decompressed-size cut below leaves most of the span unread)
            # the carry grows toward O(compressed file) resident (the block
            # framer is the shared BGZF one, bgzf.py _complete_prefix_len)
            if tail and BgzfReader._complete_prefix_len(
                    tail, 4 * span_bytes) > 0:
                chunk = tail
            else:
                chunk = tail + fh.read(span_bytes)
            tail = b""
            if not chunk:
                eof_c[0] = csize_done
                return None
            off = 0
            n = len(chunk)
            dec = 0  # decompressed bytes this span will materialize
            new_blocks = []
            while off + 18 <= n:
                if chunk[off:off + 2] != b"\x1f\x8b":
                    raise ValueError("bad BGZF magic at {}".format(
                        csize_done + off))
                (xlen,) = struct.unpack_from("<H", chunk, off + 10)
                if off + 12 + xlen > n:
                    break
                bsize = None
                p_ = off + 12
                end_ = p_ + xlen
                while p_ + 4 <= end_:
                    if chunk[p_] == 66 and chunk[p_ + 1] == 67:
                        (bs,) = struct.unpack_from("<H", chunk, p_ + 4)
                        bsize = bs + 1
                    p_ += 4 + struct.unpack_from("<H", chunk, p_ + 2)[0]
                if bsize is None:
                    raise ValueError("BGZF BC subfield missing")
                if off + bsize > n:
                    break
                (isize,) = struct.unpack_from("<I", chunk, off + bsize - 4)
                # cap the span's DECOMPRESSED size at 4x its compressed size
                # so a highly compressible BAM (BGZF ratios reach ~650x on
                # low-complexity runs) can't materialize far past the
                # documented ~span-sized window in one decompress call
                if off > 0 and dec + isize > 4 * span_bytes:
                    break
                dec += isize
                new_blocks.append((csize_done + off, isize))
                off += bsize
            if off == 0:  # span smaller than one block: grow it
                more = fh.read(span_bytes)
                if not more:
                    eof_c[0] = csize_done + len(chunk)
                    return None
                tail = chunk + more
                continue
            span = chunk[:off]
            tail = chunk[off:]
            csize_done += off
            data = decompress_bgzf_bytes(span) if use_native else None
            if data is None:
                data = b""
                doff = 0
                while doff < len(span):
                    one, doff = _decompress_one(span, doff)
                    data += one
            for coff, isz in new_blocks:
                coffsets.append(coff)
                cum_u.append(u_total)
                u_total += isz
            if len(data) == 0:  # EOF-marker-only span
                continue
            return data

    def voffset(u: int) -> int:
        i = bisect.bisect_right(cum_u, u) - 1
        if i < 0 or (i == len(cum_u) - 1 and u >= u_total and u > cum_u[i]):
            # at/after the last decoded byte: EOF virtual offset
            return (eof_c[0] if eof_c[0] is not None else csize_done) << 16
        return (coffsets[i] << 16) | (u - cum_u[i])

    data = next_span() or b""

    def ensure(n_needed: int) -> bool:
        """Extend `data` (trimmed at `base`) until it holds n_needed bytes past p."""
        nonlocal data
        while len(data) < n_needed:
            nxt = next_span()
            if nxt is None:
                return False
            data = data + nxt
        return True

    # parse header (rolling window: `base` = absolute offset of data[0])
    base = 0
    ensure(8)
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    (l_text,) = struct.unpack_from("<i", data, 4)
    ensure(8 + l_text + 4)
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, p)
    p += 4
    for _ in range(n_ref):
        ensure(p + 8)
        (l_name,) = struct.unpack_from("<i", data, p)
        ensure(p + 8 + l_name)
        p += 4 + l_name + 4
    header = BamHeader("", [("x", 1)] * n_ref)

    ref_indices = [_RefIndex() for _ in range(n_ref)]
    n_unmapped = 0
    last_rid = -2
    _last_pos = -1
    while True:
        # trim consumed prefix (and the block tables behind it) to keep the
        # resident window at ~span scale
        if p > (2 << 20):
            data = data[p:]
            base += p
            p = 0
            k = bisect.bisect_right(cum_u, base) - 1
            if k > 0:
                del coffsets[:k]
                del cum_u[:k]
        if not ensure(p + 4):
            break
        (block_size,) = struct.unpack_from("<I", data, p)
        rec_start = p
        rec_end = p + 4 + block_size
        if not ensure(rec_end):
            break
        rec = decode_record(data[p + 4 : rec_end], header)
        if rec.ref_id >= 0 and not rec.is_unmapped:
            if rec.ref_id < last_rid or (rec.ref_id == last_rid and rec.pos < _last_pos):
                raise ValueError("BAM is not coordinate-sorted; sort before indexing")
            ref_indices[rec.ref_id].add(rec, voffset(base + rec_start),
                                        voffset(base + rec_end))
            last_rid = rec.ref_id
            _last_pos = rec.pos
        else:
            n_unmapped += 1
        p = rec_end

    fh.close()
    with open(bai_path, "wb") as wf:
        wf.write(BAI_MAGIC)
        wf.write(struct.pack("<i", n_ref))
        for ri in ref_indices:
            wf.write(struct.pack("<i", len(ri.bins)))
            for bin_ in sorted(ri.bins):
                chunks = ri.bins[bin_]
                wf.write(struct.pack("<Ii", bin_, len(chunks)))
                for s, e in chunks:
                    wf.write(struct.pack("<QQ", s, e))
            if ri.linear:
                n_win = max(ri.linear) + 1
                lin = np.zeros(n_win, dtype=np.uint64)
                filled = np.zeros(n_win, dtype=bool)
                for w, v in sorted(ri.linear.items()):
                    lin[w] = v
                    filled[w] = True
                # fill gaps with previous value (htslib convention)
                prev = 0
                for w in range(n_win):
                    if filled[w]:
                        prev = lin[w]
                    else:
                        lin[w] = prev
                wf.write(struct.pack("<i", n_win))
                wf.write(lin.tobytes())
            else:
                wf.write(struct.pack("<i", 0))
    return bai_path


def _decompress_one(raw: bytes, off: int):
    (xlen,) = struct.unpack_from("<H", raw, off + 10)
    p = off + 12
    end = p + xlen
    bsize = None
    while p + 4 <= end:
        si1, si2 = raw[p], raw[p + 1]
        (slen,) = struct.unpack_from("<H", raw, p + 2)
        if si1 == 66 and si2 == 67 and slen == 2:
            (bs,) = struct.unpack_from("<H", raw, p + 4)
            bsize = bs + 1
        p += 4 + slen
    cdata = raw[off + 12 + xlen : off + bsize - 8]
    return zlib.decompress(cdata, wbits=-15), off + bsize


def _reg2bins(beg: int, end: int) -> list[int]:
    """All bins overlapping [beg, end) (SAM spec)."""
    bins = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


class BaiIndex:
    def __init__(self, bai_path: str):
        with open(bai_path, "rb") as f:
            data = f.read()
        if data[:4] != BAI_MAGIC:
            raise ValueError("not a BAI file")
        (self.n_ref,) = struct.unpack_from("<i", data, 4)
        p = 8
        self.refs = []
        for _ in range(self.n_ref):
            (n_bin,) = struct.unpack_from("<i", data, p)
            p += 4
            bins = {}
            for _ in range(n_bin):
                bin_, n_chunk = struct.unpack_from("<Ii", data, p)
                p += 8
                chunks = []
                for _ in range(n_chunk):
                    s, e = struct.unpack_from("<QQ", data, p)
                    p += 16
                    chunks.append((s, e))
                bins[bin_] = chunks
            (n_intv,) = struct.unpack_from("<i", data, p)
            p += 4
            linear = np.frombuffer(data, dtype=np.uint64, count=n_intv, offset=p)
            p += 8 * n_intv
            self.refs.append((bins, linear))

    def chunks_for(self, rid: int, beg: int, end: int) -> list[tuple[int, int]]:
        if rid < 0 or rid >= len(self.refs):
            return []
        bins, linear = self.refs[rid]
        min_v = 0
        w = beg >> LINEAR_SHIFT
        if len(linear) > 0:
            min_v = int(linear[min(w, len(linear) - 1)])
        chunks = []
        for b in _reg2bins(beg, end):
            for s, e in bins.get(b, ()):
                if e > min_v:
                    chunks.append((max(s, min_v), e))
        chunks.sort()
        # merge overlapping/adjacent
        merged = []
        for s, e in chunks:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged


def fetch_region(bam_path: str, contig: str, start: int, stop: int,
                 bai_path: str | None = None):
    """Yield BamRecords overlapping [start, stop) using the .bai random-access
    index (builds the index on demand for a sorted BAM)."""
    yield from fetch_scoped(bam_path, {contig: [(start, stop)]},
                            bai_path=bai_path, build=True)


def fetch_scoped(bam_path: str, scope: dict[str, list[tuple[int, int]]],
                 bai_path: str | None = None, build: bool = False):
    """Yield BamRecords overlapping any [start, stop) span of any scoped
    contig, via the .bai index — each record exactly ONCE per contig even
    when it straddles several spans (virtual-offset dedup is shared across
    that contig's spans). Contigs are visited in reference order; within a
    contig records come back in coordinate order per span, so site
    accumulation (order-independent) can consume this directly.

    With build=False (the default) a missing .bai raises FileNotFoundError
    instead of building one — concurrent share-nothing processes must not
    race to write the same index file."""
    if bai_path is None:
        bai_path = bam_path + ".bai"
    if not os.path.exists(bai_path):
        if not build:
            raise FileNotFoundError(bai_path)
        build_index(bam_path, bai_path)
    reader = BamReaderHeaderOnly(bam_path)
    header = reader.header
    rids = []
    for contig in scope:
        try:
            rids.append((header.refid(contig), contig))
        except KeyError:
            continue
    idx = BaiIndex(bai_path)
    fh = open(bam_path, "rb")
    try:
        for rid, contig in sorted(rids):
            seen_starts: set = set()
            for start, stop in sorted(scope[contig]):
                chunks = idx.chunks_for(rid, start, stop)
                if not chunks:
                    continue
                yield from _iter_chunks(fh, chunks, header, rid, start, stop,
                                        seen_starts)
    finally:
        fh.close()


def _iter_chunks(fh, chunks, header, rid, start, stop, seen_starts):
    fh.seek(0, 2)
    file_size = fh.tell()
    for v_s, v_e in chunks:
        c_s, u_s = v_s >> 16, v_s & 0xFFFF
        c_e = v_e >> 16
        # read+decompress only blocks [c_s .. c_e] via seeks (a record may
        # straddle into the block at c_e) — never the whole file
        buf = bytearray()
        block_starts = []  # (coffset, uncompressed offset within buf)
        off = c_s
        while off < file_size:
            block_starts.append((off, len(buf)))
            fh.seek(off)
            head = fh.read(18)
            if len(head) < 18:
                break
            (xlen,) = struct.unpack_from("<H", head, 10)
            extra = head[12:18] + (fh.read(xlen - 6) if xlen > 6 else b"")
            bsize = None
            q = 0
            while q + 4 <= len(extra):
                if extra[q] == 66 and extra[q + 1] == 67:
                    (bsize,) = struct.unpack_from("<H", extra, q + 4)
                    bsize += 1
                q += 4 + struct.unpack_from("<H", extra, q + 2)[0]
            if bsize is None:
                raise ValueError("BGZF BC subfield missing")
            fh.seek(off)
            raw_block = fh.read(bsize)
            payload, _ = _decompress_one(raw_block, 0)
            buf += payload
            if off >= c_e:
                break
            off += bsize
        data = bytes(buf)
        co_arr = [b[0] for b in block_starts]
        uo_arr = [b[1] for b in block_starts]
        import bisect

        p = u_s
        while p + 4 <= len(data):
            bi = bisect.bisect_right(uo_arr, p) - 1
            rec_voffset = (co_arr[bi] << 16) | (p - uo_arr[bi])
            if rec_voffset >= v_e:
                break
            (block_size,) = struct.unpack_from("<I", data, p)
            if p + 4 + block_size > len(data):
                break
            rec_p = p
            p += 4 + block_size
            if rec_voffset in seen_starts:
                continue  # chunk/span overlap dedup
            rec = decode_record(data[rec_p + 4 : rec_p + 4 + block_size], header)
            if rec.ref_id != rid or rec.is_unmapped:
                continue
            if rec.pos >= stop:
                break
            if rec.reference_end > start:
                # mark seen only on YIELD: a record decoded inside this span's
                # chunk range but overlapping a LATER span must not be
                # swallowed when seen_starts is shared across spans
                seen_starts.add(rec_voffset)
                yield rec


class BamReaderHeaderOnly:
    """Parse just the BAM header (for refid lookup in fetch)."""

    def __init__(self, path: str):
        bg = BgzfReader(path, use_native=False)
        magic = bg.read_exact(4)
        if magic != b"BAM\x01":
            raise ValueError("not a BAM file")
        (l_text,) = struct.unpack("<i", bg.read_exact(4))
        text = bg.read_exact(l_text).split(b"\x00")[0].decode("ascii")
        (n_ref,) = struct.unpack("<i", bg.read_exact(4))
        refs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", bg.read_exact(4))
            name = bg.read_exact(l_name)[:-1].decode("ascii")
            (l_ref,) = struct.unpack("<i", bg.read_exact(4))
            refs.append((name, l_ref))
        bg.close()
        self.header = BamHeader(text, refs)


def index_bam_if_needed(bam_path: str) -> str | None:
    """pysam.index analog (process_utils.py:303-311): build .bai when absent."""
    if not bam_path.endswith(".bam"):
        return None
    bai = bam_path + ".bai"
    if not os.path.exists(bai):
        build_index(bam_path, bai)
    return bai

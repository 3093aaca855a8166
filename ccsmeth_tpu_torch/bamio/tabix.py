"""TBI (tabix) index writing + region query for BGZF-compressed TSV/bed files.

Replaces pysam.tabix_index / pytabix queries (reference call_mods_freq_bam.py:674,
_bam2modbam.py:85-93,154-177). Same UCSC binning scheme as BAI with a tabix
header (format flags, column numbers, sequence-name dictionary).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .bai import LINEAR_SHIFT, _decompress_one, _reg2bins, scan_blocks
from .bam import _reg2bin

TBI_MAGIC = b"TBI\x01"

PRESET_BED = dict(format=0x10000, col_seq=1, col_beg=2, col_end=3, meta=ord("#"),
                  skip=0)
PRESET_GENERIC_0BASED = dict(format=0x10000, col_seq=1, col_beg=2, col_end=0,
                             meta=ord("#"), skip=0)


def build_tabix_index(path: str, preset: dict | None = None,
                      tbi_path: str | None = None) -> str:
    """Index a coordinate-sorted, bgzipped, tab-separated file."""
    if preset is None:
        preset = PRESET_BED
    if tbi_path is None:
        tbi_path = path + ".tbi"
    with open(path, "rb") as f:
        raw = f.read()
    blocks = scan_blocks(raw)
    coffsets = np.array([b[0] for b in blocks], dtype=np.int64)
    cum_u = np.zeros(len(blocks) + 1, dtype=np.int64)
    cum_u[1:] = np.cumsum([b[2] for b in blocks])

    def voffset(u: int) -> int:
        i = int(np.searchsorted(cum_u, u, side="right")) - 1
        i = min(i, len(coffsets) - 1)
        return (int(coffsets[i]) << 16) | int(u - cum_u[i])

    from .native import decompress_bgzf_bytes

    data = decompress_bgzf_bytes(raw)
    if data is None:
        data = b"".join(_decompress_one(raw, b[0])[0] for b in blocks)

    names: list[str] = []
    name2id: dict[str, int] = {}
    per_ref: list[tuple[dict, dict]] = []  # (bins, linear)
    c_seq = preset["col_seq"] - 1
    c_beg = preset["col_beg"] - 1
    c_end = preset["col_end"] - 1 if preset["col_end"] > 0 else -1
    meta = preset["meta"]
    pos = 0
    n = len(data)
    prev = (-1, -1)
    while pos < n:
        nl = data.find(b"\n", pos)
        if nl < 0:
            nl = n
        line = data[pos:nl]
        v_start = voffset(pos)
        v_end = voffset(nl + 1)
        pos = nl + 1
        if not line or line[0] == meta:
            continue
        w = line.split(b"\t")
        seq = w[c_seq].decode()
        beg = int(w[c_beg])
        end = int(w[c_end]) if c_end >= 0 else beg + 1
        if seq not in name2id:
            name2id[seq] = len(names)
            names.append(seq)
            per_ref.append(({}, {}))
        rid = name2id[seq]
        if (rid, beg) < prev and rid == prev[0]:
            raise ValueError("file is not coordinate-sorted; sort before indexing")
        prev = (rid, beg)
        bins, linear = per_ref[rid]
        b = _reg2bin(beg, max(end, beg + 1))
        chunks = bins.setdefault(b, [])
        if chunks and chunks[-1][1] == v_start:
            chunks[-1] = (chunks[-1][0], v_end)
        else:
            chunks.append((v_start, v_end))
        for wdw in range(beg >> LINEAR_SHIFT, ((max(end, beg + 1) - 1)
                                               >> LINEAR_SHIFT) + 1):
            if wdw not in linear or v_start < linear[wdw]:
                linear[wdw] = v_start

    from .bgzf import BgzfWriter

    name_blob = b"".join(nm.encode() + b"\x00" for nm in names)
    with BgzfWriter(tbi_path) as wf:
        wf.write(TBI_MAGIC)
        wf.write(struct.pack("<8i", len(names), preset["format"], preset["col_seq"],
                             preset["col_beg"], preset["col_end"], preset["meta"],
                             preset["skip"], len(name_blob)))
        wf.write(name_blob)
        for bins, linear in per_ref:
            wf.write(struct.pack("<i", len(bins)))
            for b in sorted(bins):
                chunks = bins[b]
                wf.write(struct.pack("<Ii", b, len(chunks)))
                for s, e in chunks:
                    wf.write(struct.pack("<QQ", s, e))
            if linear:
                n_win = max(linear) + 1
                lin = np.zeros(n_win, dtype=np.uint64)
                prev_v = 0
                for wdw in range(n_win):
                    if wdw in linear:
                        prev_v = linear[wdw]
                    lin[wdw] = prev_v
                wf.write(struct.pack("<i", n_win))
                wf.write(lin.tobytes())
            else:
                wf.write(struct.pack("<i", 0))
    return tbi_path


class TabixFile:
    """Minimal tabix reader: query(seq, beg, end) -> line strings."""

    def __init__(self, path: str, tbi_path: str | None = None):
        self.path = path
        if tbi_path is None:
            tbi_path = path + ".tbi"
        if not os.path.exists(tbi_path):
            build_tabix_index(path, tbi_path=tbi_path)
        from .bgzf import BgzfReader

        rf = BgzfReader(tbi_path, use_native=False)
        data = rf.read()
        rf.close()
        if data[:4] != TBI_MAGIC:
            raise ValueError("not a TBI file")
        (n_ref, fmt, c_seq, c_beg, c_end, meta, skip, l_nm) = struct.unpack_from(
            "<8i", data, 4)
        self.preset = dict(format=fmt, col_seq=c_seq, col_beg=c_beg, col_end=c_end,
                           meta=meta, skip=skip)
        p = 36
        names = data[p : p + l_nm].split(b"\x00")[:-1]
        self.name2id = {nm.decode(): i for i, nm in enumerate(names)}
        p += l_nm
        self.refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, p)
            p += 4
            bins = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", data, p)
                p += 8
                chunks = []
                for _ in range(n_chunk):
                    s, e = struct.unpack_from("<QQ", data, p)
                    p += 16
                    chunks.append((s, e))
                bins[b] = chunks
            (n_intv,) = struct.unpack_from("<i", data, p)
            p += 4
            linear = np.frombuffer(data, dtype=np.uint64, count=n_intv, offset=p)
            p += 8 * n_intv
            self.refs.append((bins, linear))
        with open(path, "rb") as f:
            self._raw = f.read()

    def query(self, seq: str, beg: int, end: int):
        rid = self.name2id.get(seq)
        if rid is None:
            return
        bins, linear = self.refs[rid]
        min_v = int(linear[min(beg >> LINEAR_SHIFT, len(linear) - 1)]) if len(linear) else 0
        chunks = []
        for b in _reg2bins(beg, end):
            for s, e in bins.get(b, ()):
                if e > min_v:
                    chunks.append((max(s, min_v), e))
        chunks.sort()
        merged = []
        for s, e in chunks:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        c_seq = self.preset["col_seq"] - 1
        c_beg = self.preset["col_beg"] - 1
        c_end = self.preset["col_end"] - 1 if self.preset["col_end"] > 0 else -1
        import bisect

        seen_voffsets = set()
        for v_s, v_e in merged:
            c_s, u_s = v_s >> 16, v_s & 0xFFFF
            c_e = v_e >> 16
            buf = bytearray()
            block_starts = []  # (coffset, uncompressed offset within buf)
            off = c_s
            while off < len(self._raw):
                block_starts.append((off, len(buf)))
                payload, off2 = _decompress_one(self._raw, off)
                buf += payload
                if off >= c_e:
                    break
                off = off2
            data = bytes(buf)
            co_arr = [b[0] for b in block_starts]
            uo_arr = [b[1] for b in block_starts]
            p = u_s
            while p < len(data):
                bi = bisect.bisect_right(uo_arr, p) - 1
                line_voffset = (co_arr[bi] << 16) | (p - uo_arr[bi])
                nl = data.find(b"\n", p)
                if nl < 0:
                    break
                line = data[p:nl]
                p = nl + 1
                if not line or line[0] == self.preset["meta"]:
                    continue
                w = line.split(b"\t")
                if w[c_seq].decode() != seq:
                    continue
                lb = int(w[c_beg])
                le = int(w[c_end]) if c_end >= 0 else lb + 1
                if lb >= end:
                    break
                if line_voffset in seen_voffsets:
                    continue  # chunk-overlap dedup (identity = file position)
                seen_voffsets.add(line_voffset)
                if le > beg:
                    yield line.decode()

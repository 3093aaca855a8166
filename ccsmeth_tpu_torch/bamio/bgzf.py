"""BGZF (blocked gzip) codec.

First-party implementation (this environment has no pysam/htslib). BGZF is a series
of standard gzip members, each <=64KiB uncompressed, carrying a BC extra subfield with
the compressed block size; the file ends with a fixed 28-byte EOF member. The blocks
are independent, which the native multithreaded codec (native/bgzf_mt.cpp) exploits;
this module is the portable fallback and the file-format authority.

Replaces the reference's reliance on pysam/htslib for BAM byte streams
(ccsmeth/extract_features.py:60-73 etc.).
"""

from __future__ import annotations

import io
import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
_MAX_BLOCK_DATA = 65280  # uncompressed payload per block (htslib convention)


def _parse_block_header(buf: bytes, off: int) -> tuple[int, int]:
    """Return (xlen, bsize) for the gzip member starting at ``off``."""
    if buf[off : off + 2] != b"\x1f\x8b":
        raise ValueError("not a gzip/BGZF stream (bad magic)")
    flg = buf[off + 3]
    if not flg & 4:
        raise ValueError("gzip member without FEXTRA: not BGZF")
    (xlen,) = struct.unpack_from("<H", buf, off + 10)
    # scan extra subfields for BC
    p = off + 12
    end = p + xlen
    bsize = None
    while p + 4 <= end:
        si1, si2, slen = buf[p], buf[p + 1], struct.unpack_from("<H", buf, p + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:  # 'B','C'
            bsize = struct.unpack_from("<H", buf, p + 4)[0] + 1
        p += 4 + slen
    if bsize is None:
        raise ValueError("BGZF BC subfield missing")
    return xlen, bsize


def decompress_block(buf: bytes, off: int) -> tuple[bytes, int]:
    """Decompress one BGZF block at byte offset ``off``; returns (data, next_off)."""
    xlen, bsize = _parse_block_header(buf, off)
    cdata_start = off + 12 + xlen
    cdata_end = off + bsize - 8
    data = zlib.decompress(buf[cdata_start:cdata_end], wbits=-15)
    return data, off + bsize


class BgzfReader(io.RawIOBase):
    """Streaming BGZF reader over a file path or binary file object.

    Also transparently reads plain (non-blocked) gzip and uncompressed files, since
    the feature-TSV paths accept .gz inputs.
    """

    # compressed bytes pulled per native parallel-decompress span; bounds resident
    # memory to ~4x this while keeping the thread pool fed
    NATIVE_SPAN = 32 << 20

    def __init__(self, source, use_native: bool = True,
                 span_bytes: int | None = None):
        if isinstance(source, (str, bytes)):
            self._fh = open(source, "rb")
            self._own = True
        else:
            self._fh = source
            self._own = False
        # per-span compressed read size: callers that must bound resident
        # memory (e.g. the external merge sort's many run readers) shrink it
        self._span = int(span_bytes) if span_bytes else self.NATIVE_SPAN
        self._buf = b""
        self._buf_pos = 0
        self._block_start = 0  # file offset of current block
        self._eof = False
        self._native = None
        self._tail = b""  # partial trailing block carried between native spans
        head = self._fh.read(18)
        self._fh.seek(0)
        if head[:2] != b"\x1f\x8b":
            self._plain = True  # raw uncompressed
        elif len(head) >= 18 and (head[3] & 4) and head[12:14] == b"BC":
            self._plain = False  # BGZF
            if use_native:
                try:
                    from .native import decompress_bgzf_bytes, native_available

                    if native_available():
                        self._native = decompress_bgzf_bytes
                except Exception:  # noqa: BLE001
                    self._native = None
        else:
            # plain (non-blocked) gzip: wrap with stdlib streaming decompressor
            import gzip as _gzip

            self._fh = _gzip.GzipFile(fileobj=self._fh)
            self._plain = True

    @staticmethod
    def _complete_prefix_len(chunk: bytes, max_decompressed: int | None = None
                             ) -> int:
        """Byte length of the whole BGZF blocks at the start of ``chunk``.

        ``max_decompressed`` additionally cuts the span once the blocks'
        cumulative ISIZE (each block's uncompressed size, gzip trailer)
        would exceed it — bounding resident memory even for pathologically
        compressible streams (a BGZF block is <=64 KiB decompressed but can
        be ~100 compressed bytes, so compressed-span size alone bounds
        nothing). At least one block is always accepted."""
        off = 0
        n = len(chunk)
        decompressed = 0
        while off + 18 <= n:
            if chunk[off : off + 2] != b"\x1f\x8b":
                break
            (xlen,) = struct.unpack_from("<H", chunk, off + 10)
            if off + 12 + xlen > n:
                break
            bsize = None
            p = off + 12
            end = p + xlen
            while p + 4 <= end:
                si1, si2 = chunk[p], chunk[p + 1]
                (slen,) = struct.unpack_from("<H", chunk, p + 2)
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack_from("<H", chunk, p + 4)[0] + 1
                p += 4 + slen
            if bsize is None or off + bsize > n:
                break
            (isize,) = struct.unpack_from("<I", chunk, off + bsize - 4)
            if (max_decompressed is not None and off > 0
                    and decompressed + isize > max_decompressed):
                break
            decompressed += isize
            off += bsize
        return off

    def _fill_native(self) -> bool:
        """Pull a span of compressed bytes and parallel-decompress its complete
        blocks; the split tail block carries into the next span."""
        while True:
            # Cap the span's DECOMPRESSED size at 4x its compressed size so
            # a highly compressible stream can't blow resident memory past
            # the documented ~4x-span bound; and when that cap left a tail
            # that already frames complete blocks, drain it before reading
            # more — otherwise on ratios > 4x the tail grows by
            # ~span*(1-4/ratio) per refill, i.e. O(compressed file) resident
            # (advisor r4 finding, reproduced on an all-zeros stream).
            max_dec = 4 * self._span
            cut = self._complete_prefix_len(self._tail, max_dec) \
                if self._tail else 0
            if cut > 0:
                chunk = self._tail
            else:
                chunk = self._tail + self._fh.read(self._span)
                cut = self._complete_prefix_len(chunk, max_dec)
            self._tail = b""
            if not chunk:
                self._eof = True
                return False
            while cut == 0:
                # span smaller than one compressed block: grow until a whole
                # block frames (keeps small memory-capped spans streaming
                # instead of falling back to a slurp-everything python path)
                more = self._fh.read(self._span)
                if not more:
                    break
                chunk += more
                cut = self._complete_prefix_len(chunk, max_dec)
            if cut == 0:
                # can't frame a single block natively -> permanent python path
                self._pushback(chunk)
                self._native = None
                return self._fill()
            self._tail = chunk[cut:]
            data = self._native(chunk[:cut])
            if data is None:
                self._pushback(chunk)
                self._native = None
                return self._fill()
            if len(data) == 0:  # EOF marker block(s) only
                continue
            self._buf = data
            self._buf_pos = 0
            return True

    def _pushback(self, chunk: bytes) -> None:
        import io as _io

        rest = self._fh.read()
        self._fh = _io.BytesIO(chunk + rest)

    # -- internals ---------------------------------------------------------------
    def _fill(self) -> bool:
        if self._eof:
            return False
        if not self._plain and self._native is not None:
            return self._fill_native()
        if self._plain:
            chunk = self._fh.read(1 << 20)
            if not chunk:
                self._eof = True
                return False
            self._buf = chunk
            self._buf_pos = 0
            return True
        # read one BGZF block
        self._block_start = self._fh.tell()
        header = self._fh.read(18)
        if len(header) == 0:
            self._eof = True
            return False
        if len(header) < 18:
            raise ValueError("truncated BGZF block header")
        if header[:2] != b"\x1f\x8b":
            raise ValueError("bad BGZF magic mid-stream")
        (xlen,) = struct.unpack_from("<H", header, 10)
        extra = header[12:18]
        if xlen > 6:
            extra += self._fh.read(xlen - 6)
        p, bsize = 0, None
        while p + 4 <= len(extra):
            si1, si2, slen = extra[p], extra[p + 1], struct.unpack_from("<H", extra, p + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, p + 4)[0] + 1
            p += 4 + slen
        if bsize is None:
            raise ValueError("BGZF BC subfield missing")
        cdata_len = bsize - 12 - xlen - 8
        cdata = self._fh.read(cdata_len)
        self._fh.read(8)  # crc32 + isize
        data = zlib.decompress(cdata, wbits=-15)
        if len(data) == 0:  # EOF block
            return self._fill()
        self._buf = data
        self._buf_pos = 0
        return True

    # -- public ------------------------------------------------------------------
    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            chunks = [self._buf[self._buf_pos :]]
            self._buf = b""
            self._buf_pos = 0
            while self._fill():
                chunks.append(self._buf)
                self._buf = b""
            return b"".join(chunks)
        out = bytearray()
        while n > 0:
            avail = len(self._buf) - self._buf_pos
            if avail == 0:
                if not self._fill():
                    break
                continue
            take = min(avail, n)
            out += self._buf[self._buf_pos : self._buf_pos + take]
            self._buf_pos += take
            n -= take
        return bytes(out)

    def readinto(self, b) -> int:
        # RawIOBase does not derive readinto from read(); io.BufferedReader
        # (the open_text_auto stack) drives the raw stream through this.
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def read_exact(self, n: int) -> bytes:
        data = self.read(n)
        if len(data) != n:
            raise EOFError("unexpected EOF in BGZF stream")
        return data

    def close(self) -> None:
        if self._own:
            self._fh.close()
        super().close()


class BgzfWriter(io.RawIOBase):
    """Streaming BGZF writer (gzip members <=64KiB with BC subfield + EOF marker).

    With the native codec present, payload accumulates into multi-megabyte spans
    compressed in parallel; otherwise blocks flush one-by-one through zlib.
    """

    # always a multiple of _MAX_BLOCK_DATA: every full block then carries
    # exactly 65280 payload bytes, so the compressed byte stream is identical
    # for ANY span size (memory-capped writers shrink it without changing
    # the output bytes)
    NATIVE_SPAN = 128 * _MAX_BLOCK_DATA  # ~8 MB

    def __init__(self, sink, compresslevel: int = 6, use_native: bool = True,
                 span_bytes: int | None = None):
        if isinstance(sink, (str, bytes)):
            self._fh = open(sink, "wb")
            self._own = True
        else:
            self._fh = sink
            self._own = False
        self._level = compresslevel
        if span_bytes:  # bound buffered payload for memory-capped writers
            self.NATIVE_SPAN = max(
                int(span_bytes) // _MAX_BLOCK_DATA, 1) * _MAX_BLOCK_DATA
        self._buf = bytearray()
        self._native = None
        if use_native:
            try:
                from .native import compress_bgzf_bytes, native_available

                if native_available():
                    self._native = compress_bgzf_bytes
            except Exception:  # noqa: BLE001
                self._native = None

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        self._buf += data
        if self._native is not None:
            while len(self._buf) >= self.NATIVE_SPAN:
                span = bytes(self._buf[: self.NATIVE_SPAN])
                del self._buf[: self.NATIVE_SPAN]
                out = self._native(span, self._level)
                if out is None:  # native failure -> permanent python fallback
                    self._native = None
                    self._buf[:0] = span
                    break
                self._fh.write(out)
        while self._native is None and len(self._buf) >= _MAX_BLOCK_DATA:
            self._flush_block(bytes(self._buf[:_MAX_BLOCK_DATA]))
            del self._buf[:_MAX_BLOCK_DATA]
        return len(data)

    def _flush_block(self, data: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(data) + co.flush()
        bsize = len(cdata) + 12 + 6 + 8
        if bsize > 65536:
            # incompressible data: store with level 0
            co = zlib.compressobj(0, zlib.DEFLATED, -15)
            cdata = co.compress(data) + co.flush()
            bsize = len(cdata) + 12 + 6 + 8
        header = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC"
            + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
        )
        trailer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF)
        self._fh.write(header + cdata + trailer)

    def close(self) -> None:
        if self.closed:
            return
        if len(self._buf):
            data = bytes(self._buf)
            self._buf.clear()
            out = self._native(data, self._level) if self._native is not None else None
            if out is not None:
                self._fh.write(out)
            else:
                for i in range(0, len(data), _MAX_BLOCK_DATA):
                    self._flush_block(data[i : i + _MAX_BLOCK_DATA])
        self._fh.write(BGZF_EOF)
        if self._own:
            self._fh.close()
        super().close()


def open_text_auto(path: str) -> io.TextIOWrapper:
    """Text reader for plain, gzip, or BGZF files.

    BGZF inputs (e.g. this engine's own .gz TSV outputs) decompress through the
    native parallel codec; plain single-member gzip (the reference's output
    style, extract_features.py:520) streams through stdlib zlib.
    """
    return io.TextIOWrapper(io.BufferedReader(BgzfReader(path), 1 << 20),
                            encoding="utf-8", newline="")


def create_text_gz(path: str, compresslevel: int = 6) -> io.TextIOWrapper:
    """gzip-compatible text writer backed by the parallel BGZF codec.

    Output is standard multi-member gzip (readable by zcat/gzip.open) AND
    bgzip-blocked, so downstream tabix indexing and parallel re-reads work.
    Replaces single-threaded gzip.open("wt") on the TSV write paths.
    """
    return io.TextIOWrapper(io.BufferedWriter(BgzfWriter(path, compresslevel),
                                              1 << 20),
                            encoding="utf-8", newline="")

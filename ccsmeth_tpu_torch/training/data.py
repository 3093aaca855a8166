"""Feature-TSV training data: columnar in-memory dataset + shuffled batch iterator.

Replaces the reference's per-item linecache Datasets
(ccsmeth/dataloader.py:50-149) with one vectorized parse into
columnar float32 arrays — random access is then pure numpy fancy-indexing, the
natural feeder for fixed-shape jit batches (and orders of magnitude faster than
line-at-a-time parsing).
"""

from __future__ import annotations

import numpy as np

from ..bamio import open_text_auto
from ..utils.constants import BASE2CODE_DNA

_FEATURE_KEYS = (
    "kmer", "kpass", "ipd_means", "ipd_stds", "pw_means", "pw_stds", "sns", "maps",
    "kmer2", "kpass2", "ipd_means2", "ipd_stds2", "pw_means2", "pw_stds2", "sns2",
    "maps2",
)
_FEATURE_KEYS_SS = (
    "kmer", "kpass", "ipd_means", "ipd_stds", "pw_means", "pw_stds", "sns", "maps",
)


def load_feature_tsv(path: str, seq_len: int = 21,
                     single_strand: bool = False) -> dict[str, np.ndarray]:
    """Parse a (possibly gzipped) feature TSV into columnar arrays — 22 columns for
    two-strand rows, 14 for single-strand (reference dataloader.py:198-218,
    parse_a_liness). Kmer columns longer than seq_len are center-truncated like
    the reference formatter (_call_modifications_txt.py:159-166).
    """
    opener = ((lambda q, _m="rt": open_text_auto(q))
              if path.endswith(".gz") else open)
    with opener(path, "rt") as rf:
        return parse_feature_lines(rf, seq_len, single_strand)


def parse_feature_lines(lines, seq_len: int = 21,
                        single_strand: bool = False) -> dict[str, np.ndarray]:
    """Columnar parse of an iterable of feature-TSV lines (the unit shared by the
    in-memory and streaming datasets)."""
    if single_strand:
        return _parse_feature_lines_ss(lines, seq_len)
    base_lut = np.full(256, 4, dtype=np.float32)
    for b, c in BASE2CODE_DNA.items():
        base_lut[ord(b)] = c

    cols: dict[str, list] = {k: [] for k in _FEATURE_KEYS}
    labels: list[int] = []

    def vec(txt: str, lc: int, rc: int, n: int) -> np.ndarray:
        if txt == ".":
            return np.zeros(n, np.float32)
        return np.asarray(txt.split(",")[lc:rc], dtype=np.float32)

    def sn_vec(txt: str) -> np.ndarray:
        if txt == ".":
            return np.zeros(4, np.float32)
        return np.asarray(txt.split(","), dtype=np.float32)

    lc = rc = None
    for line in lines:
        w = line.rstrip("\n").split("\t")
        if len(w) < 22:
            continue
        if lc is None:
            oriklen = len(w[5])
            if oriklen >= seq_len:
                lc = (oriklen - seq_len) // 2
                rc = oriklen - lc
            else:
                raise ValueError("feature kmer shorter than --seq_len")
        kb = np.frombuffer(w[5][lc:rc].encode(), np.uint8)
        cols["kmer"].append(base_lut[kb])
        cols["kpass"].append(np.full(seq_len, float(int(w[6])), np.float32))
        cols["ipd_means"].append(vec(w[7], lc, rc, seq_len))
        cols["ipd_stds"].append(vec(w[8], lc, rc, seq_len))
        cols["pw_means"].append(vec(w[9], lc, rc, seq_len))
        cols["pw_stds"].append(vec(w[10], lc, rc, seq_len))
        cols["sns"].append(sn_vec(w[11]))
        cols["maps"].append(vec(w[12], lc, rc, seq_len))
        kb2 = np.frombuffer(w[13][lc:rc].encode(), np.uint8)
        cols["kmer2"].append(base_lut[kb2])
        cols["kpass2"].append(np.full(seq_len, float(int(w[14])), np.float32))
        cols["ipd_means2"].append(vec(w[15], lc, rc, seq_len))
        cols["ipd_stds2"].append(vec(w[16], lc, rc, seq_len))
        cols["pw_means2"].append(vec(w[17], lc, rc, seq_len))
        cols["pw_stds2"].append(vec(w[18], lc, rc, seq_len))
        cols["sns2"].append(sn_vec(w[19]))
        cols["maps2"].append(vec(w[20], lc, rc, seq_len))
        labels.append(int(w[21]))
    data = {k: np.stack(v).astype(np.float32) for k, v in cols.items() if v}
    data["labels"] = np.asarray(labels, dtype=np.int32)
    return data


def _parse_feature_lines_ss(lines, seq_len: int) -> dict[str, np.ndarray]:
    base_lut = np.full(256, 4, dtype=np.float32)
    for b, c in BASE2CODE_DNA.items():
        base_lut[ord(b)] = c
    cols: dict[str, list] = {k: [] for k in _FEATURE_KEYS_SS}
    labels: list[int] = []

    def vec(txt, lc, rc, n):
        if txt == ".":
            return np.zeros(n, np.float32)
        return np.asarray(txt.split(",")[lc:rc], dtype=np.float32)

    lc = rc = None
    for line in lines:
        w = line.rstrip("\n").split("\t")
        if len(w) < 14:
            continue
        if lc is None:
            oriklen = len(w[5])
            if oriklen < seq_len:
                raise ValueError("feature kmer shorter than --seq_len")
            lc = (oriklen - seq_len) // 2
            rc = oriklen - lc
        kb = np.frombuffer(w[5][lc:rc].encode(), np.uint8)
        cols["kmer"].append(base_lut[kb])
        cols["kpass"].append(np.full(seq_len, float(int(w[6])), np.float32))
        cols["ipd_means"].append(vec(w[7], lc, rc, seq_len))
        cols["ipd_stds"].append(vec(w[8], lc, rc, seq_len))
        cols["pw_means"].append(vec(w[9], lc, rc, seq_len))
        cols["pw_stds"].append(vec(w[10], lc, rc, seq_len))
        cols["sns"].append(np.zeros(4, np.float32) if w[11] == "." else
                           np.asarray(w[11].split(","), dtype=np.float32))
        cols["maps"].append(vec(w[12], lc, rc, seq_len))
        labels.append(int(w[13]))
    data = {k: np.stack(v).astype(np.float32) for k, v in cols.items() if v}
    data["labels"] = np.asarray(labels, dtype=np.int32)
    return data


class FeatureDataset:
    def __init__(self, data: dict[str, np.ndarray]):
        self.data = data
        self.n = len(data["labels"])

    @classmethod
    def from_tsv(cls, path: str, seq_len: int = 21,
                 single_strand: bool = False) -> "FeatureDataset":
        return cls(load_feature_tsv(path, seq_len, single_strand))

    def __len__(self) -> int:
        return self.n

    def batches(self, batch_size: int, shuffle: bool, rng: np.random.RandomState,
                drop_remainder: bool = False, pad_to: int | None = None,
                shard: tuple[int, int] | None = None):
        """Yield (feats dict, labels, n_valid). With pad_to, ragged tails are
        zero-padded to fixed shape. With shard=(i, n), yields every n-th batch —
        per-host sharding for multi-host training (DistributedSampler analog)."""
        idx = np.arange(self.n)
        if shuffle:
            rng.shuffle(idx)
        b = 0
        for s in range(0, self.n, batch_size):
            sel = idx[s : s + batch_size]
            if len(sel) < batch_size and drop_remainder:
                break
            b += 1
            if shard is not None and (b - 1) % shard[1] != shard[0]:
                continue
            feats = {k: self.data[k][sel] for k in _FEATURE_KEYS if k in self.data}
            labels = self.data["labels"][sel]
            n_valid = len(sel)
            if pad_to is not None and n_valid < pad_to:
                pad = pad_to - n_valid
                feats = {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
                         for k, v in feats.items()}
                labels = np.pad(labels, (0, pad))
            yield feats, labels, n_valid


class StreamingFeatureDataset:
    """Out-of-core feature TSV: O(chunk) memory for arbitrarily large files.

    The reference handles big files with byte-offset datasets (dataloader.py:85-121,
    FeaData2 via --dl_offsets); the TPU-shaped equivalent is chunked windowed
    shuffling: a one-pass index records the byte offset of every `chunk_rows`-th
    line; each epoch visits chunks in random order, shuffles rows within the
    chunk, and yields fixed-shape batches (carrying ragged chunk tails into the
    next chunk so every non-final batch is full). Plain or bgzf/gzip-compressed
    files; gzip cannot seek, so chunk order stays sequential there (in-chunk
    shuffle only).

    Same .batches() contract as FeatureDataset (pad_to / drop_remainder /
    shard=(i, n) per-host striding), so train() can use either interchangeably.
    """

    def __init__(self, path: str, seq_len: int = 21, single_strand: bool = False,
                 chunk_rows: int = 65536):
        self.path = path
        self.seq_len = seq_len
        self.single_strand = single_strand
        self.chunk_rows = chunk_rows
        self._gz = path.endswith(".gz")
        self._offsets: list[int] = []  # byte offset of each chunk start (plain files)
        n = 0
        if self._gz:
            with open_text_auto(path) as rf:
                for _ in rf:
                    n += 1
        else:
            with open(path, "rb") as rf:
                off = rf.tell()
                self._offsets.append(off)
                rows_in_chunk = 0
                for line in rf:
                    n += 1
                    rows_in_chunk += 1
                    if rows_in_chunk == chunk_rows:
                        self._offsets.append(rf.tell())
                        rows_in_chunk = 0
                if rows_in_chunk == 0 and len(self._offsets) > 1:
                    self._offsets.pop()
        self.n = n

    def __len__(self) -> int:
        return self.n

    def _iter_chunks(self, shuffle: bool, rng):
        if self._gz:
            with open_text_auto(self.path) as rf:
                chunk: list[str] = []
                for line in rf:
                    chunk.append(line)
                    if len(chunk) == self.chunk_rows:
                        yield chunk
                        chunk = []
                if chunk:
                    yield chunk
            return
        order = np.arange(len(self._offsets))
        if shuffle:
            rng.shuffle(order)
        with open(self.path, "rb") as rf:
            for ci in order:
                rf.seek(self._offsets[ci])
                chunk = []
                for _ in range(self.chunk_rows):
                    raw = rf.readline()
                    if not raw:
                        break
                    chunk.append(raw.decode())
                yield chunk

    def batches(self, batch_size: int, shuffle: bool, rng: np.random.RandomState,
                drop_remainder: bool = False, pad_to: int | None = None,
                shard: tuple[int, int] | None = None):
        keys = _FEATURE_KEYS_SS if self.single_strand else _FEATURE_KEYS
        carry: dict[str, np.ndarray] | None = None
        b = 0

        def emit(feats, labels, n_valid):
            nonlocal b
            b += 1
            if shard is not None and (b - 1) % shard[1] != shard[0]:
                return None
            if pad_to is not None and n_valid < pad_to:
                pad = pad_to - n_valid
                feats = {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
                         for k, v in feats.items()}
                labels = np.pad(labels, (0, pad))
            return feats, labels, n_valid

        for chunk in self._iter_chunks(shuffle, rng):
            data = parse_feature_lines(chunk, self.seq_len, self.single_strand)
            if "labels" not in data or len(data["labels"]) == 0:
                continue
            if carry is not None:
                data = {k: np.concatenate([carry[k], data[k]])
                        for k in list(data.keys())}
                carry = None
            m = len(data["labels"])
            idx = np.arange(m)
            if shuffle:
                rng.shuffle(idx)
            full_end = m - m % batch_size
            for s in range(0, full_end, batch_size):
                sel = idx[s : s + batch_size]
                out = emit({k: data[k][sel] for k in keys if k in data},
                           data["labels"][sel], batch_size)
                if out is not None:
                    yield out
            if full_end < m:
                tail = idx[full_end:]
                carry = {k: data[k][tail] for k in list(data.keys())}
        if carry is not None and not drop_remainder:
            n_valid = len(carry["labels"])
            out = emit({k: carry[k] for k in keys if k in carry},
                       carry["labels"], n_valid)
            if out is not None:
                yield out

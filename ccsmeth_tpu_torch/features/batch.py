"""Columnar site-feature batches feeding the jitted model step.

Replaces the reference's per-site Python list-of-lists batching
(ccsmeth/call_modifications.py:73-123, ``_batch_feature_list2s``)
with preallocated columnar arrays plus a read-index column, so MM-tag assembly can
group predictions back per read without string sampleinfo rows.

Representation choices are transfer-oriented: kmers stay uint8, per-read npass is
one scalar per site ((N,) not (N, L)), and channels the model config has disabled
(stds/sn/map in the production default) stay None — ``model_feats`` materializes
zeros only for consumers that need dense dicts, and the device predict path skips
them entirely (parallel/mesh.py synthesizes zeros on device).

Batches pad to a fixed size (``pad_to``) so ``jit`` never recompiles on ragged
tails — padded rows are masked out downstream.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .extract import ReadFeatures

_ARRAY_FIELDS = (
    "read_idx", "locs", "chrom_pos",
    "kmer", "kpass", "ipd_means", "pw_means",
    "kmer2", "kpass2", "ipd_means2", "pw_means2",
    "sns", "sns2", "maps", "maps2",
    "ipd_stds", "pw_stds", "ipd_stds2", "pw_stds2",
    "labels",
)


@dataclasses.dataclass
class FeatureBatch:
    # per-site metadata
    read_idx: np.ndarray  # (N,)
    locs: np.ndarray  # (N,)
    chrom_pos: np.ndarray  # (N,)
    # model inputs: kmer* uint8/float (N, L); kpass* (N,) or (N, L);
    # ipd/pw (N, L) float32; optional channels may be None
    kmer: np.ndarray
    kpass: np.ndarray
    ipd_means: np.ndarray
    pw_means: np.ndarray
    kmer2: np.ndarray
    kpass2: np.ndarray
    ipd_means2: np.ndarray
    pw_means2: np.ndarray
    sns: np.ndarray | None = None  # (N, 4)
    sns2: np.ndarray | None = None
    maps: np.ndarray | None = None  # (N, L)
    maps2: np.ndarray | None = None
    ipd_stds: np.ndarray | None = None
    pw_stds: np.ndarray | None = None
    ipd_stds2: np.ndarray | None = None
    pw_stds2: np.ndarray | None = None
    labels: np.ndarray | None = None
    n_valid: int = 0
    seq_len: int = 21

    def __len__(self) -> int:
        return len(self.read_idx)

    def model_feats(self) -> dict:
        """Dense feats dict; lazy channels materialize as zeros, kpass broadcasts."""
        N = len(self)
        L = self.seq_len

        def dense_l(a):
            return np.zeros((N, L), np.float32) if a is None else np.asarray(a, np.float32)

        def dense_sn(a):
            return np.zeros((N, 4), np.float32) if a is None else np.asarray(a, np.float32)

        def dense_kpass(a):
            a = np.asarray(a, np.float32)
            if a.ndim == 1:
                return np.broadcast_to(a[:, None], (N, L))
            return a

        return {
            "kmer": np.asarray(self.kmer, np.float32),
            "kpass": dense_kpass(self.kpass),
            "ipd_means": np.asarray(self.ipd_means, np.float32),
            "pw_means": np.asarray(self.pw_means, np.float32),
            "ipd_stds": dense_l(self.ipd_stds), "pw_stds": dense_l(self.pw_stds),
            "sns": dense_sn(self.sns), "maps": dense_l(self.maps),
            "kmer2": np.asarray(self.kmer2, np.float32),
            "kpass2": dense_kpass(self.kpass2),
            "ipd_means2": np.asarray(self.ipd_means2, np.float32),
            "pw_means2": np.asarray(self.pw_means2, np.float32),
            "ipd_stds2": dense_l(self.ipd_stds2), "pw_stds2": dense_l(self.pw_stds2),
            "sns2": dense_sn(self.sns2), "maps2": dense_l(self.maps2),
        }

    def compact_feats(self) -> dict:
        """Minimal-transfer dict for the device predict path (mesh.make_predict_fn):
        uint8 kmers, (N,) kpass; optional channels only when present."""
        out = {
            "kmer": np.asarray(self.kmer, np.int8),
            "kpass": self._kpass_1d(self.kpass),
            "ipd_means": np.asarray(self.ipd_means, np.float32),
            "pw_means": np.asarray(self.pw_means, np.float32),
            "kmer2": np.asarray(self.kmer2, np.int8),
            "kpass2": self._kpass_1d(self.kpass2),
            "ipd_means2": np.asarray(self.ipd_means2, np.float32),
            "pw_means2": np.asarray(self.pw_means2, np.float32),
        }
        for name in ("sns", "sns2", "maps", "maps2", "ipd_stds", "pw_stds",
                     "ipd_stds2", "pw_stds2"):
            v = getattr(self, name)
            if v is not None:
                out[name] = np.asarray(v, np.float32)
        return out

    @staticmethod
    def _kpass_1d(a) -> np.ndarray:
        a = np.asarray(a, np.float32)
        return a[:, 0] if a.ndim == 2 else a

    def slice(self, s: int, e: int) -> "FeatureBatch":
        kw = {}
        for f in _ARRAY_FIELDS:
            v = getattr(self, f)
            kw[f] = None if v is None else v[s:e]
        return FeatureBatch(**kw, n_valid=e - s, seq_len=self.seq_len)

    def pad_to(self, n: int) -> "FeatureBatch":
        cur = len(self)
        if cur == n:
            return dataclasses.replace(self, n_valid=cur)
        if cur > n:
            raise ValueError("batch longer than pad target")
        pad = n - cur

        def p(a):
            if a is None:
                return None
            width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, width, mode="constant")

        kw = {f: p(getattr(self, f)) for f in _ARRAY_FIELDS}
        return FeatureBatch(**kw, n_valid=cur, seq_len=self.seq_len)


def batch_from_reads(reads: list[ReadFeatures], seq_len: int = 21) -> FeatureBatch | None:
    """Concatenate per-read feature arrays into one site batch (preallocated)."""
    reads = [r for r in reads if r is not None and r.n_sites > 0]
    if not reads:
        return None
    counts = [r.n_sites for r in reads]
    N = sum(counts)
    L = seq_len

    read_idx = np.repeat(np.arange(len(reads), dtype=np.int32), counts)
    locs = np.empty(N, np.int64)
    chrom_pos = np.empty(N, np.int64)
    kmer = np.empty((N, L), np.uint8)
    kmer2 = np.empty((N, L), np.uint8)
    ipd = np.empty((N, L), np.float32)
    pw = np.empty((N, L), np.float32)
    ipd2 = np.empty((N, L), np.float32)
    pw2 = np.empty((N, L), np.float32)
    kpass = np.empty(N, np.float32)
    kpass2 = np.empty(N, np.float32)
    labels = np.empty(N, np.int32)

    any_sn = any(r.sn is not None and len(np.atleast_1d(r.sn)) == 4 for r in reads)
    any_map = any(r.fmap is not None for r in reads)
    sns = np.zeros((N, 4), np.float32) if any_sn else None
    maps = np.zeros((N, L), np.float32) if any_map else None
    maps2 = np.zeros((N, L), np.float32) if any_map else None

    o = 0
    for r, c in zip(reads, counts):
        sl = slice(o, o + c)
        locs[sl] = r.locs
        chrom_pos[sl] = r.chrom_pos
        kmer[sl] = r.fkmer
        kmer2[sl] = r.rkmer
        ipd[sl] = r.fipd
        pw[sl] = r.fpw
        ipd2[sl] = r.ripd
        pw2[sl] = r.rpw
        kpass[sl] = r.npass_fwd
        kpass2[sl] = r.npass_rev
        labels[sl] = r.label
        if any_sn and r.sn is not None and len(np.atleast_1d(r.sn)) == 4:
            sns[sl] = np.asarray(r.sn, np.float32)
        if any_map and r.fmap is not None:
            maps[sl] = r.fmap
            maps2[sl] = r.rmap
        o += c

    return FeatureBatch(
        read_idx=read_idx, locs=locs, chrom_pos=chrom_pos,
        kmer=kmer, kpass=kpass, ipd_means=ipd, pw_means=pw,
        kmer2=kmer2, kpass2=kpass2, ipd_means2=ipd2, pw_means2=pw2,
        sns=sns, sns2=sns, maps=maps, maps2=maps2,
        labels=labels, n_valid=N, seq_len=seq_len,
    )

"""Share-nothing scale-out: read-shard and genome-chunk partitioning.

The host part of ``ccsmeth_tpu/parallel/distributed.py`` (``:39-50``): every
process scans its disjoint slice of the genome's chunk list
(``partition_chunks``) or of the read stream (``owns_read``) and writes its
own output; ownership is disjoint by construction, so concatenating the
outputs rebuilds the single run. The collective merge of per-site counts
(``init_multihost``, ``psum_site_counts``) belongs to multi-GPU and is not
ported yet.
"""

from __future__ import annotations

import zlib


def partition_chunks(ref_chunks: list, process_id: int, num_processes: int) -> list:
    """Disjoint round-robin ownership of genome chunks across hosts."""
    return [c for i, c in enumerate(ref_chunks) if i % num_processes == process_id]


def owns_read(qname: str, process_id: int, num_processes: int) -> bool:
    """Stable hash-based read ownership for denovo-mode sharding."""
    return zlib.crc32(qname.encode()) % num_processes == process_id

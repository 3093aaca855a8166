"""Scale-out across processes: read-shard and genome-chunk partitioning, and
the process group of multi-process training and call_freqb's merge.

Counterpart of ``ccsmeth_tpu/parallel/distributed.py``. Ownership is
disjoint by construction: every process scans its slice of the genome's
chunk list (``partition_chunks``) or of the read stream (``owns_read``).

Where the JAX package runs ``jax.distributed`` with one process per host
over all its devices, the port runs ``torch.distributed`` with one process
(rank) per card, PyTorch's idiom. ``init_multihost`` makes the group:
rank 0 hosts the TCP store at the coordinator's address, as JAX's
coordinator does, and every rank first writes its host name there, so each
rank knows how many ranks share its host before it picks the backend:

- ``nccl`` when the device is CUDA and every rank on the host has a card of
  its own (ranks on the host <= cards), otherwise ``gloo``
  (``backend_for``). Two ranks sharing one card take ``gloo``: NCCL refuses
  a duplicate GPU. The rule is decided before the group exists; an
  ``nccl`` group that fails raises.
- A rank's card is the ``cuda:k`` the caller gave, or for plain ``cuda``
  ``cuda:{process_id % device_count}`` (ranks laid out host-major, one a
  card).

``all_reduce_sum`` and ``psum_site_counts`` are the collectives; under
``gloo`` a CUDA tensor goes through the host. ``allreduce_calls`` and
``allreduce_bytes`` count every all-reduce since ``init_multihost``, and
``allreduce_seconds`` sums the host's wall time inside the collective calls
(under ``gloo`` the whole exchange; under ``nccl``, whose calls return
once queued on the stream, only the queueing).
"""

from __future__ import annotations

import datetime
import os
import socket
import time
import zlib

import numpy as np
import torch

world = 1  # processes in the group (1: no group)
rank = 0
backend = None  # "nccl" or "gloo" once a group exists
device = None  # this rank's torch.device
allreduce_calls = 0
allreduce_bytes = 0
allreduce_seconds = 0.0
_store = None
LOOPBACK = ("127.0.0.1", "localhost", "::1")


def partition_chunks(ref_chunks: list, process_id: int, num_processes: int) -> list:
    """Disjoint round-robin ownership of genome chunks across hosts."""
    return [c for i, c in enumerate(ref_chunks) if i % num_processes == process_id]


def owns_read(qname: str, process_id: int, num_processes: int) -> bool:
    """Stable hash-based read ownership for denovo-mode sharding."""
    return zlib.crc32(qname.encode()) % num_processes == process_id


def backend_for(device_type: str, ranks_per_host: int, cards: int) -> str:
    """The backend of a group: ``nccl`` when the device is CUDA and each of
    the host's ``ranks_per_host`` ranks has a card of its own among its
    ``cards``, else ``gloo``."""
    return "nccl" if device_type == "cuda" and 0 < ranks_per_host <= cards else "gloo"


def rank_device(name: str, process_id: int) -> torch.device:
    """This rank's device: ``cpu``, the ``cuda:k`` asked for, or for plain
    ``cuda`` the card ``process_id % device_count``. A card that is not
    there raises."""
    from ..pipeline.call_mods import resolve_device

    dev = resolve_device(name)
    if dev.type == "cpu":
        return dev
    n = torch.cuda.device_count()
    if dev.index is None:
        return torch.device("cuda", process_id % n)
    if dev.index >= n:
        raise RuntimeError("device {} requested, {} card(s) visible".format(name, n))
    return dev


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   device_name: str = "cuda") -> torch.device:
    """Join the group of ``num_processes`` ranks at ``coordinator``
    (host:port; rank 0 serves it) as rank ``process_id``; returns the
    rank's device, made torch's current device on CUDA. Call ``teardown``
    when done."""
    global world, rank, backend, device, _store
    global allreduce_calls, allreduce_bytes, allreduce_seconds
    import torch.distributed as dist

    if num_processes < 2:
        raise ValueError("a process group needs --num_processes > 1")
    if not 0 <= process_id < num_processes:
        raise ValueError("--process_id must be in [0, num_processes)")
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError("--dist_coordinator must be host:port, got {}".format(
            coordinator))
    dev = rank_device(device_name, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(minutes=10)
    store = torch.distributed.TCPStore(host, int(port), num_processes,
                                       is_master=process_id == 0, timeout=timeout)
    store.set("ccs/host/{}".format(process_id), socket.gethostname())
    keys = ["ccs/host/{}".format(r) for r in range(num_processes)]
    store.wait(keys)
    hosts = [store.get(k).decode() for k in keys]
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = backend_for(dev.type, hosts.count(socket.gethostname()), cards)
    if backend == "gloo" and host in LOOPBACK:
        # a loopback coordinator puts every rank on this host: gloo talks
        # over the loopback interface, whatever the host name resolves to
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    _store = store
    world, rank, device = num_processes, process_id, dev
    allreduce_calls = allreduce_bytes = 0
    allreduce_seconds = 0.0
    return dev


def teardown() -> None:
    """Destroy the group made by ``init_multihost``; back to one process."""
    global world, rank, backend, device, _store
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    world, rank, backend, device, _store = 1, 0, None, None, None


def _through_host(t: torch.Tensor) -> bool:
    return backend == "gloo" and t.device.type != "cpu"


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (the identity with one process) and
    return it; counted in ``allreduce_calls`` and ``allreduce_bytes``."""
    global allreduce_calls, allreduce_bytes, allreduce_seconds
    if world == 1:
        return t
    import torch.distributed as dist

    if _through_host(t):
        host = t.cpu()
        t0 = time.perf_counter()
        dist.all_reduce(host)
        allreduce_seconds += time.perf_counter() - t0
        t.copy_(host)
    else:
        t0 = time.perf_counter()
        dist.all_reduce(t)
        allreduce_seconds += time.perf_counter() - t0
    allreduce_calls += 1
    allreduce_bytes += t.numel() * t.element_size()
    return t


def broadcast_(tensors) -> None:
    """Overwrite ``tensors`` on every rank with rank 0's, one flat
    broadcast per dtype."""
    if world == 1:
        return
    import torch.distributed as dist

    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        if _through_host(flat):
            flat = flat.cpu()
        dist.broadcast(flat, 0)
        o = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[o:o + t.numel()].view(t.shape))
                o += t.numel()


def psum_site_counts(local_counts: np.ndarray) -> np.ndarray:
    """The sum over ranks of one (n, k) float32 table a process, as numpy on
    every rank (``psum_site_counts`` of the JAX package): one all-reduce,
    on the rank's card under ``nccl``, on the host under ``gloo``. With one
    process it returns its input."""
    local_counts = np.ascontiguousarray(local_counts, np.float32)
    if world == 1:
        return local_counts
    t = torch.from_numpy(local_counts.copy())
    if backend == "nccl":
        t = t.to(device)
    return all_reduce_sum(t).cpu().numpy()

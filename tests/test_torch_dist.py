"""The port's process group (``ccsmeth_tpu_torch/parallel/distributed.py``)
on the CPU: ``psum_site_counts`` over two ``gloo`` ranks equals the numpy sum
exactly, the backend rule as a function of the layout, a rank's card, and
one process returning its table unchanged.

``run_ranks`` starts one Python process a rank on a free port; the other
multi-process tests of the port use it. Each ``communicate`` has its own
timeout, on whose expiry every rank is killed: a hung rank fails one test
and never holds the suite."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.parallel import distributed

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 180  # seconds a rank may take before all are killed


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(scripts, timeout=RANK_TIMEOUT, args=()):
    """Run ``scripts[k]`` (Python source) as rank k, all at once; returns
    their outputs (stdout and stderr together). Fails the test if a rank
    exits non-zero, or kills every rank and fails if one outlives
    ``timeout`` seconds."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", src] + list(args), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for src in scripts]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail("a rank outlived {} s".format(timeout))
    for k, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank {} failed:\n{}".format(k, out[-4000:])
    return outs


def last_json(out: str):
    """The last line of a rank's output that is a JSON object."""
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError("no JSON line in:\n" + out[-2000:])


PSUM_RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from ccsmeth_tpu_torch.parallel import distributed
rank = {rank}
dev = distributed.init_multihost("127.0.0.1:{port}", 2, rank, "cpu")
try:
    tables = np.load({path!r})
    out = distributed.psum_site_counts(tables["t{{}}".format(rank)])
    np.save({path!r}[:-4] + ".out{{}}.npy".format(rank), out)
    print(json.dumps({{"device": str(dev), "backend": distributed.backend,
                      "calls": distributed.allreduce_calls,
                      "bytes": distributed.allreduce_bytes}}))
finally:
    distributed.teardown()
"""


def test_psum_site_counts_over_two_ranks_is_the_exact_sum(tmp_path):
    """Random integer counts (below 2^24, where float32 is exact), as
    call_freqb's per-site count and histogram tables are: both ranks get
    the numpy sum bit for bit, through one all-reduce of n*k*4 bytes."""
    rng = np.random.RandomState(5)
    t0 = rng.randint(0, 1 << 20, (257, 23)).astype(np.float32)
    t1 = rng.randint(0, 1 << 20, (257, 23)).astype(np.float32)
    path = str(tmp_path / "tables.npz")
    np.savez(path, t0=t0, t1=t1)
    port = free_port()
    outs = run_ranks([PSUM_RANK.format(rank=k, port=port, path=path) for k in (0, 1)])
    for k, out in enumerate(outs):
        got = np.load(str(tmp_path / "tables.out{}.npy".format(k)))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, t0.astype(np.int64) + t1.astype(np.int64))
        info = last_json(out)
        assert info == {"device": "cpu", "backend": "gloo", "calls": 1,
                        "bytes": 257 * 23 * 4}


@pytest.mark.parametrize("device_type, ranks_per_host, cards, want", [
    ("cpu", 2, 0, "gloo"),    # the CPU tests
    ("cpu", 1, 8, "gloo"),    # --device cpu on a host with cards
    ("cuda", 2, 1, "gloo"),   # two ranks sharing one card: NCCL refuses it
    ("cuda", 4, 2, "gloo"),   # more ranks than cards on the host
    ("cuda", 1, 1, "nccl"),   # a rank a host, one card
    ("cuda", 4, 4, "nccl"),   # one rank a card
    ("cuda", 2, 8, "nccl"),   # fewer ranks than cards: each has its own
])
def test_backend_rule(device_type, ranks_per_host, cards, want):
    assert distributed.backend_for(device_type, ranks_per_host, cards) == want


def test_rank_device(monkeypatch):
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.rank_device("cuda", 0) == torch.device("cuda", 0)
    assert distributed.rank_device("cuda", 6) == torch.device("cuda", 2)
    assert distributed.rank_device("cuda:3", 0) == torch.device("cuda", 3)
    with pytest.raises(RuntimeError, match="4 card"):
        distributed.rank_device("cuda:4", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        distributed.rank_device("cuda", 0)


def test_one_process_returns_its_table_unchanged():
    assert distributed.world == 1 and distributed.backend is None
    t = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = distributed.psum_site_counts(t)
    np.testing.assert_array_equal(out, t)
    calls = distributed.allreduce_calls
    x = torch.ones(5)
    assert distributed.all_reduce_sum(x) is x and x.tolist() == [1.0] * 5
    assert distributed.allreduce_calls == calls


@pytest.mark.parametrize("kw, match", [
    (dict(num_processes=1), "num_processes > 1"),
    (dict(process_id=2), "process_id"),
    (dict(coordinator="localhost"), "host:port"),
])
def test_init_multihost_refuses_a_bad_layout(kw, match):
    args = dict(coordinator="127.0.0.1:1", num_processes=2, process_id=0)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        distributed.init_multihost(args["coordinator"], args["num_processes"],
                                   args["process_id"], "cpu")
    assert distributed.world == 1

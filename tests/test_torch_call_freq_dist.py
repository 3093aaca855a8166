"""call_freqb --dist_coordinator through the port's CLI on two ``gloo`` ranks,
on the golden reads' modbam (the fixture of ``tests/test_torch_call_freq.py``):
each rank keeps the reads its qname hash owns, the per-site tables of every
active chunk are all-reduced (a presence vector, then the site-packed stats),
and rank 0 alone writes. Count mode: rank 0's files byte-equal to the
single-process run's and to ``tests/goldens/freq_count.*.tsv``; aggregate
mode with a seeded 1 x 32 model: rank 0's rows equal to the single-process
run's. Rank 1 writes nothing.

The ranks run through ``tests/test_torch_dist.py::run_ranks``: a timeout of
their own on each rank, every rank killed on expiry."""

import os

import pytest
import torch

from ccsmeth_tpu_torch.models import AggrConfig, init_aggr_attrnn
from ccsmeth_tpu_torch.models.params_io import save_params
from ccsmeth_tpu_torch.pipeline import call_freq_bam as cfb
from tests.test_torch_call_freq import GOLD, REF, _by_tag, _read, _run, modbam  # noqa: F401
from tests.test_torch_dist import free_port, last_json, run_ranks

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

FREQB_RANK = r"""
import json
import torch
torch.set_num_threads(1)
from ccsmeth_tpu_torch import cli
from ccsmeth_tpu_torch.pipeline.call_freq_bam import LAST_RUN

cli.main(["call_freqb", "-i", {bam!r}, "--ref", {ref!r}, "-o", {out!r},
          "--chunk_len", "500", "--call_mode", {mode!r}] + {extra!r}
         + ["--num_processes", "2", "--process_id", "{rank}",
            "--dist_coordinator", "127.0.0.1:{port}"])
print(json.dumps(LAST_RUN))
"""


def _two_ranks(modbam, tmp_path, mode, extra=()):
    port = free_port()
    outs = [str(tmp_path / "rank{}".format(k) / "dist") for k in (0, 1)]
    for o in outs:
        os.makedirs(os.path.dirname(o))
    logs = run_ranks([FREQB_RANK.format(bam=modbam.bam, ref=REF, out=outs[k], mode=mode,
                                        extra=list(extra), rank=k, port=port)
                      for k in (0, 1)])
    runs = [last_json(lg) for lg in logs]
    # rank 1 wrote nothing
    assert os.listdir(os.path.dirname(outs[1])) == []
    assert runs[1]["sites"] == 0
    for r in runs:
        assert r["world"] == 2 and r["backend"] == "gloo"
        # one presence merge up front, then two a chunk with sites
        assert r["allreduce_calls"] >= 3 and r["allreduce_calls"] % 2 == 1
        assert r["allreduce_bytes"] > 0
    assert runs[0]["allreduce_calls"] == runs[1]["allreduce_calls"]
    assert runs[0]["allreduce_bytes"] == runs[1]["allreduce_bytes"]
    paths = {t: "{}.{}.{}.freq.txt".format(outs[0], mode, t)
             for t in ("all", "hp1", "hp2")}
    return {t: p for t, p in paths.items() if os.path.exists(p)}, runs


def test_count_merge_equals_the_single_run_and_the_goldens(modbam, tmp_path):
    got, runs = _two_ranks(modbam, tmp_path, "count")
    single = _by_tag(_run(cfb, modbam.bam, str(tmp_path / "single"), call_mode="count"))
    assert set(got) == set(single) == {"all", "hp1", "hp2"}
    for tag in got:
        assert _read(got[tag]) == _read(single[tag]), tag
        assert _read(got[tag]) == _read(
            os.path.join(GOLD, "freq_count.{}.tsv".format(tag))), tag
    assert runs[0]["sites"] == len(_read(single["all"]).splitlines())


@pytest.mark.parametrize("model_type", ["attbigru", "attbilstm"])
def test_aggregate_merge_equals_the_single_run(modbam, tmp_path, model_type):
    acfg = AggrConfig(model_type=model_type)
    npz = str(tmp_path / "aggr.npz")
    save_params(npz, init_aggr_attrnn(11, acfg))
    extra = ["--aggre_model", npz, "--model_type", model_type, "--device", "cpu"]
    got, runs = _two_ranks(modbam, tmp_path, "aggregate", extra)
    single = _by_tag(_run(cfb, modbam.bam, str(tmp_path / "single"),
                          call_mode="aggregate", aggre_model=npz,
                          model_type=model_type))
    assert set(got) == set(single) and "all" in got
    for tag in got:
        assert _read(got[tag]) == _read(single[tag]), tag
    # rank 0 alone runs the model, on as many rows as the single run
    assert runs[0]["rows"] == cfb.LAST_RUN["rows"] > 0 and runs[1]["rows"] == 0

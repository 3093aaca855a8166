"""The predict step over several devices, on the CPU: two CPU replicas (each
batch split in two row slices, one a replica, gathered in row order) give
what one replica gives, in the predict step itself and through call_mods on
both inputs (the golden reads' BAM and their features TSV), with
``--h0_mode randn`` too; the padded batch follows the JAX package's rule
(``ccsmeth_tpu/pipeline/call_mods.py:396-397``).

A replica's products run on half the rows, and the CPU's matrix products
can round a row's last bit differently at another row count (as the JAX
package's shard shapes do, ``tests/test_torch_text_path.py``): probs agree
to 1e-6, an ML byte within one step, a printed prob within one unit of its
6th decimal."""

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models import AttRNN, AttRNNConfig, attrnn_state_dict_from_params
from ccsmeth_tpu_torch.models import init_attrnn
from ccsmeth_tpu_torch.parallel.predict import make_predict_fn
from ccsmeth_tpu_torch.pipeline import call_mods as port
from tests.synth import example_feats
from tests.test_torch_call_mods_flags import BAM, BAM_KW, GOLDEN_KW, TSV, _tags
from tests.test_torch_text_path import _assert_per_readsite_close

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

CFG = dict(num_layers=2, hidden_size=16, dropout_rate=0)
CPU2 = [torch.device("cpu"), torch.device("cpu")]


def _model(seed=3):
    m = AttRNN(AttRNNConfig(**CFG))
    params = init_attrnn(seed, AttRNNConfig(**CFG))
    m.load_state_dict(attrnn_state_dict_from_params(params))
    return m.eval()


@pytest.mark.parametrize("fetch_mode", ["probs", "mlbyte"])
def test_two_replicas_equal_one_in_the_predict_step(fetch_mode):
    feats = example_feats(24, 21, 5, optional="random")
    one = make_predict_fn(_model(), AttRNNConfig(**CFG), "cpu", fetch_mode=fetch_mode)
    two = make_predict_fn(_model(), AttRNNConfig(**CFG), CPU2, fetch_mode=fetch_mode)
    assert one.replicas == 1 and two.replicas == 2
    a, b = one(feats), two(feats)
    assert a.shape == b.shape and a.shape[0] == 24 and a.dtype == b.dtype
    tol = 1 if fetch_mode == "mlbyte" else 1e-6
    np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), atol=tol)
    # each row slice is the replica's own: the second half equals one
    # replica's run of those rows alone
    half = {k: v[12:] for k, v in feats.items()}
    np.testing.assert_array_equal(b[12:], one(half))
    # k batches in one dispatch_many, collected in order
    many = two.collect(two.dispatch_many([feats, example_feats(24, 21, 6,
                                                               optional="random")]))
    np.testing.assert_array_equal(many[0], b)
    assert two.n_batches == 3


def test_pad_rows_follows_the_jax_rule(tmp_path, monkeypatch):
    for b in (1, 7, 8, 13, 512, 513):
        for n in (1, 2, 3, 8):
            want = max(b, n) // n * n  # ccsmeth_tpu/pipeline/call_mods.py:396-397
            assert port.pad_rows(b, n) == want
            assert want % n == 0 and want >= n
    # both inputs pad to it: 13 rows a batch on one replica, 12 on two
    _two_cpu_replicas(monkeypatch)
    kw = dict(GOLDEN_KW, batch_size=13, device="cpu")
    port.call_mods_txt(port.CallModsConfig(**kw), TSV, str(tmp_path / "t"))
    assert port.LAST_RUN["pad_n"] == 12 and port.LAST_RUN["replicas"] == 2
    port.call_mods_bam(port.CallModsConfig(**kw, **BAM_KW), BAM, str(tmp_path / "b"))
    assert port.LAST_RUN["pad_n"] == 12 and port.LAST_RUN["replicas"] == 2


def _two_cpu_replicas(monkeypatch):
    monkeypatch.setattr(port, "predict_devices", lambda name: list(CPU2))


@pytest.mark.parametrize("h0_mode", ["zeros", "randn"])
def test_call_mods_bam_with_two_replicas_equals_one(tmp_path, monkeypatch, h0_mode):
    """The same padded batches (12 rows), so randn draws the same states for
    the same rows."""
    kw = dict(GOLDEN_KW, **BAM_KW, batch_size=12, device="cpu", h0_mode=h0_mode,
              tseed=41)
    one = port.call_mods_bam(port.CallModsConfig(**kw), BAM, str(tmp_path / "one"))
    run_one = dict(port.LAST_RUN)
    _two_cpu_replicas(monkeypatch)
    two = port.call_mods_bam(port.CallModsConfig(**kw), BAM, str(tmp_path / "two"))
    run_two = dict(port.LAST_RUN)
    assert run_one["replicas"] == 1 and run_two["replicas"] == 2
    assert run_one["pad_n"] == run_two["pad_n"] == 12
    assert run_one["sites"] == run_two["sites"] > 0
    assert run_one["batches"] == run_two["batches"]
    tags_one, tags_two = _tags(one), _tags(two)
    assert tags_one.keys() == tags_two.keys()
    n_ml = 0
    for q, (mm, ml) in tags_one.items():
        assert tags_two[q][0] == mm
        if ml:
            assert np.abs(np.subtract(ml, tags_two[q][1])).max() <= 1, q
            n_ml += len(ml)
    assert n_ml > 0


@pytest.mark.parametrize("h0_mode", ["zeros", "randn"])
def test_call_mods_tsv_with_two_replicas_equals_one(tmp_path, monkeypatch, h0_mode):
    kw = dict(GOLDEN_KW, batch_size=16, device="cpu", h0_mode=h0_mode, tseed=43)
    one = port.call_mods_txt(port.CallModsConfig(**kw), TSV, str(tmp_path / "one"))
    _two_cpu_replicas(monkeypatch)
    two = port.call_mods_txt(port.CallModsConfig(**kw), TSV, str(tmp_path / "two"))
    assert port.LAST_RUN["replicas"] == 2 and port.LAST_RUN["pad_n"] == 16
    _assert_per_readsite_close(two, one)


def test_predict_devices(monkeypatch):
    assert port.predict_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert port.predict_devices("cuda") == [torch.device("cuda", i) for i in range(3)]
    assert port.predict_devices("cuda:1") == [torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="one type"):
        make_predict_fn(_model(), AttRNNConfig(**CFG), ["cpu", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port.predict_devices("cuda")

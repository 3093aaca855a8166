"""The training batch's wire formats in the port against the JAX package, on
the CPU: ``--train_transfer bf16`` columns and ``packed`` quantized byte rows
packed on the host byte for byte as ``ccsmeth_tpu.training.train`` packs
them, and unpacked on the device bit for bit as its ``_unpack_cols`` /
``_unpack_rows_q`` unpack them, with every optional channel on and off, for
the two-strand and the single-strand layouts; and a short training run in
each wire whose first loss is the fp32 wire's within the wire's rounding."""

import importlib

import jax
import numpy as np
import pytest
import torch

from ccsmeth_tpu.models import AttRNNConfig as JaxAttRNNConfig
from ccsmeth_tpu_torch.models import AttRNNConfig
from ccsmeth_tpu_torch.training import TrainConfig, train
from tests.test_training import _write_feature_tsv

# the modules (each package's ``training.train`` attribute is the function)
T = importlib.import_module("ccsmeth_tpu_torch.training.train")
jax_train = importlib.import_module("ccsmeth_tpu.training.train")

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

OPTIONS = [dict(), dict(is_stds=True), dict(is_sn=True), dict(is_map=True),
           dict(is_stds=True, is_sn=True, is_map=True, is_npass=False)]


def _feats(B, seed, two_strand=True, L=21):
    rng = np.random.RandomState(seed)
    feats = {}
    for s in ("", "2") if two_strand else ("",):
        feats["kmer" + s] = rng.randint(0, 5, (B, L)).astype(np.float32)
        feats["kpass" + s] = rng.randint(1, 40, (B, 1)).repeat(L, 1).astype(np.float32)
        feats["ipd_means" + s] = (rng.randn(B, L) * 3).astype(np.float32)
        feats["pw_means" + s] = (rng.randn(B, L) * 3).astype(np.float32)
        feats["ipd_stds" + s] = rng.rand(B, L).astype(np.float32)
        feats["pw_stds" + s] = rng.rand(B, L).astype(np.float32)
        feats["sns" + s] = (rng.rand(B, 4) * 20).astype(np.float32)
        feats["maps" + s] = rng.rand(B, L).astype(np.float32)
    labels = rng.randint(0, 2, B)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0
    return feats, labels, mask


def _cfgs(opts, model_type):
    kw = dict(num_layers=2, hidden_size=16, model_type=model_type, **opts)
    return AttRNNConfig(**kw), JaxAttRNNConfig(**kw)


def _assert_bit_equal(got, want):
    """torch tensor vs jax array: same dtype width, same bits."""
    a = got.cpu().numpy()
    b = np.asarray(want)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("model_type", ["attbigru2s", "attbigru1s"])
@pytest.mark.parametrize("opts", OPTIONS)
def test_bf16_wire_equals_jax(opts, model_type):
    cfg, jcfg = _cfgs(opts, model_type)
    feats, labels, mask = _feats(11, 1, cfg.two_strand)
    fields = T._batch_layout(cfg)
    assert fields == jax_train._batch_layout(jcfg)
    import ml_dtypes

    want = jax_train._pack_cols(fields, feats, labels, mask,
                                np.dtype(ml_dtypes.bfloat16))
    got = T._pack_cols(fields, feats, labels, mask, "bf16")
    assert got.dtype == np.int16 and got.tobytes() == want.tobytes()
    jf, jl, jm = jax_train._unpack_cols(jax.numpy.asarray(want), fields)
    tf, tl, tm = T._unpack_cols(torch.from_numpy(got), fields)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        _assert_bit_equal(tf[k], jf[k])
    assert tl.tolist() == np.asarray(jl).tolist()
    _assert_bit_equal(tm, jm)


@pytest.mark.parametrize("model_type", ["attbigru2s", "attbilstm2s2", "attbigru1s"])
@pytest.mark.parametrize("opts", OPTIONS)
def test_packed_wire_equals_jax(opts, model_type):
    cfg, jcfg = _cfgs(opts, model_type)
    feats, labels, mask = _feats(13, 2, cfg.two_strand)
    qfields = T._q_fields(cfg)
    assert qfields == jax_train._q_fields(jcfg)
    want = jax_train._pack_rows_q(qfields, feats, labels, mask)
    got = T._pack_rows_q(qfields, feats, labels, mask)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    jf, jl, jm = jax_train._unpack_rows_q(jax.numpy.asarray(want), qfields, jcfg)
    tf, tl, tm = T._unpack_rows_q(torch.from_numpy(got), qfields, cfg)
    assert sorted(tf) == sorted(jf)
    for k in jf:  # the wire-dropped channels as zeros on both sides
        _assert_bit_equal(tf[k].contiguous(), jf[k])
    assert tl.tolist() == np.asarray(jl).tolist()
    _assert_bit_equal(tm, jm)


def test_packed_row_bytes():
    """The flagship two-strand row: 112 bytes packed (kmer 11 + npass 2 +
    ipd 21 + pw 21 a strand, labels and mask), 1,216 in fp32, 608 in bf16."""
    cfg = AttRNNConfig()
    nq = sum(nb for _k, _kind, nb in T._q_fields(cfg)) + 2
    ncol = sum(n for _k, n in T._batch_layout(cfg)) + 2
    assert (nq, 4 * ncol, 2 * ncol) == (112, 1216, 608)


@pytest.mark.parametrize("wire", ["bf16", "packed"])
def test_training_in_each_wire(wire, tmp_path):
    """A short CPU run of attbigru2s in the wire: its first step's loss is
    the fp32 wire's within the wire's rounding (bf16 columns round the
    kinetics to 2^-8 relative, packed rows to 1/32 absolute; the loss moves
    by less than 2e-3), and the run learns the separable set."""
    tr, va = str(tmp_path / "t.tsv"), str(tmp_path / "v.tsv")
    _write_feature_tsv(tr, n=256, seed=0)
    _write_feature_tsv(va, n=96, seed=1)
    runs = {}
    for w in ("fp32", wire):
        runs[w] = train(TrainConfig(
            train_file=tr, valid_file=va, model_dir=str(tmp_path / w),
            layer_rnn=1, hid_rnn=16, batch_size=32, dropout_rate=0.0,
            max_epoch_num=4, min_epoch_num=4, step_interval=1, lr=0.01,
            tseed=3, train_transfer=w, step_fuse=1, device="cpu"))
    first, first_w = runs["fp32"]["train_losses"][0], runs[wire]["train_losses"][0]
    assert first_w != first  # the wire's rounding reaches the loss
    assert abs(first_w - first) < 2e-3, (first, first_w)
    assert runs[wire]["best_accuracy"] >= 0.9, runs[wire]["best_accuracy"]

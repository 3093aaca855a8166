"""Training in the port against the JAX package, on CPU: the full model's loss
and gradients, one optimizer step, dropout, a learning run whose checkpoint
the JAX package loads, resume, and the fused-step schedule; attbigru2s, and
attbilstm2s for the loss, gradients, step and learning run."""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ccsmeth_tpu.models import AttRNNConfig as JaxAttRNNConfig
from ccsmeth_tpu.models import apply_attrnn
from ccsmeth_tpu.models.params_io import load_params as jax_load_params
from ccsmeth_tpu.training.optim import build_optimizer as jax_build_optimizer
from ccsmeth_tpu.training.train import make_train_step as jax_make_train_step
from ccsmeth_tpu.training.train import save_train_state as jax_save_train_state
from ccsmeth_tpu_torch.models import (AttRNN, AttRNNConfig, attrnn_params_from_state_dict,
                                      attrnn_state_dict_from_params, init_attrnn)
from ccsmeth_tpu_torch.models.convert import gc_dims
from ccsmeth_tpu_torch.ops import bigru, bigru_vjp, bilstm_vjp
from ccsmeth_tpu_torch.training import TrainConfig, build_optimizer, train
from ccsmeth_tpu_torch.training.data import load_feature_tsv
from ccsmeth_tpu_torch.training.train import (_fuse_schedule, make_eval_step,
                                              make_train_step, weighted_ce)
from tests.test_training import _write_feature_tsv

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

CFG = dict(num_layers=2, hidden_size=16, dropout_rate=0)


def _feats(B, seed, L=21):
    rng = np.random.RandomState(seed)
    feats = {}
    for s in ("", "2"):
        feats["kmer" + s] = rng.randint(0, 5, (B, L)).astype(np.float32)
        feats["kpass" + s] = rng.randint(3, 25, (B, 1)).repeat(L, 1).astype(np.float32)
        feats["ipd_means" + s] = rng.randn(B, L).astype(np.float32)
        feats["pw_means" + s] = rng.randn(B, L).astype(np.float32)
        feats["ipd_stds" + s] = np.zeros((B, L), np.float32)
        feats["pw_stds" + s] = np.zeros((B, L), np.float32)
        feats["sns" + s] = np.zeros((B, 4), np.float32)
        feats["maps" + s] = np.zeros((B, L), np.float32)
    labels = rng.randint(0, 2, B).astype(np.int32)
    return feats, labels


def _model(params, cfg_kw):
    m = AttRNN(AttRNNConfig(**cfg_kw))
    m.load_state_dict(attrnn_state_dict_from_params(params))
    return m


def _t(feats, labels, mask):
    return ({k: torch.from_numpy(v) for k, v in feats.items()},
            torch.from_numpy(labels).long(), torch.from_numpy(mask))


def _assert_tree_close(got, want, atol, rtol):
    a, b = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(a) == len(b) and len(a) > 0
    for u, v in zip(a, b):
        np.testing.assert_allclose(np.asarray(u), np.asarray(v), atol=atol, rtol=rtol)


def test_full_model_loss_and_grads_match_pallas_vjp():
    params = init_attrnn(3, AttRNNConfig(**CFG))
    feats, labels = _feats(13, seed=1)
    mask = np.ones(13, np.float32)
    mask[[2, 7, 11]] = 0.0
    jcfg = JaxAttRNNConfig(**CFG)

    def loss_fn(p):
        logits, _ = apply_attrnn(p, jcfg, feats, rnn_backend="pallas", train=True,
                                 dropout_rng=None)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        w = jnp.array([1.0, 1.5], jnp.float32)[labels] * mask
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1e-9)

    loss_j, g_j = jax.value_and_grad(loss_fn)(params)
    model = _model(params, CFG)
    ft, lt, mt = _t(feats, labels, mask)
    logits, _ = model(ft, train=True)
    loss = weighted_ce(logits, lt, mt, torch.tensor([1.0, 1.5]))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    g = attrnn_params_from_state_dict(dict(zip(names, grads)))
    assert abs(loss.item() - float(loss_j)) <= 1e-5
    _assert_tree_close(g, g_j, atol=2e-4, rtol=1e-3)


def test_sgd_step_matches_jax_train_step():
    """One step of SGD (lr 1e-2, momentum 0.8, clip 0.5) against JAX's
    make_train_step on its 8-device CPU mesh (default scan backend, the same
    function), B=16."""
    params = init_attrnn(4, AttRNNConfig(**CFG))
    feats, labels = _feats(16, seed=2)
    mask = np.ones(16, np.float32)
    tx = jax_build_optimizer("SGD", 1e-2)
    jstep, _mesh = jax_make_train_step(JaxAttRNNConfig(**CFG), tx, 1.5)
    p_j, _o, loss_j = jstep(params, tx.init(params), feats, labels, mask,
                            jax.random.PRNGKey(0))
    model = _model(params, CFG)
    opt = build_optimizer("SGD", 1e-2)
    opt.init(model.parameters(), gc_dims([n for n, _ in model.named_parameters()]))
    loss = make_train_step(model, opt, 1.5)(*_t(feats, labels, mask))
    assert abs(loss.item() - float(loss_j)) <= 1e-6
    _assert_tree_close(attrnn_params_from_state_dict(model.state_dict()), p_j,
                       atol=1e-6, rtol=0)


def test_dropout_train_step_is_seeded():
    """With dropout 0.5 the step depends on the generator's draws: the same
    seed gives the same step twice, another seed another step; the masks
    keep about half the entries, scaled by 2."""
    cfg = dict(CFG, dropout_rate=0.5)
    params = init_attrnn(5, AttRNNConfig(**cfg))
    feats, labels = _feats(8, seed=3)
    batch = _t(feats, labels, np.ones(8, np.float32))
    out = []
    for seed in (11, 11, 12):
        model = _model(params, cfg)
        opt = build_optimizer("Adam", 1e-3)
        opt.init(model.parameters())
        loss = make_train_step(model, opt, 1.0)(*batch, torch.Generator().manual_seed(seed))
        out.append((loss.item(), model.state_dict()))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(out[0][1][k], out[1][1][k]) for k in out[0][1])
    assert out[0][0] != out[2][0]
    y = bigru_vjp.dropout(torch.ones(100, 100), 0.5, torch.Generator().manual_seed(0))
    assert abs((y != 0).float().mean().item() - 0.5) < 0.02
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}


def test_eval_step_counts():
    params = init_attrnn(6, AttRNNConfig(**CFG))
    feats, labels = _feats(12, seed=4)
    mask = np.ones(12, np.float32)
    mask[-2:] = 0.0
    model = _model(params, CFG)
    bigru.launches = 0
    loss, pred, counts = make_eval_step(model, 1.5)(*_t(feats, labels, mask))
    assert bigru.launches == 0  # CPU tensors: K1's plain version
    _l, probs = apply_attrnn(params, JaxAttRNNConfig(**CFG), feats)
    want = np.argmax(np.asarray(probs), axis=1)
    np.testing.assert_array_equal(pred.numpy(), want)
    v = mask > 0
    tp = int(((want == 1) & (labels == 1) & v).sum())
    fp = int(((want == 1) & (labels == 0) & v).sum())
    fn = int(((want == 0) & (labels == 1) & v).sum())
    assert counts.tolist() == [10.0, float(((want == labels) & v).sum()), tp, fp, fn]
    assert np.isfinite(loss.item())


def test_train_learns_and_jax_loads_the_checkpoint(tmp_path):
    tr, va = str(tmp_path / "train.tsv"), str(tmp_path / "valid.tsv")
    _write_feature_tsv(tr, n=600, seed=1)
    _write_feature_tsv(va, n=120, seed=2)
    result = train(TrainConfig(
        train_file=tr, valid_file=va, model_dir=str(tmp_path / "models"),
        model_type="attbigru2s", layer_rnn=1, hid_rnn=24, batch_size=64,
        dropout_rate=0.1, max_epoch_num=12, min_epoch_num=4, step_interval=5,
        lr=0.01, lr_decay=0.5, lr_decay_step=4, tseed=7, device="cpu"))
    assert result["best_accuracy"] > 0.9
    assert result["steps"] > 0 and np.all(np.isfinite(result["train_losses"]))
    saved = sorted(glob.glob(str(tmp_path / "models" / "attbigru2s.b21_epoch*.ckpt.npz")))
    assert saved
    params = jax_load_params(saved[-1])
    kw = dict(num_layers=1, hidden_size=24, dropout_rate=0)
    data = load_feature_tsv(va)
    feats = {k: v[:32] for k, v in data.items() if k != "labels"}
    _l, p_j = apply_attrnn(params, JaxAttRNNConfig(**kw), feats)
    with torch.inference_mode():
        _l, p_t = _model(params, kw)({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=5e-6)


def test_resume_with_optimizer_state(tmp_path):
    tr, va = str(tmp_path / "tr.tsv"), str(tmp_path / "va.tsv")
    _write_feature_tsv(tr, n=200, seed=1)
    _write_feature_tsv(va, n=60, seed=2)
    base = dict(train_file=tr, valid_file=va, model_type="attbigru2s",
                layer_rnn=1, hid_rnn=16, batch_size=64, dropout_rate=0.1,
                step_interval=3, lr=0.01, tseed=5, save_opt_state=True,
                device="cpu")
    r1 = train(TrainConfig(**base, model_dir=str(tmp_path / "m"), max_epoch_num=2,
                           min_epoch_num=1))
    last = sorted(r1["ckpts"])[-1]
    assert os.path.exists(last.replace(".ckpt.npz", ".train_state.npz"))
    r2 = train(TrainConfig(**base, model_dir=str(tmp_path / "m2"), max_epoch_num=4,
                           min_epoch_num=1, resume_from=last))
    for p in r2["ckpts"]:  # the resumed run starts after the saved epoch
        assert int(re.search(r"epoch(\d+)", p).group(1)) >= 3
    # a train state written by the JAX package is refused with a clear error
    jdir = tmp_path / "jax"
    jdir.mkdir()
    ck = str(jdir / "attbigru2s.b21_epoch1.ckpt.npz")
    with open(last, "rb") as src, open(ck, "wb") as dst:
        dst.write(src.read())
    jax_save_train_state(ck.replace(".ckpt.npz", ".train_state.npz"),
                         optax.adam(1e-3).init(jax_load_params(last)), 1)
    with pytest.raises(ValueError, match="not a train state written by ccsmeth_tpu_torch"):
        train(TrainConfig(**base, model_dir=str(tmp_path / "m3"), max_epoch_num=2,
                          min_epoch_num=1, resume_from=ck))


def test_step_fuse_matches_single_step(tmp_path):
    """step_fuse=3 (groups of 3 batches per copy, run in turn) gives the same
    losses and checkpoint bit for bit as step_fuse=1."""
    tr, va = str(tmp_path / "train.tsv"), str(tmp_path / "valid.tsv")
    _write_feature_tsv(tr, n=300, seed=5)
    _write_feature_tsv(va, n=60, seed=6)
    res = {}
    for fuse in (1, 3):
        mdir = str(tmp_path / "m{}".format(fuse))
        r = train(TrainConfig(
            train_file=tr, valid_file=va, model_dir=mdir, layer_rnn=1, hid_rnn=16,
            batch_size=32, dropout_rate=0.3, max_epoch_num=2, min_epoch_num=2,
            step_interval=7, lr=0.01, tseed=11, step_fuse=fuse, device="cpu"))
        res[fuse] = (r, sorted(glob.glob(mdir + "/attbigru2s.b21_epoch*.ckpt.npz")))
    (r1, ck1), (r3, ck3) = res[1], res[3]
    assert r1["train_losses"] == r3["train_losses"]
    assert [os.path.basename(p) for p in ck1] == [os.path.basename(p) for p in ck3]
    a, b = np.load(ck1[-1]), np.load(ck3[-1])
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    assert list(_fuse_schedule(20, 7, 3)) == [3, 3, 1, 3, 3, 1, 3, 3]


@pytest.mark.parametrize("kw", [dict(model_type="attbilstm1s", num_processes=2),
                                dict(train_transfer="packed",
                                     dist_coordinator="localhost:1234"),
                                dict(num_processes=2),
                                dict(dist_coordinator="localhost:1234")])
def test_unported_options_raise(kw, tmp_path):
    """More than one process needs a coordinator, and a coordinator more
    than one process (trainm across processes is ported; a half-given
    layout is refused)."""
    with pytest.raises(ValueError, match="--dist_coordinator host:port go together"):
        train(TrainConfig(train_file="x", valid_file="y", device="cpu",
                          model_dir=str(tmp_path), **kw))


def test_binary_metrics_match_jax():
    from ccsmeth_tpu.training.train import binary_metrics as jax_binary_metrics
    from ccsmeth_tpu_torch.training.train import binary_metrics

    rng = np.random.RandomState(9)
    for n in (0, 1, 57):
        labels, preds = rng.randint(0, 2, n), rng.randint(0, 2, n)
        assert binary_metrics(labels, preds) == jax_binary_metrics(labels, preds)


def test_streaming_loader_trains(tmp_path):
    """dl_offsets=True: the out-of-core loader feeds train() and the valid set
    streams instead of staying on the device."""
    tr, va = str(tmp_path / "t.tsv"), str(tmp_path / "v.tsv")
    _write_feature_tsv(tr, n=400, seed=0)
    _write_feature_tsv(va, n=100, seed=1)
    r = train(TrainConfig(train_file=tr, valid_file=va, model_dir=str(tmp_path / "m"),
                          layer_rnn=1, hid_rnn=16, batch_size=64, max_epoch_num=2,
                          min_epoch_num=1, step_interval=4, dl_offsets=True,
                          device="cpu"))
    assert r["steps"] == 2 * 7 and r["ckpts"]
    assert np.all(np.isfinite(r["valid_losses"]))


LSTM = dict(CFG, model_type="attbilstm2s")


def test_lstm_full_model_loss_and_grads_match_pallas_vjp():
    """attbilstm2s: the port's loss and every gradient leaf (K6's plain
    versions through BiLSTMLayerFn) against jax.grad through the JAX
    package's custom-VJP LSTM kernels in interpret mode; the gate of
    tests/test_pallas_vjp.py, atol 2e-4 / rtol 1e-3."""
    params = init_attrnn(3, AttRNNConfig(**LSTM))
    feats, labels = _feats(13, seed=1)
    mask = np.ones(13, np.float32)
    mask[[2, 7, 11]] = 0.0
    jcfg = JaxAttRNNConfig(**LSTM)

    def loss_fn(p):
        logits, _ = apply_attrnn(p, jcfg, feats, rnn_backend="pallas", train=True,
                                 dropout_rng=None)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        w = jnp.array([1.0, 1.5], jnp.float32)[labels] * mask
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1e-9)

    loss_j, g_j = jax.value_and_grad(loss_fn)(params)
    model = _model(params, LSTM)
    ft, lt, mt = _t(feats, labels, mask)
    before = (bigru_vjp.launches_fwd, bilstm_vjp.plain_calls)
    logits, _ = model(ft, train=True)
    loss = weighted_ce(logits, lt, mt, torch.tensor([1.0, 1.5]))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    g = attrnn_params_from_state_dict(dict(zip(names, grads)))
    assert abs(loss.item() - float(loss_j)) <= 1e-5
    _assert_tree_close(g, g_j, atol=2e-4, rtol=1e-3)
    # the LSTM went through K6's plain versions, one forward and one
    # backward a layer, and not through the GRU's
    assert (bigru_vjp.launches_fwd, bilstm_vjp.plain_calls) == (
        before[0], before[1] + 2 * LSTM["num_layers"])


def test_lstm_sgd_step_matches_jax_train_step():
    """One step of SGD (lr 1e-2, momentum 0.8, clip 0.5) on attbilstm2s
    against JAX's make_train_step on its 8-device CPU mesh (default scan
    backend, the same function), B=16."""
    params = init_attrnn(4, AttRNNConfig(**LSTM))
    feats, labels = _feats(16, seed=2)
    mask = np.ones(16, np.float32)
    tx = jax_build_optimizer("SGD", 1e-2)
    jstep, _mesh = jax_make_train_step(JaxAttRNNConfig(**LSTM), tx, 1.5)
    p_j, _o, loss_j = jstep(params, tx.init(params), feats, labels, mask,
                            jax.random.PRNGKey(0))
    model = _model(params, LSTM)
    opt = build_optimizer("SGD", 1e-2)
    opt.init(model.parameters(), gc_dims([n for n, _ in model.named_parameters()]))
    loss = make_train_step(model, opt, 1.5)(*_t(feats, labels, mask))
    assert abs(loss.item() - float(loss_j)) <= 1e-6
    _assert_tree_close(attrnn_params_from_state_dict(model.state_dict()), p_j,
                       atol=1e-6, rtol=0)


def test_lstm_train_learns_and_jax_loads_the_checkpoint(tmp_path):
    tr, va = str(tmp_path / "train.tsv"), str(tmp_path / "valid.tsv")
    _write_feature_tsv(tr, n=600, seed=1)
    _write_feature_tsv(va, n=120, seed=2)
    result = train(TrainConfig(
        train_file=tr, valid_file=va, model_dir=str(tmp_path / "models"),
        model_type="attbilstm2s", layer_rnn=1, hid_rnn=24, batch_size=64,
        dropout_rate=0.1, max_epoch_num=12, min_epoch_num=4, step_interval=5,
        lr=0.01, lr_decay=0.5, lr_decay_step=4, tseed=7, device="cpu"))
    assert result["best_accuracy"] > 0.9
    assert result["steps"] > 0 and np.all(np.isfinite(result["train_losses"]))
    saved = sorted(glob.glob(str(tmp_path / "models" / "attbilstm2s.b21_epoch*.ckpt.npz")))
    assert saved
    params = jax_load_params(saved[-1])
    assert np.asarray(params["rnn"][0]["fwd"]["w_hh"]).shape == (4 * 24, 24)
    kw = dict(num_layers=1, hidden_size=24, dropout_rate=0, model_type="attbilstm2s")
    data = load_feature_tsv(va)
    feats = {k: v[:32] for k, v in data.items() if k != "labels"}
    _l, p_j = apply_attrnn(params, JaxAttRNNConfig(**kw), feats)
    with torch.inference_mode():
        _l, p_t = _model(params, kw)({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=5e-6)

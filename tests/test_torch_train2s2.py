"""Training attbigru2s2 and attbilstm2s2 in the port against the JAX package,
on CPU: the loss and every gradient leaf with the SrcEmbed BatchNorms on the
batch's statistics (pad rows included), one step of each of the five
optimizers with the running stats left as loaded, and a short run whose
checkpoint the JAX package loads and which warm-starts from the JAX
package's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ccsmeth_tpu.models import AttRNNConfig as JaxAttRNNConfig
from ccsmeth_tpu.models import apply_attrnn
from ccsmeth_tpu.models.params_io import load_params as jax_load_params
from ccsmeth_tpu.models.params_io import save_params as jax_save_params
from ccsmeth_tpu.parallel.mesh import data_mesh
from ccsmeth_tpu.training.optim import build_optimizer as jax_build_optimizer
from ccsmeth_tpu.training.train import make_train_step as jax_make_train_step
from ccsmeth_tpu_torch.models import (AttRNN, AttRNNConfig, attrnn_params_from_state_dict,
                                      attrnn_state_dict_from_params, init_attrnn)
from ccsmeth_tpu_torch.models.convert import gc_dims
from ccsmeth_tpu_torch.models.params_io import _flatten
from ccsmeth_tpu_torch.training import TrainConfig, build_optimizer, train
from ccsmeth_tpu_torch.training.data import load_feature_tsv
from ccsmeth_tpu_torch.training.train import make_train_step, weighted_ce
from tests.test_training import _write_feature_tsv

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

SMALL = dict(num_layers=2, hidden_size=16, dropout_rate=0)
FLAGS = {"default": {}, "stds_sn_map": dict(is_stds=True, is_sn=True, is_map=True)}


def _kw(model_type, flags, **extra):
    return dict(SMALL, model_type=model_type, **FLAGS[flags], **extra)


def _batch(B, n_valid, seed, L=21):
    """A batch of B rows whose last B - n_valid are padding: zero features,
    label 0, mask 0 (as the loader pads), which the BatchNorm statistics
    still count."""
    rng = np.random.RandomState(seed)
    feats = {}
    for s in ("", "2"):
        feats["kmer" + s] = rng.randint(0, 5, (B, L)).astype(np.float32)
        feats["kpass" + s] = rng.randint(1, 35, (B, 1)).repeat(L, 1).astype(np.float32)
        feats["ipd_means" + s] = (rng.randn(B, L) * 3).astype(np.float32)
        feats["pw_means" + s] = (rng.randn(B, L) * 3).astype(np.float32)
        feats["ipd_stds" + s] = rng.rand(B, L).astype(np.float32)
        feats["pw_stds" + s] = rng.rand(B, L).astype(np.float32)
        feats["sns" + s] = (rng.rand(B, 4) * 10).astype(np.float32)
        feats["maps" + s] = rng.randint(0, 8, (B, L)).astype(np.float32)
    labels = rng.randint(0, 2, B).astype(np.int32)
    mask = np.ones(B, np.float32)
    mask[n_valid:] = 0.0
    for v in feats.values():
        v[n_valid:] = 0.0
    labels[n_valid:] = 0
    return feats, labels, mask


def _model(params, kw):
    m = AttRNN(AttRNNConfig(**kw))
    m.load_state_dict(attrnn_state_dict_from_params(params))
    return m


def _t(feats, labels, mask):
    return ({k: torch.from_numpy(v) for k, v in feats.items()},
            torch.from_numpy(labels).long(), torch.from_numpy(mask))


def _bn_stats(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree)
            if k.endswith("/mean") or k.endswith("/var")}


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("model_type", ["attbigru2s2", "attbilstm2s2"])
def test_loss_and_grads_match_jax(model_type, flags):
    """jax.value_and_grad of apply_attrnn(train=True) (the XLA scan; the
    BatchNorms on the batch's statistics) against the port's autograd
    through the training kernels' plain versions: the loss to 1e-5, every
    gradient leaf at atol 2e-4 / rtol 1e-3; the running stats get a zero
    gradient in JAX and none in the port."""
    kw = _kw(model_type, flags)
    params = init_attrnn(3, AttRNNConfig(**kw))
    feats, labels, mask = _batch(13, 10, seed=1)
    jcfg = JaxAttRNNConfig(**kw)

    def loss_fn(p):
        logits, _ = apply_attrnn(p, jcfg, feats, train=True, dropout_rng=None)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        w = jnp.array([1.0, 1.5], jnp.float32)[labels] * mask
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1e-9)

    loss_j, g_j = jax.value_and_grad(loss_fn)(params)
    model = _model(params, kw)
    logits, _ = model(_t(feats, labels, mask)[0], train=True)
    loss = weighted_ce(logits, *_t(feats, labels, mask)[1:], torch.tensor([1.0, 1.5]))
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    sd = {k: grads.get(k, torch.zeros_like(v)) for k, v in model.state_dict().items()}
    g = dict(_flatten(attrnn_params_from_state_dict(sd)))
    want = dict(_flatten(g_j))
    assert abs(loss.item() - float(loss_j)) <= 1e-5
    assert g.keys() == want.keys()
    for k in g:
        np.testing.assert_allclose(g[k], np.asarray(want[k]), atol=2e-4, rtol=1e-3,
                                   err_msg=k)
    stats = _bn_stats(g_j)
    assert bool(stats) == (flags == "stds_sn_map")
    assert all(not v.any() for v in stats.values())


@pytest.mark.parametrize("optim", ["Adam", "RMSprop", "SGD", "Ranger", "LookaheadAdam"])
def test_one_step_of_each_optimizer_matches_jax(optim):
    """One step (lr 1e-2, clip 0.5, pos_weight 1.5) against JAX's
    make_train_step on a one-device mesh (whose BatchNorm statistics are the
    whole batch's, as on one card), attbigru2s2 with stds, sn and map and a
    padded batch: the params at atol 1e-6, the BatchNorm running stats equal
    to the loaded ones in both packages. One exception, by conditioning: at
    most four elements whose gradient is not 0 but below 1e-6 (SrcEmbed conv
    weights here, one at 3e-7) may differ by up to 1e-2 of lr, since Adam's
    first update lr g / (|g| + 1e-8) moves by ~1e3 for each unit of g there,
    and a conv gradient summed in another order than XLA's, with that much
    cancellation, differs at ~1% of itself."""
    kw = _kw("attbigru2s2", "stds_sn_map", num_layers=1, hidden_size=8)
    params = init_attrnn(4, AttRNNConfig(**kw))
    rng = np.random.RandomState(2)
    for k, v in _flatten(params):  # running stats that are not 0 and 1
        node = params
        parts = k.split("/")
        for p in parts[:-1]:
            node = node[int(p)] if isinstance(node, list) else node[p]
        if parts[-1] in ("mean", "var"):
            node[parts[-1]] = (rng.uniform(0.5, 1.5, v.shape) if parts[-1] == "var"
                               else rng.randn(*v.shape) * 0.1).astype(np.float32)
    before = _bn_stats(params)
    feats, labels, mask = _batch(16, 13, seed=2)
    tx = jax_build_optimizer(optim, 1e-2)
    jstep, _mesh = jax_make_train_step(JaxAttRNNConfig(**kw), tx, 1.5,
                                       mesh=data_mesh(jax.devices()[:1]))
    p_j, _o, loss_j = jstep(params, tx.init(params), feats, labels, mask,
                            jax.random.PRNGKey(0))
    model = _model(params, kw)
    opt = build_optimizer(optim, 1e-2)
    opt.init(model.parameters(), gc_dims([n for n, _ in model.named_parameters()]))
    loss = make_train_step(model, opt, 1.5)(*_t(feats, labels, mask))
    assert abs(loss.item() - float(loss_j)) <= 1e-6
    got = dict(_flatten(attrnn_params_from_state_dict(model.state_dict())))
    want = dict(_flatten(p_j))
    jcfg = JaxAttRNNConfig(**kw)

    def loss_fn(p):
        logits, _ = apply_attrnn(p, jcfg, feats, train=True)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        w = jnp.array([1.0, 1.5], jnp.float32)[labels] * mask
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1e-9)

    grads = dict(_flatten(jax.grad(loss_fn)(params)))
    assert got.keys() == want.keys()
    n_off = 0
    for k in got:
        diff = np.abs(got[k] - np.asarray(want[k]))
        off = diff > 1e-6
        gk = np.abs(np.asarray(grads[k]))[off]
        assert ((gk > 0) & (gk < 1e-6)).all() and (diff[off] <= 1e-4).all(), k
        n_off += int(off.sum())
    assert n_off <= 4
    for stats in (_bn_stats(p_j), _bn_stats(attrnn_params_from_state_dict(
            model.state_dict()))):
        assert stats.keys() == before.keys() and before
        for k in before:
            np.testing.assert_array_equal(stats[k], before[k], err_msg=k)
    assert not torch.equal(model.classifier[0].weight,
                           torch.from_numpy(np.ascontiguousarray(
                               params["classifier"][0]["w"].T)))


@pytest.mark.parametrize("model_type", ["attbigru2s2", "attbilstm2s2"])
def test_train_run_checkpoints_load_both_ways(model_type, tmp_path):
    """train --model_type 2s2 on the CPU with a warm start from a .ckpt.npz
    written by the JAX package: the first step starts from its params
    (a zero-lr run keeps them to the bit), and the run's checkpoint gives
    the port's probs through the JAX package's apply_attrnn."""
    tr, va = str(tmp_path / "train.tsv"), str(tmp_path / "valid.tsv")
    _write_feature_tsv(tr, n=96, seed=1)
    _write_feature_tsv(va, n=32, seed=2)
    kw = _kw(model_type, "default", num_layers=1, hidden_size=8)
    init = str(tmp_path / "init.ckpt.npz")
    jax_save_params(init, init_attrnn(9, AttRNNConfig(**kw)))
    base = dict(train_file=tr, valid_file=va, model_type=model_type, layer_rnn=1,
                hid_rnn=8, batch_size=32, dropout_rate=0.1, max_epoch_num=1,
                min_epoch_num=1, step_interval=2, tseed=3, init_model=init,
                device="cpu")
    frozen = train(TrainConfig(**base, model_dir=str(tmp_path / "m0"), lr=0.0))
    a = dict(_flatten(jax_load_params(frozen["ckpts"][-1])))
    b = jax_load_params(init)
    assert a.keys() == dict(_flatten(b)).keys()
    for k, v in _flatten(b):
        np.testing.assert_array_equal(a[k], v, err_msg=k)
    result = train(TrainConfig(**base, model_dir=str(tmp_path / "m"), lr=0.01))
    assert result["steps"] == 3 and np.all(np.isfinite(result["train_losses"]))
    saved = result["ckpts"][-1]
    assert os.path.basename(saved).startswith(model_type + ".b21_epoch1")
    params = jax_load_params(saved)
    data = load_feature_tsv(va)
    feats = {k: v for k, v in data.items() if k != "labels"}
    _l, p_j = apply_attrnn(params, JaxAttRNNConfig(**dict(kw, dropout_rate=0)), feats)
    with torch.inference_mode():
        _l, p_t = _model(params, kw).eval()({k: torch.from_numpy(v)
                                              for k, v in feats.items()})
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=5e-6)
    assert not np.array_equal(np.asarray(params["classifier"][0]["w"]),
                              np.asarray(b["classifier"][0]["w"]))

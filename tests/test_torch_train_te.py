"""Training transencoder2s in the port against the JAX package, on the CPU:
the loss and every gradient leaf of the training forward (the SrcEmbeds on
each strand's batch statistics, the encoder in PyTorch ops with autograd)
in fp32 and, at a stated tolerance, bf16; one step of SGD and of Ranger
(whose gradient centralization splits the attention's in_proj into the JAX
package's wq, wk and wv); a short run whose checkpoint the JAX package loads
and which warm-starts from the JAX package's; and the embedding lookups'
fixed-order backward, which every training path's tables go through."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ccsmeth_tpu.models import TransEncConfig as JaxTransEncConfig
from ccsmeth_tpu.models.params_io import load_params as jax_load_params
from ccsmeth_tpu.models.params_io import save_params as jax_save_params
from ccsmeth_tpu.models.transenc import apply_transenc
from ccsmeth_tpu.parallel.mesh import data_mesh
from ccsmeth_tpu.training.optim import build_optimizer as jax_build_optimizer
from ccsmeth_tpu.training.train import make_train_step as jax_make_train_step
from ccsmeth_tpu_torch.models import (TransEnc, TransEncConfig, init_transenc,
                                      transenc_params_from_state_dict,
                                      transenc_state_dict_from_params)
from ccsmeth_tpu_torch.models.attrnn import embed_rows, take_rows
from ccsmeth_tpu_torch.models.convert import gc_dims
from ccsmeth_tpu_torch.models.params_io import _flatten
from ccsmeth_tpu_torch.models.transenc import randomize_affine
from ccsmeth_tpu_torch.ops import transenc as transenc_ops
from ccsmeth_tpu_torch.training import TrainConfig, build_optimizer, train
from ccsmeth_tpu_torch.training.data import load_feature_tsv
from ccsmeth_tpu_torch.training.train import make_train_step, weighted_ce
from tests.test_training import _write_feature_tsv

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

SMALL = dict(num_layers=2, d_model=16, nhead=2, dim_ff=32, dropout_rate=0.0)
FLAGS = {"default": {}, "stds_sn_map": dict(is_stds=True, is_sn=True, is_map=True)}


def _batch(B, n_valid, seed, L=21):
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


def _setup(flags, seed=3):
    cfg = TransEncConfig(**SMALL, **FLAGS[flags])
    params = randomize_affine(init_transenc(seed, cfg), seed)
    model = TransEnc(cfg)
    model.load_state_dict(transenc_state_dict_from_params(params))
    return cfg, JaxTransEncConfig(**SMALL, **FLAGS[flags]), params, model


def _t(feats, labels, mask):
    return ({k: torch.from_numpy(v) for k, v in feats.items()},
            torch.from_numpy(labels).long(), torch.from_numpy(mask))


def _grads(model, cfg, feats, labels, mask, dt):
    """The port's loss and its gradients as a params pytree (the BatchNorm
    running stats, which get none, as zeros)."""
    ft, lt, mt = _t(feats, labels, mask)
    logits, _ = model(ft, dt, train=True)
    loss = weighted_ce(logits, lt, mt, torch.tensor([1.0, 1.5]))
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    sd = {k: grads.get(k, torch.zeros_like(v)) for k, v in model.state_dict().items()}
    return loss.item(), dict(_flatten(transenc_params_from_state_dict(sd, cfg)))


def _jax_grads(params, jcfg, feats, labels, mask, jdt):
    def loss_fn(p):
        logits, _ = apply_transenc(p, jcfg, feats, dropout_rng=jax.random.PRNGKey(0),
                                   train=True, compute_dtype=jdt)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        w = jnp.array([1.0, 1.5], jnp.float32)[labels] * mask
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1e-9)

    loss, g = jax.value_and_grad(loss_fn)(params)
    return float(loss), {k: np.asarray(v) for k, v in _flatten(g)}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_loss_and_grads_match_jax_fp32(flags):
    """jax.value_and_grad of apply_transenc(train=True) (dropout 0) against
    the port's training forward through autograd: the loss to 1e-5, every
    gradient leaf at atol 2e-4 / rtol 1e-3."""
    cfg, jcfg, params, model = _setup(flags)
    feats, labels, mask = _batch(11, 9, seed=1)
    loss, g = _grads(model, cfg, feats, labels, mask, torch.float32)
    loss_j, want = _jax_grads(params, jcfg, feats, labels, mask, jnp.float32)
    assert abs(loss - loss_j) <= 1e-5
    assert g.keys() == want.keys()
    for k in g:
        np.testing.assert_allclose(g[k], want[k], atol=2e-4, rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("flags", list(FLAGS))
def test_loss_and_grads_match_jax_bf16(flags):
    """The same under bf16 products (operands rounded to bf16, sums in f32,
    JAX ``_dot``): the loss to 1e-4 and every gradient leaf at atol 1e-3 /
    rtol 1e-2, since an f32 sum taken in another order can round a product
    operand of the next layer to the neighbouring bf16 value (2^-8 of it)."""
    cfg, jcfg, params, model = _setup(flags, seed=5)
    feats, labels, mask = _batch(11, 9, seed=2)
    loss, g = _grads(model, cfg, feats, labels, mask, torch.bfloat16)
    loss_j, want = _jax_grads(params, jcfg, feats, labels, mask, jnp.bfloat16)
    assert abs(loss - loss_j) <= 1e-4
    for k in g:
        np.testing.assert_allclose(g[k], want[k], atol=1e-3, rtol=1e-2, err_msg=k)


@pytest.mark.parametrize("optim", ["SGD", "Ranger"])
def test_one_step_matches_jax_train_step(optim):
    """One step (lr 1e-2, clip 0.5, pos_weight 1.5) against JAX's
    make_train_step on a one-device mesh: the loss to 1e-6, the params at
    atol 5e-6, the running stats as loaded in both."""
    cfg, jcfg, params, model = _setup("stds_sn_map", seed=7)
    feats, labels, mask = _batch(12, 10, seed=3)
    tx = jax_build_optimizer(optim, 1e-2)
    jstep, _mesh = jax_make_train_step(jcfg, tx, 1.5, mesh=data_mesh(jax.devices()[:1]))
    p_j, _o, loss_j = jstep(params, tx.init(params), feats, labels, mask,
                            jax.random.PRNGKey(0))
    opt = build_optimizer(optim, 1e-2)
    opt.init(model.parameters(), gc_dims([n for n, _ in model.named_parameters()]))
    loss = make_train_step(model, opt, 1.5)(*_t(feats, labels, mask))
    assert abs(loss.item() - float(loss_j)) <= 1e-6
    got = dict(_flatten(transenc_params_from_state_dict(model.state_dict(), cfg)))
    want = dict(_flatten(p_j))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=5e-6, rtol=0,
                                   err_msg=k)
    for k, v in _flatten(params):
        if k.endswith("/mean") or k.endswith("/var"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_train_run_checkpoints_load_both_ways(tmp_path):
    """train --model_type transencoder2s on the CPU, warm-started from a
    .ckpt.npz written by the JAX package (--init_model, and --resume_from
    with no train state beside it): a zero-lr run keeps it to the bit, and
    a run's checkpoint gives the port's probs (through K3's plain version)
    through the JAX package's apply_transenc."""
    tr, va = str(tmp_path / "train.tsv"), str(tmp_path / "valid.tsv")
    _write_feature_tsv(tr, n=96, seed=1)
    _write_feature_tsv(va, n=32, seed=2)
    cfg = TransEncConfig(**SMALL)
    init = str(tmp_path / "init.ckpt.npz")
    jax_save_params(init, init_transenc(9, cfg))
    base = dict(train_file=tr, valid_file=va, model_type="transencoder2s",
                layer_trans=2, d_model=16, nhead=2, dim_ff=32, batch_size=32,
                dropout_rate=0.1, max_epoch_num=1, min_epoch_num=1, step_interval=2,
                tseed=3, init_model=init, device="cpu")
    transenc_ops.launches = transenc_ops.plain_calls = 0
    frozen = train(TrainConfig(**base, model_dir=str(tmp_path / "m0"), lr=0.0))
    assert transenc_ops.launches == 0 and transenc_ops.plain_calls > 0  # validation
    resumed = train(TrainConfig(**dict(base, init_model=None, resume_from=init),
                                model_dir=str(tmp_path / "m1"), lr=0.0))
    for run in (frozen, resumed):  # --init_model and --resume_from alike
        a = dict(_flatten(jax_load_params(run["ckpts"][-1])))
        for k, v in _flatten(jax_load_params(init)):
            np.testing.assert_array_equal(a[k], v, err_msg=k)
    result = train(TrainConfig(**base, model_dir=str(tmp_path / "m"), lr=0.01))
    assert result["steps"] == 3 and np.all(np.isfinite(result["train_losses"]))
    params = jax_load_params(result["ckpts"][-1])
    data = load_feature_tsv(va)
    feats = {k: v for k, v in data.items() if k != "labels"}
    _l, p_j = apply_transenc(params, JaxTransEncConfig(**SMALL), feats)
    model = TransEnc(cfg)
    model.load_state_dict(transenc_state_dict_from_params(params))
    with torch.inference_mode():
        _l, p_t = model({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=5e-6)


def test_embed_rows_backward_is_fixed_order():
    """``embed_rows``' table gradient equals F.embedding's to f32 rounding,
    over more positions than one chunk of its one-hot product, and is
    bit-equal on a rerun; ``take_rows``' NaN rows (indices outside the
    table) give no gradient."""
    from ccsmeth_tpu_torch.models import attrnn

    g = torch.Generator().manual_seed(0)
    table = torch.randn(953, 8, generator=g, requires_grad=True)
    idx = torch.randint(0, 953, (attrnn.EMBED_GRAD_CHUNK + 1000,), generator=g)
    up = torch.randn(idx.numel(), 8, generator=g)
    a, = torch.autograd.grad(embed_rows(table, idx), table, up)
    b, = torch.autograd.grad(embed_rows(table, idx), table, up)
    ref, = torch.autograd.grad(F.embedding(idx, table), table, up)
    assert torch.equal(a, b)
    torch.testing.assert_close(a, ref, atol=1e-4, rtol=1e-5)
    small = torch.randn(5, 3, requires_grad=True)
    fidx = torch.tensor([[0.0, 4.9, 7.0, -1.0, -6.0]])
    rows = take_rows(small, fidx)
    assert torch.isnan(rows[0, 2]).all() and torch.isnan(rows[0, 4]).all()
    gs, = torch.autograd.grad(torch.nan_to_num(rows).sum(), small)
    assert gs.tolist() == [[1.0] * 3, [0.0] * 3, [0.0] * 3, [0.0] * 3, [2.0] * 3]


def test_running_statistics_stay_as_loaded_as_in_the_jax_trainer(tmp_path):
    """Both packages' trainers on the same small transencoder2s run: the
    training loss falls while the SrcEmbed BatchNorms' running statistics
    in every checkpoint stay as initialised (mean 0, variance 1), in both.
    Validation normalises with them, so a trained model meets statistics it
    never saw (ROADMAP.md Queue 3: a fault of the JAX package that the port
    keeps for parity; on the card its validation sits at chance)."""
    from ccsmeth_tpu.training.train import TrainConfig as JaxTrainConfig
    from ccsmeth_tpu.training.train import train as jax_train

    tr, va = str(tmp_path / "train.tsv"), str(tmp_path / "valid.tsv")
    _write_feature_tsv(tr, n=512, seed=1)
    _write_feature_tsv(va, n=128, seed=2)
    kw = dict(train_file=tr, valid_file=va, model_type="transencoder2s",
              layer_trans=1, d_model=16, nhead=2, dim_ff=32, batch_size=64,
              dropout_rate=0.0, max_epoch_num=2, min_epoch_num=2, step_interval=4,
              lr=0.01, tseed=5)
    port = train(TrainConfig(**kw, model_dir=str(tmp_path / "port"), device="cpu"))
    want = jax_train(JaxTrainConfig(**kw, model_dir=str(tmp_path / "jax")))
    assert port["train_losses"][-1] < 0.5 * port["train_losses"][0]
    for ckpt in port["ckpts"] + want["ckpts"]:
        stats = {k: v for k, v in _flatten(jax_load_params(ckpt))
                 if k.startswith("trans_input") and k.endswith(("/mean", "/var"))}
        assert len(stats) == 6, stats.keys()  # bn1, bn2 and the plus block's
        for k, v in stats.items():
            np.testing.assert_array_equal(v, 0.0 if k.endswith("mean") else 1.0,
                                          err_msg=k)

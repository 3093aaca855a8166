"""The single-strand families attbigru1s and attbilstm1s in the port against
the JAX package, on the CPU: the forward equal to ``apply_attrnn_ss``, the
loss and every gradient leaf, one step of each of the five optimizers
against the JAX ``make_train_step``, checkpoints both ways (the JAX
package's ``.ckpt.npz`` and the reference's ``.ckpt``), and ``trainm`` on a
single-strand features TSV; ``call_mods`` keeps refusing them and
``trainm`` refuses more than one process."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ccsmeth_tpu.models import AttRNNConfig as JaxAttRNNConfig
from ccsmeth_tpu.models import apply_attrnn_ss
from ccsmeth_tpu.models.params_io import load_params as jax_load_params
from ccsmeth_tpu.models.params_io import save_params as jax_save_params
from ccsmeth_tpu.parallel.mesh import data_mesh
from ccsmeth_tpu.training.optim import build_optimizer as jax_build_optimizer
from ccsmeth_tpu.training.train import make_train_step as jax_make_train_step
from ccsmeth_tpu_torch import cli
from ccsmeth_tpu_torch.models import (AttRNN, AttRNNConfig, attrnn_params_from_state_dict,
                                      attrnn_state_dict_from_params, init_attrnn,
                                      torch_ckpt_to_params)
from ccsmeth_tpu_torch.models.convert import gc_dims
from ccsmeth_tpu_torch.models.params_io import _flatten
from ccsmeth_tpu_torch.pipeline.call_mods import CallModsConfig
from ccsmeth_tpu_torch.training import build_optimizer
from ccsmeth_tpu_torch.training.data import load_feature_tsv
from ccsmeth_tpu_torch.training.train import LAST_RUN, make_train_step, weighted_ce

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

FAMILIES = ["attbigru1s", "attbilstm1s"]


def _kw(model_type, **extra):
    return dict(dict(num_layers=2, hidden_size=16, dropout_rate=0), model_type=model_type,
                **extra)


def _batch(B, n_valid, seed, L=21):
    """One strand's rows, the last B - n_valid padding (zero features,
    label 0, mask 0)."""
    rng = np.random.RandomState(seed)
    feats = {"kmer": rng.randint(0, 5, (B, L)).astype(np.float32),
             "kpass": rng.randint(1, 35, (B, 1)).repeat(L, 1).astype(np.float32),
             "ipd_means": rng.randn(B, L).astype(np.float32),
             "pw_means": rng.randn(B, L).astype(np.float32),
             "ipd_stds": rng.rand(B, L).astype(np.float32),
             "pw_stds": rng.rand(B, L).astype(np.float32),
             "sns": (rng.rand(B, 4) * 10).astype(np.float32),
             "maps": rng.rand(B, L).astype(np.float32)}
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


def _write_ss_tsv(path, n, seed, L=21):
    """Separable single-strand features (FeaData3ss, 14 columns): label-1
    rows get an ipd shift at the centre."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            label = i % 2
            kmer = "".join(rng.choice(list("ACGT"), L))
            ipd = rng.randn(L)
            if label:
                ipd[8:13] += 2.5
            f.write("\t".join([
                "chr1", str(i), "+", "r/{}/ccs".format(i), str(i), kmer, "9",
                ",".join(str(round(x, 6)) for x in ipd), ".",
                ",".join(str(round(x, 6)) for x in rng.randn(L)), ".", ".",
                ".", str(label)]) + "\n")


@pytest.mark.parametrize("opts", [{}, dict(is_stds=True, is_sn=True, is_map=True)])
@pytest.mark.parametrize("model_type", FAMILIES)
def test_forward_matches_apply_attrnn_ss(model_type, opts):
    """Inference (K1's plain version on the CPU): probs to 1e-6."""
    kw = _kw(model_type, **opts)
    params = init_attrnn(7, AttRNNConfig(**kw))
    assert params["fc1"]["w"].shape == (2 * 16, 2)  # the head over 2H
    feats, _labels, _mask = _batch(9, 9, seed=3)
    _l, p_j = apply_attrnn_ss(params, JaxAttRNNConfig(**kw), feats)
    with torch.inference_mode():
        _l, p_t = _model(params, kw)({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)


@pytest.mark.parametrize("model_type", FAMILIES)
def test_loss_and_grads_match_jax(model_type):
    """jax.value_and_grad of apply_attrnn_ss(train=True) against the port's
    autograd through the training kernels' plain versions (K4/K5 or K6),
    dropout 0: the loss to 1e-5, every gradient leaf at atol 2e-4 / rtol
    1e-3."""
    kw = _kw(model_type)
    params = init_attrnn(3, AttRNNConfig(**kw))
    feats, labels, mask = _batch(13, 10, seed=1)
    jcfg = JaxAttRNNConfig(**kw)

    def loss_fn(p):
        logits, _ = apply_attrnn_ss(p, jcfg, feats, train=True, dropout_rng=None)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        w = jnp.array([1.0, 1.5], jnp.float32)[labels] * mask
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1e-9)

    loss_j, g_j = jax.value_and_grad(loss_fn)(params)
    model = _model(params, kw)
    ft, lt, mt = _t(feats, labels, mask)
    logits, _ = model(ft, train=True)
    loss = weighted_ce(logits, lt, mt, torch.tensor([1.0, 1.5]))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    g = dict(_flatten(attrnn_params_from_state_dict(dict(zip(names, grads)))))
    want = dict(_flatten(g_j))
    assert abs(loss.item() - float(loss_j)) <= 1e-5
    assert g.keys() == want.keys()
    for k in g:
        np.testing.assert_allclose(g[k], np.asarray(want[k]), atol=2e-4, rtol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("optim", ["Adam", "RMSprop", "SGD", "Ranger", "LookaheadAdam"])
@pytest.mark.parametrize("model_type", FAMILIES)
def test_one_step_of_each_optimizer_matches_jax(model_type, optim):
    """One step (lr 1e-2, clip 0.5, pos_weight 1.5) against JAX's
    make_train_step on a one-device mesh, a padded single-strand batch: the
    loss to 1e-6, the params at atol 5e-6. One exception, by conditioning,
    as for the 2s2 families (tests/test_torch_train2s2.py): at most four
    elements whose gradient is not 0 but below 1e-6 (here the attention's
    Wa, 4e-10 to 5e-8) may differ by up to 1e-2 of lr, since Adam's first
    update lr g / (|g| + 1e-8) moves by ~1e3 for each unit of g there, and
    such a gradient summed in another order than XLA's differs at ~1e-3 of
    itself."""
    kw = _kw(model_type)
    params = init_attrnn(4, AttRNNConfig(**kw))
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
        logits, _ = apply_attrnn_ss(p, jcfg, feats, train=True)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        w = jnp.array([1.0, 1.5], jnp.float32)[labels] * mask
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1e-9)

    grads = dict(_flatten(jax.grad(loss_fn)(params)))
    assert got.keys() == want.keys()
    n_off = 0
    for k in got:
        diff = np.abs(got[k] - np.asarray(want[k]))
        off = diff > 5e-6
        gk = np.abs(np.asarray(grads[k]))[off]
        assert ((gk > 0) & (gk < 1e-6)).all() and (diff[off] <= 1e-4).all(), k
        n_off += int(off.sum())
    assert n_off <= 4


@pytest.mark.parametrize("model_type", FAMILIES)
def test_checkpoints_round_trip_both_ways(model_type, tmp_path):
    """The port's params saved as a .ckpt.npz give the JAX package's
    apply_attrnn_ss the port's probs; the JAX package's .ckpt.npz loads into
    the port unchanged; a reference-layout .ckpt (a ``module.``-prefixed
    state_dict) reads through torch_ckpt_to_params to the same params."""
    from ccsmeth_tpu_torch.models.params_io import save_params

    kw = _kw(model_type)
    params = init_attrnn(11, AttRNNConfig(**kw))
    feats, _l, _m = _batch(8, 8, seed=4)
    port_npz = str(tmp_path / "port.ckpt.npz")
    save_params(port_npz, attrnn_params_from_state_dict(_model(params, kw).state_dict()))
    _l, p_j = apply_attrnn_ss(jax_load_params(port_npz), JaxAttRNNConfig(**kw), feats)
    with torch.inference_mode():
        _l, p_t = _model(params, kw)({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)
    jax_npz = str(tmp_path / "jax.ckpt.npz")
    jax_save_params(jax_npz, params)
    from ccsmeth_tpu_torch.models.params_io import load_params

    back = dict(_flatten(attrnn_params_from_state_dict(
        _model(load_params(jax_npz), kw).state_dict())))
    for k, v in _flatten(params):
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    ckpt = str(tmp_path / "ref.ckpt")
    torch.save({"module." + k: v for k, v in _model(params, kw).state_dict().items()}, ckpt)
    from_ckpt = dict(_flatten(torch_ckpt_to_params(ckpt, AttRNNConfig(**kw))))
    for k, v in _flatten(params):
        np.testing.assert_array_equal(from_ckpt[k], v, err_msg=k)


@pytest.mark.parametrize("model_type", FAMILIES)
def test_trainm_learns_and_the_jax_package_loads_its_checkpoint(model_type, tmp_path):
    """``trainm --model_type *1s --device cpu`` on single-strand rows: best
    accuracy >= 0.85 (the JAX package's own gate, tests/test_training.py),
    the checkpoint's probs through the JAX package equal the port's, and a
    run warm-started (--init_model) from the JAX package's checkpoint at lr
    0 keeps it to the bit."""
    tr, va = str(tmp_path / "tr.tsv"), str(tmp_path / "va.tsv")
    _write_ss_tsv(tr, 200, 0)
    _write_ss_tsv(va, 60, 1)
    args = ["trainm", "--train_file", tr, "--valid_file", va, "--model_type", model_type,
            "--layer_rnn", "1", "--hid_rnn", "16", "--batch_size", "32",
            "--dropout_rate", "0.1", "--min_epoch_num", "3", "--step_interval", "5",
            "--tseed", "1", "--device", "cpu", "--epoch_sync"]
    cli.main(args + ["--model_dir", str(tmp_path / "m"), "--max_epoch_num", "8",
                     "--lr", "0.01"])
    run = dict(LAST_RUN)
    assert run["best_accuracy"] > 0.85, run["best_accuracy"]
    ckpt = run["ckpts"][-1]
    assert os.path.basename(ckpt).startswith(model_type + ".b21_epoch")
    kw = _kw(model_type, num_layers=1)
    data = load_feature_tsv(va, single_strand=True)
    feats = {k: v for k, v in data.items() if k != "labels"}
    params = jax_load_params(ckpt)
    _l, p_j = apply_attrnn_ss(params, JaxAttRNNConfig(**kw), feats)
    with torch.inference_mode():
        _l, p_t = _model(params, kw)({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=5e-6)
    init = str(tmp_path / "init.ckpt.npz")
    jax_save_params(init, init_attrnn(9, AttRNNConfig(**kw)))
    cli.main(args + ["--model_dir", str(tmp_path / "m0"), "--max_epoch_num", "1",
                     "--min_epoch_num", "1", "--lr", "0", "--init_model", init])
    a = dict(_flatten(jax_load_params(LAST_RUN["ckpts"][-1])))
    for k, v in _flatten(jax_load_params(init)):
        np.testing.assert_array_equal(a[k], v, err_msg=k)


def test_call_mods_refuses_the_single_strand_families():
    for model_type in FAMILIES:
        with pytest.raises(ValueError, match="train/trainm only"):
            CallModsConfig(model_file="m.npz", model_type=model_type).model_config()


@pytest.mark.parametrize("extra", [["--num_processes", "2"],
                                   ["--dist_coordinator", "localhost:1234"]])
def test_trainm_refuses_more_than_one_process(extra, tmp_path):
    """--num_processes 2 without a coordinator, or a coordinator for one
    process, is refused (the multi-process run needs both)."""
    with pytest.raises(ValueError, match="--dist_coordinator host:port go together"):
        cli.main(["trainm", "--train_file", "x", "--valid_file", "y", "--model_dir",
                  str(tmp_path), "--model_type", "attbigru1s", "--device", "cpu"]
                 + extra)


@pytest.mark.parametrize("command", ["train", "trainm"])
def test_train_and_trainm_parsers_match_the_jax_parser(command):
    """Every flag, default, choice and required flag of the JAX package's
    subcommand (trainm with the single-strand families, --num_processes,
    --process_id, --dist_coordinator and --epoch_sync), plus --device."""
    import argparse

    from ccsmeth_tpu import cli as jax_cli

    def actions(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction)).choices[command]
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.required)
                for a in sub._actions if a.dest != "help"}

    got, want = actions(cli.get_parser()), actions(jax_cli.get_parser())
    assert got.pop("device") == (("--device",), "cuda", None, False)
    assert got == want

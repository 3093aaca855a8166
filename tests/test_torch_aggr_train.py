"""The aggregate trainer in the port against the JAX package, on the CPU:
``load_aggre_tsv`` equal to the JAX function; the masked-MSE loss, every
gradient leaf and one Adam step equal to a JAX step built from
``train_aggregate``'s ``loss_fn``; and a short ``train_aggregate`` run of
each cell whose checkpoints and best RMSE are the JAX trainer's on the same
data and seeds (dropout 0) and whose best ``.ckpt.npz`` the JAX package
loads; the script's entry point."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ccsmeth_tpu.models import AggrConfig as JaxAggrConfig
from ccsmeth_tpu.models import apply_aggr_attrnn
from ccsmeth_tpu.models.params_io import load_params as jax_load_params
from ccsmeth_tpu.training.aggregate import AggreTrainConfig as JaxAggreTrainConfig
from ccsmeth_tpu.training.aggregate import load_aggre_tsv as jax_load_aggre_tsv
from ccsmeth_tpu.training.aggregate import train_aggregate as jax_train_aggregate
from ccsmeth_tpu.training.optim import build_optimizer as jax_build_optimizer
from ccsmeth_tpu_torch.models import (AggrAttRNN, AggrConfig, aggr_params_from_state_dict,
                                      aggr_state_dict_from_params, init_aggr_attrnn)
from ccsmeth_tpu_torch.models.convert import gc_dims
from ccsmeth_tpu_torch.models.params_io import _flatten
from ccsmeth_tpu_torch.scripts import train_aggregate_model
from ccsmeth_tpu_torch.training import build_optimizer
from ccsmeth_tpu_torch.training.aggregate import (AggreTrainConfig, LAST_RUN, aggr_loss,
                                                  load_aggre_tsv, train_aggregate)

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

CELLS = {"gru": "attbigru", "lstm": "attbilstm"}
L, NB = 11, 20


def _write_aggre_tsv(path, n, seed):
    """AggreFeaData rows (generate_aggre_train_data.py's format): offsets to
    the centre site, 11 normalised 20-bin histograms, coverages and a label
    the centre's histogram predicts (its mean bin, scaled to [0, 1])."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            offsets = np.abs(np.cumsum(rng.randint(1, 60, L)) - rng.randint(50, 300))
            p = rng.rand()
            hist = rng.multinomial(12, np.full(NB, 1.0 / NB), L).astype(np.float64)
            hist[L // 2] = rng.multinomial(12, np.exp(-((np.arange(NB) / (NB - 1) - p)
                                                        ** 2) / 0.02)
                                           / np.exp(-((np.arange(NB) / (NB - 1) - p)
                                                      ** 2) / 0.02).sum())
            hist = hist / np.maximum(np.linalg.norm(hist, axis=1, keepdims=True), 1.0)
            covs = rng.randint(4, 40, L)
            f.write("\t".join([
                "chr1", str(1000 + 10 * i), "+", ",".join(str(int(o)) for o in offsets),
                ";".join(",".join("{:.6f}".format(x) for x in row) for row in hist),
                ",".join(str(c) for c in covs), "{:.4f}".format(p)]) + "\n")


def _flat(B, n_valid, seed):
    """One padded batch in the trainer's (B, L + L*NB + 2) layout."""
    rng = np.random.RandomState(seed)
    flat = np.zeros((B, L + L * NB + 2), np.float32)
    flat[:n_valid, :L] = rng.randint(0, 300, (n_valid, L))
    flat[:n_valid, L:L + L * NB] = rng.rand(n_valid, L * NB) / 4
    flat[:n_valid, L + L * NB] = rng.rand(n_valid)
    flat[:n_valid, L + L * NB + 1] = 1.0
    return flat


def test_load_aggre_tsv_matches_jax(tmp_path):
    path = str(tmp_path / "a.tsv")
    _write_aggre_tsv(path, 23, 0)
    got, want = load_aggre_tsv(path), jax_load_aggre_tsv(path)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["histos"].shape == (23, L, NB)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_loss_grads_and_adam_step_match_jax(cell):
    """The loss of ``train_aggregate`` (JAX ``aggregate.py:95-99``, the
    BiRNN's training forward, dropout 0) and its gradients against the
    port's (K4/K5 or K6 through their plain versions): the loss to 1e-6,
    every leaf at atol 2e-4 / rtol 1e-3; then one Adam step (lr 1e-3): the
    params at atol 5e-6, but for at most four elements whose gradient is
    not 0 but below 1e-6 and that may move by 1e-2 of lr (Adam's first
    update divides by |g|)."""
    kw = dict(model_type=CELLS[cell], dropout_rate=0.0)
    cfg, jcfg = AggrConfig(**kw), JaxAggrConfig(**kw)
    params = init_aggr_attrnn(5, cfg)
    flat = _flat(24, 19, seed=1)

    def loss_fn(p, flat):
        offsets, histos = flat[:, :L], flat[:, L:L + L * NB].reshape(-1, L, NB)
        labels, mask = flat[:, L + L * NB], flat[:, L + L * NB + 1]
        out = apply_aggr_attrnn(p, jcfg, offsets, histos, dropout_rng=None,
                                train=True)[:, 0]
        se = (out - labels) ** 2 * mask
        return jnp.sum(se) / jnp.maximum(jnp.sum(mask), 1.0)

    loss_j, g_j = jax.value_and_grad(loss_fn)(params, flat)
    tx = jax_build_optimizer("Adam", 1e-3)
    updates, _ = tx.update(g_j, tx.init(params), params)
    p_j = optax.apply_updates(params, updates)

    model = AggrAttRNN(cfg)
    model.load_state_dict(aggr_state_dict_from_params(params))
    names = [n for n, _ in model.named_parameters()]
    plist = list(model.parameters())
    loss = aggr_loss(model, torch.from_numpy(flat))
    grads = torch.autograd.grad(loss, plist)
    assert abs(loss.item() - float(loss_j)) <= 1e-6
    g = dict(_flatten(aggr_params_from_state_dict(dict(zip(names, grads)))))
    want = dict(_flatten(g_j))
    assert g.keys() == want.keys()
    for k in g:
        np.testing.assert_allclose(g[k], np.asarray(want[k]), atol=2e-4, rtol=1e-3,
                                   err_msg=k)
    opt = build_optimizer("Adam", 1e-3)
    opt.init(plist, gc_dims(names))
    opt.step(plist, grads)
    got = dict(_flatten(aggr_params_from_state_dict(model.state_dict())))
    n_off = 0
    for k, v in _flatten(p_j):
        diff = np.abs(got[k] - np.asarray(v))
        off = diff > 5e-6
        gk = np.abs(np.asarray(want[k]))[off]
        assert ((gk > 0) & (gk < 1e-6)).all() and (diff[off] <= 1e-5).all(), k
        n_off += int(off.sum())
    assert n_off <= 4


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_train_aggregate_run_matches_jax_and_its_npz_loads(cell, tmp_path):
    """A short run (4 epochs of 240 rows, batch 48, dropout 0) on the CPU
    beside the JAX trainer on the same data and seeds (the same init,
    shuffles and steps): the same checkpoints, named alike, on the same
    epochs, the best RMSE and the best params to 1e-4; the RMSE falls below
    the first epoch's; and the JAX package's apply_aggr_attrnn on the
    port's best checkpoint gives the port's outputs."""
    tr, va = str(tmp_path / "tr.tsv"), str(tmp_path / "va.tsv")
    _write_aggre_tsv(tr, 240, 1)
    _write_aggre_tsv(va, 80, 2)
    kw = dict(train_file=tr, valid_file=va, model_type=CELLS[cell], dropout_rate=0.0,
              batch_size=48, lr=0.003, max_epoch_num=4, min_epoch_num=4, tseed=7)
    got = train_aggregate(AggreTrainConfig(model_dir=str(tmp_path / "port"),
                                           device="cpu", **kw))
    want = jax_train_aggregate(JaxAggreTrainConfig(model_dir=str(tmp_path / "jax"),
                                                   **kw))
    assert ([os.path.basename(p) for p in got["ckpts"]]
            == [os.path.basename(p) for p in want["ckpts"]])
    assert sorted(glob.glob(str(tmp_path / "port" / "*"))) == sorted(got["ckpts"])
    assert abs(got["best_rmse"] - want["best_rmse"]) <= 1e-4
    assert got["rmses"][-1] < got["rmses"][0] and got["best_rmse"] == min(got["rmses"])
    assert os.path.basename(got["ckpts"][-1]) == "{}.aggre.b11_epoch{}.ckpt.npz".format(
        CELLS[cell], got["best_epoch"])
    params = jax_load_params(got["ckpts"][-1])
    want_p = jax_load_params(str(tmp_path / "jax" / os.path.basename(got["ckpts"][-1])))
    for k, v in _flatten(want_p):
        np.testing.assert_allclose(dict(_flatten(params))[k], np.asarray(v), atol=1e-4,
                                   err_msg=k)
    data = load_aggre_tsv(va)
    jcfg = JaxAggrConfig(model_type=CELLS[cell])
    out_j = apply_aggr_attrnn(params, jcfg, data["offsets"], data["histos"])
    model = AggrAttRNN(AggrConfig(model_type=CELLS[cell]))
    model.load_state_dict(aggr_state_dict_from_params(params))
    with torch.inference_mode():
        out_t = model(torch.from_numpy(data["offsets"]), torch.from_numpy(data["histos"]))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)


def test_script_trains_on_the_cpu(tmp_path):
    tr, va = str(tmp_path / "tr.tsv"), str(tmp_path / "va.tsv")
    _write_aggre_tsv(tr, 64, 3)
    _write_aggre_tsv(va, 32, 4)
    rc = train_aggregate_model.main([
        "--train_file", tr, "--valid_file", va, "--model_dir", str(tmp_path / "m"),
        "--model_type", "attbilstm", "--batch_size", "32", "--max_epoch_num", "2",
        "--min_epoch_num", "2", "--device", "cpu"])
    assert rc == 0 and LAST_RUN["steps"] == 4 and LAST_RUN["ckpts"]
    with pytest.raises(SystemExit):
        train_aggregate_model.main(["--train_file", tr])


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_training_kernels_take_the_aggregate_shape(cell):
    """``k45_plan`` at H = 32 (the aggregate model's 1 x 32 BiRNN): fp32 on
    the simt design and bf16 on tc, each one 32-unit CTA a cluster (U = 64
    does not divide 32), within shared memory; the weight-gradient launch
    splits the 11 x 512 rows of a batch into fixed slices."""
    from ccsmeth_tpu_torch.ops import bigru_vjp
    from ccsmeth_tpu_torch.ops.kernel_args import SMEM_LIMIT

    for dtype, design in ((torch.float32, "simt"), (torch.bfloat16, "tc")):
        plan = bigru_vjp.k45_plan(32, dtype, cell)
        assert (plan["design"], plan["U"], plan["CN"]) == (design, 32, 1)
        assert max(plan["smem_fwd"], plan["smem_bwd"]) <= SMEM_LIMIT
        S = bigru_vjp.k5_wgrad_slices(L * 512, NB + 1, 32, 132, plan["gates"])
        assert 1 <= S <= L * 512 // 256

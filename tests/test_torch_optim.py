"""The port's optimizers and LR schedules against the JAX package's optax
chains: the same numpy params and grads, three steps, the learning rate set
between steps 2 and 3; one grad set is clipped (global norm > 0.5) and one is
not."""

import jax
import numpy as np
import optax
import pytest
import torch

from ccsmeth_tpu.models import AttRNNConfig as JaxAttRNNConfig
from ccsmeth_tpu.models import init_attrnn as jax_init_attrnn
from ccsmeth_tpu.training.optim import LrSchedule as JaxLrSchedule
from ccsmeth_tpu.training.optim import build_optimizer as jax_build_optimizer
from ccsmeth_tpu.training.optim import set_learning_rate as jax_set_lr
from ccsmeth_tpu_torch.models import AttRNN, AttRNNConfig, attrnn_state_dict_from_params
from ccsmeth_tpu_torch.models.convert import attrnn_params_from_state_dict, gc_dims
from ccsmeth_tpu_torch.training import LrSchedule, build_optimizer

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

KINDS = ["Adam", "RMSprop", "SGD", "Ranger", "LookaheadAdam"]
CFG = dict(num_layers=1, hidden_size=16, dropout_rate=0)


def _grad_sets(params, seed=0):
    """Three grad pytrees with global norms ~2.5 (clipped), ~0.2 and ~1."""
    rng = np.random.RandomState(seed)
    leaves, tdef = jax.tree_util.tree_flatten(params)
    out = []
    for norm in (2.5, 0.2, 1.0):
        gs = [rng.randn(*np.shape(p)).astype(np.float32) for p in leaves]
        tot = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in gs))
        out.append(tdef.unflatten([g * np.float32(norm / tot) for g in gs]))
    return out


def _jax_steps(kind, params, grads):
    tx = jax_build_optimizer(kind, 1e-2)
    state = tx.init(params)
    for i, g in enumerate(grads):
        if i == 2:
            state = jax_set_lr(state, 3e-3)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return params


@pytest.mark.parametrize("kind", KINDS)
def test_optimizer_matches_optax(kind):
    params = jax_init_attrnn(0, JaxAttRNNConfig(**CFG))
    grads = _grad_sets(params)
    want = jax.tree_util.tree_leaves(_jax_steps(kind, params, grads))
    ps = [torch.from_numpy(np.array(p, np.float32))
          for p in jax.tree_util.tree_leaves(params)]
    opt = build_optimizer(kind, 1e-2)
    opt.init(ps)
    for i, g in enumerate(grads):
        if i == 2:
            opt.set_learning_rate(3e-3)
        opt.step(ps, [torch.from_numpy(np.asarray(x))
                      for x in jax.tree_util.tree_leaves(g)])
    for a, b in zip(ps, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("kind", ["Ranger", "LookaheadAdam"])
def test_optimizer_on_module_layout_matches_optax(kind):
    """On AttRNN's parameters (torch layout: Linear weights are (out, in)),
    with the centralization dims the model gives, past the lookahead sync
    (k = 5 and 6) and into RAdam's rectified branch (step >= 6). atol 5e-6:
    the centralizing mean of a transposed leaf sums in another order, and
    RAdam's m / (sqrt(v) + 1e-5) magnifies a 1-ulp change of a centered grad
    near zero (measured 1.2e-6 on 2 of 512 entries of _att3.Wa)."""
    params = jax_init_attrnn(1, JaxAttRNNConfig(**CFG))
    grads = _grad_sets(params, seed=1) * 3  # 9 steps
    want = _jax_steps(kind, params, grads)
    model = AttRNN(AttRNNConfig(**CFG))
    model.load_state_dict(attrnn_state_dict_from_params(params))
    names = [n for n, _ in model.named_parameters()]
    ps = [p.data for _, p in model.named_parameters()]
    opt = build_optimizer(kind, 1e-2)
    opt.init(ps, gc_dims(names))
    for i, g in enumerate(grads):
        if i == 2:
            opt.set_learning_rate(3e-3)
        gsd = attrnn_state_dict_from_params(g)
        opt.step(ps, [gsd[n] for n in names])
    got = attrnn_params_from_state_dict(model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-6, rtol=1e-5)


def test_optimizer_state_round_trip():
    params = jax_init_attrnn(0, JaxAttRNNConfig(**CFG))
    grads = _grad_sets(params)
    leaves = [np.array(p, np.float32) for p in jax.tree_util.tree_leaves(params)]
    flat_g = [[torch.from_numpy(np.asarray(x)) for x in jax.tree_util.tree_leaves(g)]
              for g in grads]
    a = [torch.from_numpy(p.copy()) for p in leaves]
    opt_a = build_optimizer("Ranger", 1e-2)
    opt_a.init(a)
    for g in flat_g:
        opt_a.step(a, g)
    b = [torch.from_numpy(p.copy()) for p in leaves]
    opt_b = build_optimizer("Ranger", 1e-2)
    opt_b.init(b)
    opt_b.step(b, flat_g[0])
    sd = opt_b.state_dict()
    opt_c = build_optimizer("Ranger", 1.0)
    opt_c.init([t.clone() for t in b])
    opt_c.load_state_dict({k: ([t.numpy() for t in v] if isinstance(v, list) else v)
                           for k, v in sd.items()})
    for g in flat_g[1:]:
        opt_c.step(b, g)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        build_optimizer("Adam", 1e-2).load_state_dict(sd)
    with pytest.raises(ValueError):
        build_optimizer("Adagrad", 1e-2)


@pytest.mark.parametrize("kind,kw", [
    ("StepLR", dict(decay=0.5, decay_step=2)),
    ("ReduceLROnPlateau", dict(decay=0.1, patience=1, mode_strategy="max")),
    ("ReduceLROnPlateau", dict(decay=0.5, patience=0, mode_strategy="mean")),
])
def test_lr_schedule_matches_jax(kind, kw):
    ours, theirs = LrSchedule(kind, 0.1, **kw), JaxLrSchedule(kind, 0.1, **kw)
    accs = [[0.5], [0.5, 0.6], [0.4], [0.7, 0.2], [0.7], [0.9]]
    assert [ours.epoch_end(a) for a in accs] == [theirs.epoch_end(a) for a in accs]

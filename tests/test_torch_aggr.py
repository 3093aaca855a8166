"""call_freqb's aggregate model: the port's AggrAttRNN against ccsmeth_tpu's
apply_aggr_attrnn on the same numpy-seeded params and windows, on CPU (the
BiRNN through K1's plain version), and the weight converters both ways."""

import numpy as np
import pytest
import torch

from ccsmeth_tpu.models import AggrConfig as JaxAggrConfig
from ccsmeth_tpu.models import apply_aggr_attrnn
from ccsmeth_tpu.models import init_aggr_attrnn as jax_init_aggr_attrnn
from ccsmeth_tpu.models import torch_ckpt_to_params as jax_torch_ckpt_to_params
from ccsmeth_tpu_torch.models import (AggrAttRNN, AggrConfig,
                                      aggr_params_from_state_dict,
                                      aggr_state_dict_from_params, init_aggr_attrnn,
                                      torch_ckpt_to_params)
from ccsmeth_tpu_torch.models.params_io import _flatten
from ccsmeth_tpu_torch.ops import bigru

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

CELLS = {"gru": "attbigru", "lstm": "attbilstm"}


def _cfgs(cell, num_layers=1):
    kw = dict(model_type=CELLS[cell], num_layers=num_layers, dropout_rate=0.0)
    return AggrConfig(**kw), JaxAggrConfig(**kw)


def _windows(B, seed, L=11, bins=20):
    """offsets as call_freqb builds them (distances to the center site) and
    normalized histograms rounded to 6 decimals."""
    rng = np.random.RandomState(seed)
    offsets = np.abs(np.cumsum(rng.randint(1, 60, (B, L)), axis=1)
                     - rng.randint(50, 300, (B, 1))).astype(np.float32)
    hist = rng.randint(0, 6, (B, L, bins)).astype(np.float32)
    norm = np.maximum(np.linalg.norm(hist, axis=2, keepdims=True), 1.0)
    return offsets, np.round(hist / norm, 6).astype(np.float32)


def _port(params, cfg):
    m = AggrAttRNN(cfg)
    m.load_state_dict(aggr_state_dict_from_params(params))
    return m.eval()


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_init_aggr_attrnn_equals_jax_init(cell):
    cfg, jcfg = _cfgs(cell)
    p = dict(_flatten(init_aggr_attrnn(7, cfg)))
    q = dict(_flatten(jax_init_aggr_attrnn(7, jcfg)))
    assert p.keys() == q.keys()
    for k in p:
        np.testing.assert_array_equal(p[k], np.asarray(q[k]), err_msg=k)


@pytest.mark.parametrize("rows", [1, 37])
@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_aggr_forward_matches_jax(cell, num_layers, rows):
    """The raw (B, 1) output to 1e-5 for ragged B, through K1's plain version
    (counted) with zero h0 and the offsets in the last channel."""
    cfg, jcfg = _cfgs(cell, num_layers)
    params = init_aggr_attrnn(11 + num_layers, cfg)
    offsets, histos = _windows(rows, rows + num_layers)
    want = np.asarray(apply_aggr_attrnn(params, jcfg, offsets, histos))
    before = bigru.plain_calls
    with torch.inference_mode():
        got = _port(params, cfg)(torch.from_numpy(offsets),
                                 torch.from_numpy(histos)).numpy()
    assert bigru.plain_calls == before + 1
    assert got.shape == want.shape == (rows, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_aggr_query_is_the_last_layers_states():
    """The attention query is h_n's last layer, [fwd; bwd] (JAX
    _last_layer_query): the model's output with the BiRNN replaced by its
    plain version equals one built from a hand-made query."""
    from ccsmeth_tpu_torch.models.attention import attention

    cfg, _ = _cfgs("gru", 2)
    model = _port(init_aggr_attrnn(5, cfg), cfg)
    offsets, histos = _windows(9, 5)
    o, h = torch.from_numpy(offsets), torch.from_numpy(histos)
    with torch.inference_mode():
        got = model(o, h, rnn_fn=bigru.birnn_stack_plain)
        x = torch.cat([h, o[..., None]], dim=2).transpose(0, 1).contiguous()
        out_tm, h_n = bigru.birnn_stack_plain(model.rnn.stacked(), x)
        q = torch.cat([h_n[2], h_n[3]], dim=1)[:, None, :]
        ctx, _ = attention(q, out_tm.transpose(0, 1), model._att3.Wa.weight,
                           model._att3.Ua.weight, model._att3.va.weight)
        want = model.fc1(ctx)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_aggr_converters_round_trip_and_reference_ckpt(tmp_path, cell):
    """params -> state_dict -> params is exact; a reference-style .ckpt (a
    DDP 'module.' prefix) converts to the JAX package's params."""
    cfg, jcfg = _cfgs(cell)
    params = init_aggr_attrnn(3, cfg)
    sd = aggr_state_dict_from_params(params)
    assert sd.keys() == AggrAttRNN(cfg).state_dict().keys()
    back = dict(_flatten(aggr_params_from_state_dict(sd)))
    for k, v in _flatten(params):
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    ckpt = str(tmp_path / "aggr.ckpt")
    torch.save({"module." + k: v for k, v in sd.items()}, ckpt)
    ours = dict(_flatten(torch_ckpt_to_params(ckpt, cfg)))
    theirs = dict(_flatten(jax_torch_ckpt_to_params(ckpt, jcfg)))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)

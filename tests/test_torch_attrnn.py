"""attbigru2s and attbilstm2s: the port's AttRNN module against ccsmeth_tpu's
apply_attrnn on the same params (carried across with
attrnn_state_dict_from_params) and the same numpy feats, on CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsmeth_tpu.models import AttRNNConfig as JaxAttRNNConfig
from ccsmeth_tpu.models import apply_attrnn
from ccsmeth_tpu.models import init_attrnn as jax_init_attrnn
from ccsmeth_tpu.models.convert import _attrnn_from_sd
from ccsmeth_tpu_torch.models import (AttRNN, AttRNNConfig,
                                      attrnn_state_dict_from_params, init_attrnn)
from ccsmeth_tpu_torch.models.attention import attention, init_attention
from ccsmeth_tpu_torch.models.params_io import _flatten
from ccsmeth_tpu_torch.ops import bigru

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

CFG = dict(num_layers=2, hidden_size=32, dropout_rate=0)


def _feats(B=12, L=21, seed=4):
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
    return feats


def _port_model(params, cfg):
    m = AttRNN(cfg)
    m.load_state_dict(attrnn_state_dict_from_params(params))
    return m.eval()


def _port_forward(model, feats, **kw):
    with torch.inference_mode():
        logits, probs = model({k: torch.from_numpy(v) for k, v in feats.items()},
                              **kw)
    return logits.numpy(), probs.numpy()


def test_init_attrnn_equals_jax_init():
    for cfg_kw in (CFG, {}):
        p = dict(_flatten(init_attrnn(3, AttRNNConfig(**cfg_kw))))
        q = dict(_flatten(jax_init_attrnn(3, JaxAttRNNConfig(**cfg_kw))))
        assert p.keys() == q.keys()
        for k in p:
            np.testing.assert_array_equal(p[k], np.asarray(q[k]), err_msg=k)


@pytest.mark.parametrize("rnn_backend", ["xla", "pallas"])
def test_forward_matches_apply_attrnn(rnn_backend):
    """'pallas' runs the JAX package's stack kernel in interpret mode."""
    params = init_attrnn(3, AttRNNConfig(**CFG))
    feats = _feats()
    bigru.launches = 0
    l_t, p_t = _port_forward(_port_model(params, AttRNNConfig(**CFG)), feats)
    l_j, p_j = apply_attrnn(params, JaxAttRNNConfig(**CFG), feats,
                            rnn_backend=rnn_backend)
    np.testing.assert_allclose(l_t, np.asarray(l_j), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(p_t, np.asarray(p_j), atol=5e-6)
    assert bigru.launches == 0


def test_state_dict_key_round_trip():
    """port state_dict -> numpy -> the JAX package's reference-ckpt reader ->
    apply_attrnn equals the port's own forward."""
    cfg = AttRNNConfig(**CFG)
    model = AttRNN(cfg)
    model.rnn.reset_parameters(torch.Generator().manual_seed(1))
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = _attrnn_from_sd(sd, JaxAttRNNConfig(**CFG))
    feats = _feats(seed=8)
    l_t, p_t = _port_forward(model.eval(), feats)
    l_j, p_j = apply_attrnn(params, JaxAttRNNConfig(**CFG), feats)
    np.testing.assert_allclose(l_t, np.asarray(l_j), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(p_t, np.asarray(p_j), atol=5e-6)


def test_reference_style_ckpt_loads(tmp_path):
    """A torch .ckpt of the module (DDP 'module.' prefix) loads through the
    port's converter to the same params."""
    from ccsmeth_tpu_torch.models.convert import torch_ckpt_to_params

    cfg = AttRNNConfig(**CFG)
    params = init_attrnn(5, cfg)
    model = _port_model(params, cfg)
    path = str(tmp_path / "m.ckpt")
    torch.save({"module." + k: v for k, v in model.state_dict().items()}, path)
    got = dict(_flatten(torch_ckpt_to_params(path, cfg)))
    want = dict(_flatten(params))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_attention_matches_jax():
    from ccsmeth_tpu.models.attention import apply_attention

    rng = np.random.RandomState(2)
    p = init_attention(rng, 16, 16, 8)
    q = rng.randn(5, 1, 16).astype(np.float32)
    k = rng.randn(5, 21, 16).astype(np.float32)
    ctx, w = attention(torch.from_numpy(q), torch.from_numpy(k),
                       *(torch.from_numpy(np.ascontiguousarray(p[n].T))
                         for n in ("Wa", "Ua", "va")))
    ctx_j, w_j = apply_attention(p, jnp.asarray(q), jnp.asarray(k))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_j), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-6, rtol=1e-5)


def test_bf16_forward_near_fp32():
    """bf16 operands in the BiGRU move probs by less than 2/256, the fast
    path's envelope (bench.py:170-173)."""
    params = init_attrnn(3, AttRNNConfig(**CFG))
    model = _port_model(params, AttRNNConfig(**CFG))
    feats = _feats(seed=11)
    _l, p32 = _port_forward(model, feats)
    _l, p16 = _port_forward(model, feats, compute_dtype=torch.bfloat16)
    assert np.abs(p16 - p32).max() < 2.0 / 256


def test_unported_families_raise():
    """Every family of the JAX package is ported (the single-strand ones
    since they train under trainm); a model_type of none still raises."""
    with pytest.raises(NotImplementedError):
        AttRNN(AttRNNConfig(model_type="attbilstm3s"))
    with pytest.raises(NotImplementedError):
        init_attrnn(0, AttRNNConfig(model_type="attbigru3s"))


LSTM = dict(CFG, model_type="attbilstm2s")


def test_lstm_init_attrnn_equals_jax_init():
    for cfg_kw in (LSTM, dict(model_type="attbilstm2s")):
        p = dict(_flatten(init_attrnn(3, AttRNNConfig(**cfg_kw))))
        q = dict(_flatten(jax_init_attrnn(3, JaxAttRNNConfig(**cfg_kw))))
        assert p.keys() == q.keys()
        for k in p:
            np.testing.assert_array_equal(p[k], np.asarray(q[k]), err_msg=k)
        H = cfg_kw.get("hidden_size", 256)
        assert p["rnn/0/fwd/w_hh"].shape == (4 * H, H)


@pytest.mark.parametrize("rnn_backend", ["xla", "pallas"])
def test_lstm_forward_matches_apply_attrnn(rnn_backend):
    """'pallas' runs the JAX package's stack kernel (LSTM cell) in interpret
    mode; tolerances as for attbigru2s."""
    params = init_attrnn(3, AttRNNConfig(**LSTM))
    feats = _feats()
    bigru.launches = 0
    model = _port_model(params, AttRNNConfig(**LSTM))
    assert model.rnn.cell == "lstm"
    l_t, p_t = _port_forward(model, feats)
    l_j, p_j = apply_attrnn(params, JaxAttRNNConfig(**LSTM), feats,
                            rnn_backend=rnn_backend)
    np.testing.assert_allclose(l_t, np.asarray(l_j), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(p_t, np.asarray(p_j), atol=5e-6)
    assert bigru.launches == 0


def test_lstm_state_dict_key_round_trip(tmp_path):
    """attbilstm2s keys carry 4H-row tensors both ways: port state_dict ->
    the JAX package's reference-ckpt reader -> apply_attrnn equals the port's
    forward; params -> state_dict -> params and a reference-style .ckpt
    through torch_ckpt_to_params give the same arrays back."""
    from ccsmeth_tpu_torch.models import attrnn_params_from_state_dict
    from ccsmeth_tpu_torch.models.convert import torch_ckpt_to_params

    cfg = AttRNNConfig(**LSTM)
    model = AttRNN(cfg)
    model.rnn.reset_parameters(torch.Generator().manual_seed(1))
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert sd["rnn.weight_ih_l1_reverse"].shape == (4 * 32, 2 * 32)
    params = _attrnn_from_sd(sd, JaxAttRNNConfig(**LSTM))
    feats = _feats(seed=8)
    l_t, p_t = _port_forward(model.eval(), feats)
    l_j, p_j = apply_attrnn(params, JaxAttRNNConfig(**LSTM), feats)
    np.testing.assert_allclose(l_t, np.asarray(l_j), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(p_t, np.asarray(p_j), atol=5e-6)

    want = dict(_flatten(init_attrnn(5, cfg)))
    back = dict(_flatten(attrnn_params_from_state_dict(
        attrnn_state_dict_from_params(init_attrnn(5, cfg)))))
    path = str(tmp_path / "lstm.ckpt")
    torch.save({"module." + k: v for k, v in
                _port_model(init_attrnn(5, cfg), cfg).state_dict().items()}, path)
    loaded = dict(_flatten(torch_ckpt_to_params(path, cfg)))
    for got in (back, loaded):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_lstm_bf16_forward_near_fp32():
    """bf16 operands in the BiLSTM (c kept f32) move probs by less than
    2/256, the fast path's envelope (bench.py:170-173)."""
    model = _port_model(init_attrnn(3, AttRNNConfig(**LSTM)), AttRNNConfig(**LSTM))
    feats = _feats(seed=11)
    _l, p32 = _port_forward(model, feats)
    _l, p16 = _port_forward(model, feats, compute_dtype=torch.bfloat16)
    assert np.abs(p16 - p32).max() < 2.0 / 256

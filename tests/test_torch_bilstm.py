"""Kernel K1's LSTM cell (ccsmeth_tpu_torch/ops/bigru.py, cell='lstm') against
the JAX package.

On CPU tensors the wrapper runs its plain version (models/rnn.py's birnn_tm
with cell='lstm'), which must match the Pallas whole-stack kernel's LSTM cell
in interpret mode and the lax.scan BiLSTM. The CUDA kernel itself is held
against the plain version by tests/test_torch_lstm_kernels_cuda.py and
chip_smoke.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsmeth_tpu.models.rnn import birnn_apply as jax_birnn_apply
from ccsmeth_tpu.models.rnn import init_rnn_params as jax_init_rnn_params
from ccsmeth_tpu.ops.bigru_pallas import birnn_apply_pallas_stacked
from ccsmeth_tpu_torch.models import rnn as port_rnn
from ccsmeth_tpu_torch.ops import bigru

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

B, L, C, H, NL = 13, 21, 11, 16, 3  # odd B: the ragged last tile


def _inputs(seed=9):
    rng = np.random.RandomState(seed)
    layers = jax_init_rnn_params(rng, C, H, NL, "lstm")
    x = rng.randn(B, L, C).astype(np.float32)
    return layers, x


def _port(layers, x, dtype=torch.float32):
    ly = [port_rnn.layer_weights(ld, dtype) for ld in layers]
    x_tm = torch.from_numpy(x).transpose(0, 1).to(dtype).contiguous()
    out, hn = bigru.birnn_stack(ly, x_tm, dtype, "lstm")
    return out.transpose(0, 1).float().numpy(), hn.numpy()


@pytest.mark.parametrize("reference", ["pallas_interpret", "scan"])
def test_plain_lstm_stack_matches_jax(reference):
    """fp32: the JAX package's own gate for the stack kernel, atol 3e-5 /
    rtol 1e-5 (tests/test_pallas_bigru.py:87-90)."""
    layers, x = _inputs()
    bigru.launches = 0
    out, hn = _port(layers, x)
    if reference == "pallas_interpret":
        ref_out, ref_hn = birnn_apply_pallas_stacked(
            layers, jnp.asarray(x), interpret=True, b_tile=8, cell="lstm")
    else:
        zeros = jnp.zeros((NL * 2, B, H), jnp.float32)
        ref_out, ref_hn = jax_birnn_apply(layers, jnp.asarray(x), zeros, zeros,
                                          "lstm")
    assert out.shape == (B, L, 2 * H) and hn.shape == (2 * NL, B, H)
    np.testing.assert_allclose(out, np.asarray(ref_out), atol=3e-5, rtol=1e-5)
    np.testing.assert_allclose(hn, np.asarray(ref_hn), atol=3e-5, rtol=1e-5)
    assert bigru.launches == 0  # CPU tensors never launch the kernel


def test_plain_lstm_stack_bf16_matches_pallas_bf16():
    """bf16 operands, f32 accumulation, gate math and c on both sides. Both
    round the same values to bf16; the f32 sums differ in order, which moves
    a rounding by at most one bf16 ulp (2^-8 = 3.9e-3 on [0.5, 1)), and h is
    below 1 in magnitude, so 8e-3 allows two such ulps."""
    layers, x = _inputs(seed=3)
    out, hn = _port(layers, x, torch.bfloat16)
    ref_out, ref_hn = birnn_apply_pallas_stacked(
        layers, jnp.asarray(x), compute_dtype=jnp.bfloat16, interpret=True,
        b_tile=8, cell="lstm")
    np.testing.assert_allclose(out, np.asarray(ref_out), atol=8e-3, rtol=0)
    np.testing.assert_allclose(hn, np.asarray(ref_hn), atol=8e-3, rtol=0)


def test_birnn_apply_lstm_with_explicit_h0_c0_matches_jax():
    layers, x = _inputs(seed=5)
    rng = np.random.RandomState(6)
    h0 = rng.randn(2 * NL, B, H).astype(np.float32)
    c0 = rng.randn(2 * NL, B, H).astype(np.float32)
    ly = [port_rnn.layer_weights(ld) for ld in layers]
    out, hn = port_rnn.birnn_apply(ly, torch.from_numpy(x), torch.from_numpy(h0),
                                   cell="lstm", c0=torch.from_numpy(c0))
    ref_out, ref_hn = jax_birnn_apply(layers, jnp.asarray(x), jnp.asarray(h0),
                                      jnp.asarray(c0), "lstm")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=3e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(hn.numpy(), np.asarray(ref_hn), atol=3e-5,
                               rtol=1e-5)


def test_bilstm_module_stacked_layout():
    """BiRNN(cell='lstm')'s nn.LSTM-named parameters (4H rows) give the same
    stacked layout as the params pytree, and the names are nn.LSTM's."""
    layers, _x = _inputs()
    mod = port_rnn.BiRNN(C, H, NL, "lstm")
    ref = torch.nn.LSTM(C, H, NL, bidirectional=True)
    assert ({k: tuple(v.shape) for k, v in mod.state_dict().items()}
            == {k: tuple(v.shape) for k, v in ref.state_dict().items()})
    sd = {}
    for k, ld in enumerate(layers):
        for d, suf in (("fwd", ""), ("bwd", "_reverse")):
            for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                              ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                sd["{}_l{}{}".format(name, k, suf)] = torch.from_numpy(ld[d][key])
    mod.load_state_dict(sd)
    stacked = mod.stacked()
    assert stacked[0][0].shape == (2, C, 4 * H) and stacked[1][2].shape == (2, H, 4 * H)
    for got, want in zip(stacked, [port_rnn.layer_weights(ld) for ld in layers]):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_plain_lstm_matches_torch_nn_lstm():
    """The plain version against torch's own nn.LSTM (CPU) with the same
    weights: the gate order i, f, g, o and both biases as torch places them."""
    layers, x = _inputs(seed=7)
    ref = torch.nn.LSTM(C, H, NL, bidirectional=True)
    with torch.no_grad():
        for k, ld in enumerate(layers):
            for d, suf in (("fwd", ""), ("bwd", "_reverse")):
                for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                  ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                    getattr(ref, "{}_l{}{}".format(name, k, suf)).copy_(
                        torch.from_numpy(ld[d][key]))
        want_out, (want_hn, _cn) = ref(torch.from_numpy(x).transpose(0, 1))
    out, hn = _port(layers, x)
    np.testing.assert_allclose(out, want_out.transpose(0, 1).numpy(), atol=3e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(hn, want_hn.numpy(), atol=3e-5, rtol=1e-5)


@pytest.mark.parametrize("fault", ["gru_weights", "bad_cell"])
def test_lstm_wrapper_rejects_bad_input(fault):
    layers, x = _inputs()
    x_tm = torch.from_numpy(x).transpose(0, 1).contiguous()
    if fault == "gru_weights":  # 3H columns where the LSTM takes 4H
        gru = jax_init_rnn_params(np.random.RandomState(0), C, H, NL, "gru")
        ly, cell = [port_rnn.layer_weights(ld) for ld in gru], "lstm"
    else:
        ly, cell = [port_rnn.layer_weights(ld) for ld in layers], "rnn_tanh"
    with pytest.raises(ValueError):
        bigru.birnn_stack(ly, x_tm, torch.float32, cell)

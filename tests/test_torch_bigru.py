"""Kernel K1's wrapper (ccsmeth_tpu_torch/ops/bigru.py) against the JAX package.

On CPU tensors the wrapper runs its plain version (models/rnn.py), which must
match the Pallas whole-stack kernel in interpret mode and the lax.scan BiGRU.
The CUDA kernel itself is held against the plain version by
tests/test_torch_kernels_cuda.py and chip_smoke.py, on the card.
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
    layers = jax_init_rnn_params(rng, C, H, NL, "gru")
    x = rng.randn(B, L, C).astype(np.float32)
    return layers, x


def _port(layers, x, dtype=torch.float32):
    ly = [port_rnn.layer_weights(ld, dtype) for ld in layers]
    x_tm = torch.from_numpy(x).transpose(0, 1).to(dtype).contiguous()
    out, hn = bigru.birnn_stack(ly, x_tm, dtype)
    return out.transpose(0, 1).float().numpy(), hn.numpy()


@pytest.mark.parametrize("reference", ["pallas_interpret", "scan"])
def test_plain_stack_matches_jax(reference):
    layers, x = _inputs()
    bigru.launches = 0
    out, hn = _port(layers, x)
    if reference == "pallas_interpret":
        ref_out, ref_hn = birnn_apply_pallas_stacked(
            layers, jnp.asarray(x), interpret=True, b_tile=8)
    else:
        ref_out, ref_hn = jax_birnn_apply(
            layers, jnp.asarray(x), jnp.zeros((NL * 2, B, H), jnp.float32),
            None, "gru")
    assert out.shape == (B, L, 2 * H) and hn.shape == (2 * NL, B, H)
    np.testing.assert_allclose(out, np.asarray(ref_out), atol=3e-5, rtol=1e-5)
    np.testing.assert_allclose(hn, np.asarray(ref_hn), atol=3e-5, rtol=1e-5)
    assert bigru.launches == 0  # CPU tensors never launch the kernel


def test_plain_stack_bf16_matches_pallas_bf16():
    """bf16 operands, f32 accumulation and gate math on both sides. Both
    round the same values to bf16; the f32 sums differ in order, which moves
    a rounding by at most one bf16 ulp (2^-8 = 3.9e-3 on [0.5, 1)), and tanh
    outputs are below 1, so 8e-3 allows two such ulps."""
    layers, x = _inputs(seed=3)
    out, hn = _port(layers, x, torch.bfloat16)
    ref_out, ref_hn = birnn_apply_pallas_stacked(
        layers, jnp.asarray(x), compute_dtype=jnp.bfloat16, interpret=True,
        b_tile=8)
    np.testing.assert_allclose(out, np.asarray(ref_out), atol=8e-3, rtol=0)
    np.testing.assert_allclose(hn, np.asarray(ref_hn), atol=8e-3, rtol=0)


def test_birnn_apply_with_explicit_h0_matches_jax():
    layers, x = _inputs(seed=5)
    h0 = np.random.RandomState(6).randn(2 * NL, B, H).astype(np.float32)
    ly = [port_rnn.layer_weights(ld) for ld in layers]
    out, hn = port_rnn.birnn_apply(ly, torch.from_numpy(x), torch.from_numpy(h0))
    ref_out, ref_hn = jax_birnn_apply(layers, jnp.asarray(x), jnp.asarray(h0),
                                      None, "gru")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=3e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(hn.numpy(), np.asarray(ref_hn), atol=3e-5,
                               rtol=1e-5)


def test_bigru_module_stacked_layout():
    """BiRNN's nn.GRU-named parameters (cell 'gru', the default) give the
    same stacked layout as the params pytree."""
    layers, _x = _inputs()
    mod = port_rnn.BiRNN(C, H, NL)
    sd = {}
    for k, ld in enumerate(layers):
        for d, suf in (("fwd", ""), ("bwd", "_reverse")):
            for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                              ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                sd["{}_l{}{}".format(name, k, suf)] = torch.from_numpy(ld[d][key])
    mod.load_state_dict(sd)
    for got, want in zip(mod.stacked(), [port_rnn.layer_weights(ld) for ld in layers]):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("fault", ["non_contiguous", "wrong_dtype",
                                   "weight_dtype", "weight_shape"])
def test_wrapper_rejects_bad_input(fault):
    layers, x = _inputs()
    ly = [port_rnn.layer_weights(ld) for ld in layers]
    x_tm = torch.from_numpy(x).transpose(0, 1).contiguous()
    if fault == "non_contiguous":
        x_tm = torch.from_numpy(x).transpose(0, 1)
    elif fault == "wrong_dtype":
        x_tm = x_tm.double()
    elif fault == "weight_dtype":
        ly[1] = (ly[1][0].to(torch.bfloat16),) + ly[1][1:]
    else:
        ly[0] = (ly[0][0][:, :-1].contiguous(),) + ly[0][1:]
    with pytest.raises((ValueError, TypeError)):
        bigru.birnn_stack(ly, x_tm, torch.float32)

"""K6's plain versions through BiLSTMLayerFn (birnn_apply_trainable with
cell='lstm' on CPU tensors, torch.autograd.grad) against the JAX package's
custom-VJP Pallas LSTM kernels (birnn_apply_pallas_trainable(cell='lstm'),
b_tile=8, interpret mode, jax.grad): the same numpy params and inputs, the
loss sum(out * cos(0.01 * arange)), as tests/test_pallas_vjp.py sets it up.
Tolerances are that file's gate (:110-124): atol 2e-4 / rtol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsmeth_tpu.models.rnn import init_rnn_params
from ccsmeth_tpu.ops.bigru_pallas_vjp import birnn_apply_pallas_trainable
from ccsmeth_tpu_torch.models.rnn import birnn_tm, layer_weights
from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once


def _weights(out):
    return jnp.cos(jnp.arange(out.size).reshape(out.shape) * 0.01)


def _jax(layers, x, dtype=jnp.float32):
    def loss(x_, ls):
        out, _ = birnn_apply_pallas_trainable(ls, x_, compute_dtype=dtype,
                                              b_tile=8, interpret=True,
                                              cell="lstm")
        return jnp.sum(out * _weights(out)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), layers)
    return np.asarray(out), np.asarray(grads[0]), grads[1]


def _torch_leaves(layers):
    return [{d: {k: torch.tensor(np.asarray(v), requires_grad=True)
                 for k, v in ld[d].items()} for d in ("fwd", "bwd")}
            for ld in layers]


def _port(layers, x, dtype=torch.float32):
    leaves = _torch_leaves(layers)
    xt = torch.tensor(x, requires_grad=True)
    out, h_n = bigru_vjp.birnn_apply_trainable(
        [layer_weights(ld) for ld in leaves], xt, dtype, cell="lstm")
    w = torch.cos(torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape)
                  * 0.01)
    flat = jax.tree_util.tree_leaves(leaves)
    grads = torch.autograd.grad((out * w).sum(), [xt] + flat)
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(leaves),
                                        [g.numpy() for g in grads[1:]])
    return out.detach().numpy(), h_n.detach().numpy(), grads[0].numpy(), tree


def _assert_tree_close(got, want, atol, rtol):
    a, b = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(a) == len(b) and len(a) > 0
    for u, v in zip(a, b):
        np.testing.assert_allclose(u, np.asarray(v), atol=atol, rtol=rtol)


def test_forward_matches_pallas():
    rng = np.random.RandomState(0)
    B, L, C, H = 6, 21, 11, 16
    layers = init_rnn_params(rng, C, H, 2, "lstm")
    x = rng.randn(B, L, C).astype(np.float32)
    out_j, hn_j = birnn_apply_pallas_trainable(layers, jnp.asarray(x), b_tile=8,
                                               interpret=True, cell="lstm")
    out, h_n, _dx, _g = _port(layers, x)
    np.testing.assert_allclose(out, np.asarray(out_j), atol=3e-5, rtol=1e-5)
    np.testing.assert_allclose(h_n, np.asarray(hn_j), atol=3e-5, rtol=1e-5)


def test_gradients_match_pallas_single_layer():
    rng = np.random.RandomState(1)
    B, L, C, H = 5, 9, 7, 8
    layers = init_rnn_params(rng, C, H, 1, "lstm")
    x = rng.randn(B, L, C).astype(np.float32)
    _out_j, dx_j, g_j = _jax(layers, x)
    _out, _hn, dx, g = _port(layers, x)
    np.testing.assert_allclose(dx, dx_j, atol=2e-4, rtol=1e-3)
    _assert_tree_close(g, g_j, atol=2e-4, rtol=1e-3)


def test_gradients_match_pallas_multilayer():
    rng = np.random.RandomState(2)
    B, L, C, H = 4, 11, 6, 8
    layers = init_rnn_params(rng, C, H, 2, "lstm")
    x = rng.randn(B, L, C).astype(np.float32)
    _o, dx_j, g_j = _jax(layers, x)
    _o, _hn, dx, g = _port(layers, x)
    np.testing.assert_allclose(dx, dx_j, atol=2e-4, rtol=1e-3)
    _assert_tree_close(g, g_j, atol=2e-4, rtol=1e-3)


def test_gradients_match_jax_grad_of_scan():
    """The same loss through the JAX package's lax.scan BiLSTM (jax.grad of
    ccsmeth_tpu.models.rnn.birnn_apply, no Pallas kernel)."""
    from ccsmeth_tpu.models.rnn import birnn_apply as jax_birnn_apply

    rng = np.random.RandomState(8)
    B, L, C, H = 5, 10, 6, 8
    layers = init_rnn_params(rng, C, H, 2, "lstm")
    x = rng.randn(B, L, C).astype(np.float32)
    zeros = jnp.zeros((4, B, H), jnp.float32)

    def loss(x_, ls):
        out, _ = jax_birnn_apply(ls, x_, zeros, zeros, "lstm")
        return jnp.sum(out * _weights(out))

    dx_j, g_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), layers)
    _o, _hn, dx, g = _port(layers, x)
    np.testing.assert_allclose(dx, np.asarray(dx_j), atol=2e-4, rtol=1e-3)
    _assert_tree_close(g, g_j, atol=2e-4, rtol=1e-3)


def test_batch_padding_gradients():
    """B=5 < the Pallas tile of 8: JAX pads rows, the port's kernels mask the
    ragged tile; padded rows must add nothing to the weight gradients."""
    rng = np.random.RandomState(3)
    B, L, C, H = 5, 7, 4, 8
    layers = init_rnn_params(rng, C, H, 1, "lstm")
    x = rng.randn(B, L, C).astype(np.float32)
    _o, _dx, g_j = _jax(layers, x)
    _o, _hn, _dx, g = _port(layers, x)
    _assert_tree_close(g, g_j, atol=2e-4, rtol=1e-3)


def test_bf16_matches_pallas_bf16():
    """bf16 operands on both sides (x, weights, dout, da rounded to bf16,
    residuals h, c and gates stored in bf16, f32 sums, c carried in f32). An
    f32 sum taken in another order can round a stored bf16 value the other
    way: one bf16 ulp, 2^-8 relative. So out is held to 2^-8 of its largest
    magnitude and the gradients to 2^-6 of theirs (an ulp flip in a residual
    moves the gradients downstream of it by the same relative amount, a few
    times over), as for the GRU (tests/test_torch_bigru_vjp.py)."""
    rng = np.random.RandomState(4)
    B, L, C, H = 6, 11, 7, 16
    layers = init_rnn_params(rng, C, H, 2, "lstm")
    x = rng.randn(B, L, C).astype(np.float32)
    out_j, dx_j, g_j = _jax(layers, x, jnp.bfloat16)
    out, _hn, dx, g = _port(layers, x, torch.bfloat16)
    assert np.abs(out - out_j).max() <= 2.0 ** -8 * np.abs(out_j).max()
    assert np.abs(dx - dx_j).max() <= 2.0 ** -6 * np.abs(dx_j).max()
    for u, v in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(g_j)):
        v = np.asarray(v)
        assert np.abs(u - v).max() <= 2.0 ** -6 * np.abs(v).max() + 1e-6


@pytest.mark.parametrize("cin", [11, 12])
def test_plain_k6_matches_autograd(cin):
    """The plain K6 backward (the formulas, no autograd) against
    torch.autograd through models/rnn.py's BiLSTM for one layer, fp32."""
    rng = np.random.RandomState(5 + cin)
    L, N, H = 9, 6, 8
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, cin, H, 1, "lstm")[0])
    x = torch.from_numpy(rng.randn(L, N, cin).astype(np.float32))
    dout = torch.from_numpy(rng.randn(L, N, 2 * H).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, wih, bih, whh, bhh)]
    out_ref, _ = birnn_tm([tuple(leaves[1:])], leaves[0], cell="lstm")
    want = torch.autograd.grad(out_ref, leaves, grad_outputs=dout)
    out, c, gates = bilstm_vjp.bilstm_layer_train_fwd_plain(x, wih, bih, whh, bhh)
    torch.testing.assert_close(out, out_ref.detach(), atol=1e-6, rtol=0)
    assert c.shape == (2, L, N, H) and gates.shape == (2, L, N, 4 * H)
    dx, dwih, dbih, dwhh, dbhh = bilstm_vjp.bilstm_layer_bwd_plain(
        dout, x, wih, whh, out, c, gates)
    for a, b in zip((dx, dwih, dbih, dwhh, dbhh), want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert torch.equal(dbih, dbhh) and dbih.data_ptr() != dbhh.data_ptr()


def test_layer_fn_counts_and_rejects():
    """On CPU tensors the wrappers run the plain versions (no kernel launch);
    inputs the kernels would not take raise."""
    rng = np.random.RandomState(6)
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, 5, 8, 1, "lstm")[0])
    x = torch.from_numpy(rng.randn(4, 3, 5).astype(np.float32))
    f0, b0, p0 = (bilstm_vjp.launches_fwd, bilstm_vjp.launches_bwd,
                  bilstm_vjp.plain_calls)
    ws = [t.requires_grad_(True) for t in (wih, bih, whh, bhh)]
    out = bilstm_vjp.BiLSTMLayerFn.apply(x, *ws, torch.float32)
    out.sum().backward()
    assert (bilstm_vjp.launches_fwd, bilstm_vjp.launches_bwd) == (f0, b0)
    assert bilstm_vjp.plain_calls == p0 + 2
    assert all(torch.isfinite(t.grad).all() for t in ws)
    with pytest.raises(ValueError):  # operand type differs from compute type
        bilstm_vjp.bilstm_layer_train_fwd(x.to(torch.bfloat16), wih.detach(),
                                          bih.detach(), whh.detach(), bhh.detach(),
                                          torch.float32)
    with pytest.raises(ValueError):  # bias of the wrong shape
        bilstm_vjp.bilstm_layer_train_fwd(x, wih.detach(), bih.detach(),
                                          whh.detach(), bhh.detach()[:1],
                                          torch.float32)
    with pytest.raises(ValueError):  # GRU weights (3H columns)
        g = layer_weights(init_rnn_params(rng, 5, 8, 1, "gru")[0])
        bilstm_vjp.bilstm_layer_train_fwd(x, *g, torch.float32)
    with pytest.raises(ValueError):
        bigru_vjp.birnn_apply_trainable([(wih, bih, whh, bhh)], x, cell="rnn_tanh")

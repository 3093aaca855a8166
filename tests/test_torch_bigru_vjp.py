"""K4/K5's plain versions through BiGRULayerFn (birnn_apply_trainable on CPU
tensors, torch.autograd.grad) against the JAX package's custom-VJP Pallas
kernels (birnn_apply_pallas_trainable, b_tile=8, interpret mode, jax.grad):
the same numpy params and inputs, the loss sum(out * cos(0.01 * arange)), as
tests/test_pallas_vjp.py sets it up."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsmeth_tpu.models.rnn import init_rnn_params
from ccsmeth_tpu.ops.bigru_pallas_vjp import birnn_apply_pallas_trainable
from ccsmeth_tpu_torch.models.rnn import birnn_tm, layer_weights
from ccsmeth_tpu_torch.ops import bigru_vjp

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once


def _weights(out):
    return jnp.cos(jnp.arange(out.size).reshape(out.shape) * 0.01)


def _jax(layers, x, dtype=jnp.float32):
    def loss(x_, ls):
        out, _ = birnn_apply_pallas_trainable(ls, x_, compute_dtype=dtype,
                                              b_tile=8, interpret=True)
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
        [layer_weights(ld) for ld in leaves], xt, dtype)
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
    layers = init_rnn_params(rng, C, H, 2, "gru")
    x = rng.randn(B, L, C).astype(np.float32)
    out_j, hn_j = birnn_apply_pallas_trainable(layers, jnp.asarray(x), b_tile=8,
                                               interpret=True)
    out, h_n, _dx, _g = _port(layers, x)
    np.testing.assert_allclose(out, np.asarray(out_j), atol=3e-5, rtol=1e-5)
    np.testing.assert_allclose(h_n, np.asarray(hn_j), atol=3e-5, rtol=1e-5)


def test_gradients_match_pallas_single_layer():
    rng = np.random.RandomState(1)
    B, L, C, H = 5, 9, 7, 8
    layers = init_rnn_params(rng, C, H, 1, "gru")
    x = rng.randn(B, L, C).astype(np.float32)
    _out_j, dx_j, g_j = _jax(layers, x)
    _out, _hn, dx, g = _port(layers, x)
    np.testing.assert_allclose(dx, dx_j, atol=1e-4, rtol=1e-3)
    _assert_tree_close(g, g_j, atol=2e-4, rtol=1e-3)


def test_gradients_match_pallas_multilayer():
    rng = np.random.RandomState(2)
    B, L, C, H = 4, 11, 6, 8
    layers = init_rnn_params(rng, C, H, 2, "gru")
    x = rng.randn(B, L, C).astype(np.float32)
    _o, dx_j, g_j = _jax(layers, x)
    _o, _hn, dx, g = _port(layers, x)
    np.testing.assert_allclose(dx, dx_j, atol=3e-4, rtol=2e-3)
    _assert_tree_close(g, g_j, atol=3e-4, rtol=2e-3)


def test_batch_padding_gradients():
    """B=5 < the Pallas tile of 8: JAX pads rows, the port's kernels mask the
    ragged tile; padded rows must add nothing to the weight gradients."""
    rng = np.random.RandomState(3)
    B, L, C, H = 5, 7, 4, 8
    layers = init_rnn_params(rng, C, H, 1, "gru")
    x = rng.randn(B, L, C).astype(np.float32)
    _o, _dx, g_j = _jax(layers, x)
    _o, _hn, _dx, g = _port(layers, x)
    _assert_tree_close(g, g_j, atol=2e-4, rtol=1e-3)


def test_bf16_matches_pallas_bf16():
    """bf16 operands on both sides (x, weights, dout, dxg/dhg rounded to bf16,
    residuals and outputs stored in bf16, f32 sums). An f32 sum taken in
    another order can round a stored bf16 value the other way: one bf16 ulp,
    2^-8 relative. So out is held to 2^-8 of its largest magnitude and the
    gradients to 2^-6 of theirs (an ulp flip in a residual moves the
    gradients downstream of it by the same relative amount, a few times
    over). Measured on CPU: out and dx equal, the weight gradients within
    2.3e-5 of their largest magnitude."""
    rng = np.random.RandomState(4)
    B, L, C, H = 6, 11, 7, 16
    layers = init_rnn_params(rng, C, H, 2, "gru")
    x = rng.randn(B, L, C).astype(np.float32)
    out_j, dx_j, g_j = _jax(layers, x, jnp.bfloat16)
    out, _hn, dx, g = _port(layers, x, torch.bfloat16)
    assert np.abs(out - out_j).max() <= 2.0 ** -8 * np.abs(out_j).max()
    assert np.abs(dx - dx_j).max() <= 2.0 ** -6 * np.abs(dx_j).max()
    for u, v in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(g_j)):
        v = np.asarray(v)
        assert np.abs(u - v).max() <= 2.0 ** -6 * np.abs(v).max() + 1e-6


@pytest.mark.parametrize("cin", [11, 12])
def test_plain_k5_matches_autograd(cin):
    """The plain K5 (the formulas, no autograd) against torch.autograd
    through models/rnn.py's BiGRU for one layer, fp32."""
    rng = np.random.RandomState(5 + cin)
    L, N, H = 9, 6, 8
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, cin, H, 1)[0])
    x = torch.from_numpy(rng.randn(L, N, cin).astype(np.float32))
    dout = torch.from_numpy(rng.randn(L, N, 2 * H).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, wih, bih, whh, bhh)]
    out_ref, _ = birnn_tm([tuple(leaves[1:])], leaves[0])
    want = torch.autograd.grad(out_ref, leaves, grad_outputs=dout)
    out, gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh, bhh)
    torch.testing.assert_close(out, out_ref.detach(), atol=1e-6, rtol=0)
    dx, dwih, dbih, dwhh, dbhh = bigru_vjp.bigru_layer_bwd_plain(
        dout, x, wih, whh, out, gates)
    for a, b in zip((dx, dwih, dbih, dwhh, dbhh), want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_layer_fn_counts_and_rejects():
    """On CPU tensors the wrappers run the plain versions (no kernel launch);
    inputs the kernels would not take raise."""
    rng = np.random.RandomState(6)
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, 5, 8, 1)[0])
    x = torch.from_numpy(rng.randn(4, 3, 5).astype(np.float32))
    f0, b0, p0 = (bigru_vjp.launches_fwd, bigru_vjp.launches_bwd,
                  bigru_vjp.plain_calls)
    ws = [t.requires_grad_(True) for t in (wih, bih, whh, bhh)]
    out = bigru_vjp.BiGRULayerFn.apply(x, *ws, torch.float32)
    out.sum().backward()
    assert (bigru_vjp.launches_fwd, bigru_vjp.launches_bwd) == (f0, b0)
    assert bigru_vjp.plain_calls == p0 + 2
    with pytest.raises(ValueError):
        bigru_vjp.bigru_layer_train_fwd(x.to(torch.bfloat16), wih.detach(), bih.detach(),
                                        whh.detach(), bhh.detach(), torch.float32)
    with pytest.raises(ValueError):
        bigru_vjp.bigru_layer_train_fwd(x, wih.detach(), bih.detach(), whh.detach(),
                                        bhh.detach()[:1], torch.float32)


def test_dropout_between_layers():
    """Dropout keeps about 1 - rate of the entries, scales them by
    1/(1 - rate), and the same generator seed gives the same masks."""
    x = torch.ones(200, 50)
    y = bigru_vjp.dropout(x, 0.3, torch.Generator().manual_seed(3))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    z = bigru_vjp.dropout(x, 0.3, torch.Generator().manual_seed(3))
    assert torch.equal(y, z)
    assert bigru_vjp.dropout(x, 0.3, None) is x

"""K1's LSTM cell (ccsmeth_tpu_torch/ops/csrc/bigru_stack.cu, cell 'lstm'; its
bf16 tensor-core design csrc/birnn_tc.cu) and kernel K6 (ccsmeth_tpu_torch/ops/csrc/bilstm_train.cu) against their plain
PyTorch versions on the card. Needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_lstm_kernels_cuda.py
(tests/conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru, bigru_vjp, bilstm_vjp

# fp32: outputs to 1e-5; dW and db to 1e-5 * max|ref| + 1e-5, since they sum
# L*N rows in another order. bf16: stored values one bf16 ulp apart where an
# f32 sum taken in another order rounds the other way (2^-8 on [0.5, 1)), so
# 1e-2, times max|ref| where that exceeds 1 (the cell state c may), and
# gradients to 1e-2 of max|ref| (a da operand rounded to bf16 the other way
# moves one product by 2^-8 of itself).
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SHAPES = [(13, 16, 11), (300, 64, 128), (1024, 256, 11), (1024, 256, 512)]


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _grad_tol(ref, dtype):
    scale = ref.abs().max().item()
    return 1e-5 * scale + 1e-5 if dtype == torch.float32 else 1e-2 * scale + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,layers", [(13, 16, 3), (300, 64, 2),
                                                (1000, 256, 3)])
def test_k1_lstm_matches_plain(dtype, rows, hidden, layers):
    """Odd row counts exercise the ragged last tile; H=256, NL=3 is the
    attbilstm2s default."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(rows)
    ly = [layer_weights(ld, dt, "cuda")
          for ld in init_rnn_params(rng, 11, hidden, layers, "lstm")]
    x = torch.from_numpy(rng.randn(21, rows, 11).astype(np.float32)).to("cuda", dt)
    before = bigru.launches
    out, hn = bigru.birnn_stack(ly, x, dt, "lstm")
    torch.cuda.synchronize()
    assert bigru.launches == before + 1
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, "lstm")
    assert out.dtype == dt and out.shape == (21, rows, 2 * hidden)
    assert hn.dtype == torch.float32 and hn.shape == (2 * layers, rows, hidden)
    assert _err(out, ref_out) <= TOL[dtype]
    assert _err(hn, ref_hn) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [16, 64, 256])
@pytest.mark.parametrize("rows", [1, 13, 1000, 1029])
def test_k1_lstm_tc_design_matches_plain(rows, hidden):
    """The bf16 tensor-core design (csrc/birnn_tc.cu), LSTM cell, three
    layers: against the plain version at ragged row counts (one row, a part
    tile, 15.6 and 16.1 tiles of 64), and bit-equal on a rerun."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = torch.bfloat16
    rng = np.random.RandomState(rows + hidden)
    ly = [layer_weights(ld, dt, "cuda")
          for ld in init_rnn_params(rng, 11, hidden, 3, "lstm")]
    x = torch.from_numpy(rng.randn(21, rows, 11).astype(np.float32)).to("cuda", dt)
    before = bigru.design_calls["tc"]
    out, hn = bigru.birnn_stack(ly, x, dt, "lstm")
    out2, hn2 = bigru.birnn_stack(ly, x, dt, "lstm")
    torch.cuda.synchronize()
    assert bigru.design_calls["tc"] == before + 2
    assert torch.equal(out, out2) and torch.equal(hn, hn2)
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, "lstm")
    assert out.shape == (21, rows, 2 * hidden) and hn.shape == (6, rows, hidden)
    assert _err(out, ref_out) <= TOL["bfloat16"]
    assert _err(hn, ref_hn) <= TOL["bfloat16"]


def _case(rows, hidden, cin, dtype, seed=0):
    rng = np.random.RandomState(seed + rows + cin)
    (wih, bih, whh, bhh), = [layer_weights(ld, dtype, "cuda")
                             for ld in init_rnn_params(rng, cin, hidden, 1, "lstm")]
    x = torch.from_numpy(rng.randn(21, rows, cin).astype(np.float32)).to("cuda", dtype)
    dout = torch.from_numpy(rng.randn(21, rows, 2 * hidden).astype(np.float32)
                            ).to("cuda", dtype)
    return x, wih, bih, whh, bhh, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", SHAPES)
def test_k6_forward_matches_plain(dtype, rows, hidden, cin):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, _ = _case(rows, hidden, cin, dt)
    before = bilstm_vjp.launches_fwd
    got = bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    torch.cuda.synchronize()
    assert bilstm_vjp.launches_fwd == before + 1
    ref = bilstm_vjp.bilstm_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    for name, a, r in zip(("out", "c", "gates"), got, ref):
        assert a.dtype == dt and a.shape == r.shape, name
        tol = TOL[dtype] * max(1.0, r.float().abs().max().item())
        assert _err(a, r) <= tol, (name, _err(a, r), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", SHAPES)
def test_k6_backward_matches_plain_and_is_deterministic(dtype, rows, hidden, cin):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, dt)
    out, c, gates = bilstm_vjp.bilstm_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    args = (dout, x, wih, whh, out, c, gates, dt)
    before = bilstm_vjp.launches_bwd
    got = bilstm_vjp.bilstm_layer_bwd(*args)
    again = bilstm_vjp.bilstm_layer_bwd(*args)
    torch.cuda.synchronize()
    assert bilstm_vjp.launches_bwd == before + 2
    ref = bilstm_vjp.bilstm_layer_bwd_plain(*args)
    for name, a, b, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"),
                             got, again, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        assert torch.equal(a, b), name  # no atomics: bit-equal on a rerun
        tol = TOL[dtype] if (name == "dx" and dt == torch.float32) else _grad_tol(r, dt)
        assert _err(a, r) <= tol, (name, _err(a, r), tol)
    assert torch.equal(got[2], got[4])  # db_ih = db_hh


@pytest.mark.cuda
def test_trainable_stack_runs_k6():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(3)
    ly = [tuple(t.clone().requires_grad_(True) for t in layer_weights(ld, device="cuda"))
          for ld in init_rnn_params(rng, 11, 32, 2, "lstm")]
    x = torch.from_numpy(rng.randn(40, 21, 11).astype(np.float32)).cuda()
    f0, b0, p0 = (bilstm_vjp.launches_fwd, bilstm_vjp.launches_bwd,
                  bilstm_vjp.plain_calls)
    g0 = bigru_vjp.launches_fwd
    out, h_n = bigru_vjp.birnn_apply_trainable(ly, x, cell="lstm")
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (bilstm_vjp.launches_fwd - f0, bilstm_vjp.launches_bwd - b0) == (2, 2)
    assert bilstm_vjp.plain_calls == p0 and bigru_vjp.launches_fwd == g0
    assert out.shape == (40, 21, 64) and h_n.shape == (4, 40, 32)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for lyr in ly for t in lyr)


@pytest.mark.cuda
def test_lstm_kernels_reject_what_they_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, wih, bih, whh, bhh, _ = _case(8, 16, 11, torch.float32)
    with pytest.raises(ValueError):  # operand type differs from compute type
        bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, torch.bfloat16)
    with pytest.raises(ValueError):  # LSTM weights given to the GRU cell
        bigru.birnn_stack([(wih, bih, whh, bhh)], x, torch.float32, "gru")

"""Kernels K4 and K5 (ccsmeth_tpu_torch/ops/csrc/bigru_train.cu) against their
plain PyTorch versions on the card. Needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_train_kernels_cuda.py
(tests/conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru_vjp

# fp32: out, gates and dx to 1e-5; dW and db to 1e-5 * max|ref| + 1e-5, since
# they sum L*N rows in another order. bf16: stored values one bf16 ulp apart
# on [0.5, 1) (2^-8) where an f32 sum taken in another order rounds the other
# way, so 1e-2 absolute for out/gates and 1e-2 relative to max|ref| for the
# gradients (a dxg operand rounded to bf16 the other way moves one product by
# 2^-8 of itself).
SHAPES = [(13, 16, 11), (300, 64, 128), (1024, 256, 11), (1024, 256, 512)]


def _case(rows, hidden, cin, dtype, seed=0):
    rng = np.random.RandomState(seed + rows + cin)
    (wih, bih, whh, bhh), = [layer_weights(ld, dtype, "cuda")
                             for ld in init_rnn_params(rng, cin, hidden, 1)]
    x = torch.from_numpy(rng.randn(21, rows, cin).astype(np.float32)).to("cuda", dtype)
    dout = torch.from_numpy(rng.randn(21, rows, 2 * hidden).astype(np.float32)
                            ).to("cuda", dtype)
    return x, wih, bih, whh, bhh, dout


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _grad_tol(ref, dtype):
    scale = ref.abs().max().item()
    return 1e-5 * scale + 1e-5 if dtype == torch.float32 else 1e-2 * scale + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", SHAPES)
def test_k4_matches_plain(dtype, rows, hidden, cin):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, _ = _case(rows, hidden, cin, dt)
    before = bigru_vjp.launches_fwd
    out, gates = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    torch.cuda.synchronize()
    assert bigru_vjp.launches_fwd == before + 1
    ref_out, ref_gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh,
                                                               bhh, dt)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert out.dtype == dt and gates.shape == (2, 21, rows, 4 * hidden)
    assert _err(out, ref_out) <= tol
    assert _err(gates, ref_gates) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", SHAPES)
def test_k5_matches_plain_and_is_deterministic(dtype, rows, hidden, cin):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, dt)
    out, gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    before = bigru_vjp.launches_bwd
    got = bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, out, gates, dt)
    again = bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, out, gates, dt)
    torch.cuda.synchronize()
    assert bigru_vjp.launches_bwd == before + 2
    ref = bigru_vjp.bigru_layer_bwd_plain(dout, x, wih, whh, out, gates, dt)
    for name, a, b, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"),
                             got, again, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        assert torch.equal(a, b), name  # no atomics: bit-equal on a rerun
        tol = 1e-5 if (name == "dx" and dt == torch.float32) else _grad_tol(r, dt)
        assert _err(a, r) <= tol, (name, _err(a, r), tol)


@pytest.mark.cuda
def test_layer_fn_runs_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, wih, bih, whh, bhh, _ = _case(40, 32, 11, torch.float32)
    ws = [t.clone().requires_grad_(True) for t in (wih, bih, whh, bhh)]
    xr = x.clone().requires_grad_(True)
    f0, b0, p0 = (bigru_vjp.launches_fwd, bigru_vjp.launches_bwd,
                  bigru_vjp.plain_calls)
    out = bigru_vjp.BiGRULayerFn.apply(xr, *ws, torch.float32)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (bigru_vjp.launches_fwd - f0, bigru_vjp.launches_bwd - b0) == (1, 1)
    assert bigru_vjp.plain_calls == p0
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in [xr] + ws)


@pytest.mark.cuda
def test_kernels_reject_what_they_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, wih, bih, whh, bhh, _ = _case(8, 16, 11, torch.float32)
    with pytest.raises(ValueError):  # operand type differs from compute type
        bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, torch.bfloat16)
    with pytest.raises(ValueError):  # not contiguous
        bigru_vjp.bigru_layer_train_fwd(x.transpose(0, 1).contiguous().transpose(0, 1),
                                        wih, bih, whh, bhh, torch.float32)

"""K1's LSTM cell (ccsmeth_tpu_torch/ops/csrc/bigru_stack.cu, cell 'lstm'; its
bf16 tensor-core design csrc/birnn_tc.cu) and kernel K6
(ccsmeth_tpu_torch/ops/csrc/bilstm_train.cu, in both designs that
``k45_plan(H, dtype, "lstm")`` picks: simt for fp32 and bf16 H = 16, tc for
bf16 H = 32 .. 256) against their plain PyTorch versions on the card, phase
by phase and whole, with the CUDA launches of each call. Needs a CUDA device
and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_lstm_kernels_cuda.py
(tests/conftest.py imports JAX).
"""

import hashlib

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


def _fwd_matches_plain(x, wih, bih, whh, bhh, dt):
    """K6's forward against its plain version, with its two CUDA launches
    (projection, recurrence); returns the plain version's residuals."""
    dname = str(dt).split(".")[-1]
    before = bilstm_vjp.launches_fwd
    bilstm_vjp.cuda_launches = 0
    got = bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    torch.cuda.synchronize()
    assert bilstm_vjp.launches_fwd == before + 1 and bilstm_vjp.cuda_launches == 2
    ref = bilstm_vjp.bilstm_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    for name, a, r in zip(("out", "c", "gates"), got, ref):
        assert a.dtype == dt and a.shape == r.shape, name
        tol = TOL[dname] * max(1.0, r.float().abs().max().item())
        assert _err(a, r) <= tol, (name, _err(a, r), tol)
    return ref


def _bwd_matches_plain(dout, x, wih, whh, residuals, dt):
    """K6's backward against its plain version on the same residuals, with
    its CUDA launches (recurrence, dx, weight gradients, and the slice sum
    when S > 1) and a bit-equal rerun."""
    dname = str(dt).split(".")[-1]
    L, N, C = x.shape
    H = whh.shape[1]
    plan = bigru_vjp.k45_plan(H, dt, "lstm")
    S = bigru_vjp.k5_wgrad_slices(L * N, C, H, torch.cuda.get_device_properties(
        0).multi_processor_count, plan["design"], 4)
    args = (dout, x, wih, whh) + tuple(residuals) + (dt,)
    before = bilstm_vjp.launches_bwd
    bilstm_vjp.cuda_launches = 0
    got = bilstm_vjp.bilstm_layer_bwd(*args)
    assert bilstm_vjp.cuda_launches == 3 + (S > 1)
    again = bilstm_vjp.bilstm_layer_bwd(*args)
    torch.cuda.synchronize()
    assert bilstm_vjp.launches_bwd == before + 2
    ref = bilstm_vjp.bilstm_layer_bwd_plain(*args)
    for name, a, b, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"),
                             got, again, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        assert torch.equal(a, b), name  # no atomics: bit-equal on a rerun
        tol = TOL[dname] if (name == "dx" and dt == torch.float32) else _grad_tol(r, dt)
        assert _err(a, r) <= tol, (name, _err(a, r), tol)
    assert torch.equal(got[2], got[4])  # db_ih = db_hh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", SHAPES)
def test_k6_forward_matches_plain(dtype, rows, hidden, cin):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, _ = _case(rows, hidden, cin, dt)
    _fwd_matches_plain(x, wih, bih, whh, bhh, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", SHAPES)
def test_k6_backward_matches_plain_and_is_deterministic(dtype, rows, hidden, cin):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, dt)
    residuals = bilstm_vjp.bilstm_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    _bwd_matches_plain(dout, x, wih, whh, residuals, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,design", [("float32", "simt"), ("bfloat16", "tc")])
@pytest.mark.parametrize("hidden", [16, 64, 256])
@pytest.mark.parametrize("rows", [1, 13, 1000, 1029])
def test_k6_designs_at_ragged_rows(rows, hidden, dtype, design):
    """Both designs at one row, a part tile and 1000 / 1029 rows (ragged
    against tiles of 32, 64, 128 and 256 rows), at H = 16, 64 and 256 (the
    simt forward's 2-unit and 1-unit threads, a tile cut to fit, clusters of
    1, 2, 4 and 8). bf16 at H = 16 runs simt, as the shape rule says."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    want = "simt" if hidden == 16 else design
    assert bigru_vjp.k45_plan(hidden, dt, "lstm")["design"] == want
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, 11 if rows % 2 else 128, dt)
    before = bilstm_vjp.design_calls[want]
    residuals = _fwd_matches_plain(x, wih, bih, whh, bhh, dt)
    _bwd_matches_plain(dout, x, wih, whh, residuals, dt)
    assert bilstm_vjp.design_calls[want] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", [(65, 32, 11), (1000, 256, 512),
                                             (1024, 256, 11)])
def test_each_k6_phase_matches_matmul(dtype, rows, hidden, cin):
    """Each product of K6 alone, against torch.matmul in f32 on the same
    operands rounded to the operand type: the projection (all of b_hh
    folded), dx, dW_ih, dW_hh and the bias sum of the unrounded da; and the
    backward recurrence's da against the plain step's gate gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, dt)
    plan = bigru_vjp.k45_plan(hidden, dt, "lstm")
    L, N, C, H = 21, rows, cin, hidden

    def op(t):
        return t.to(dt).float()

    def sum_tol(a, b):
        return 1e-5 * (a.abs() @ b.abs()).max().item() + 1e-6

    xs = op(x).reshape(L * N, C)
    xg = bigru_vjp.k4_projection(x, wih, bih, bhh, plan, dt)
    for d in (0, 1):
        ref = xs @ op(wih[d]) + (bih[d] + bhh[d])
        assert _err(xg[d], ref) <= sum_tol(xs, op(wih[d])), ("xg", d)

    out, c, gates = bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    da = bilstm_vjp.k6_bwd_recurrence(dout, c, gates, whh, plan, dt)
    # the plain step's da at the direction's last step, where dh = dc = 0
    for d, t in ((0, L - 1), (1, 0)):
        g = gates[d, t].float()
        i, f, gg, o = (g[:, k * H:(k + 1) * H] for k in range(4))
        tc = torch.tanh(c[d, t].float())
        dh_t = dout[t, :, d * H:(d + 1) * H].float()
        dcv = dh_t * o * (1.0 - tc * tc)
        cp = c[d, t - 1].float() if d == 0 else c[d, t + 1].float()
        ref = torch.cat([dcv * gg * i * (1.0 - i), dcv * cp * f * (1.0 - f),
                         dcv * i * (1.0 - gg * gg), dh_t * tc * o * (1.0 - o)], dim=1)
        assert _err(da[d].view(L, N, 4 * H)[t], ref) <= 1e-5, ("da", d)

    dx = bigru_vjp.k5_dx(da, wih, plan, dt)
    a = torch.cat([op(da[0]), op(da[1])], dim=1)
    b = torch.cat([op(wih[0]).T, op(wih[1]).T], dim=0)
    assert _err(dx, a @ b) <= sum_tol(a, b), "dx"
    dw_ih, db_ih, dw_hh, db_hh = bigru_vjp.k5_weight_grads(x, out, da, da, plan, dt)
    assert db_hh.data_ptr() == db_ih.data_ptr()  # one gate gradient: one column sum
    o = out.float()
    for d in (0, 1):
        h_prev = torch.zeros((L, N, H), device="cuda")
        if d == 0:
            h_prev[1:] = o[:-1, :, :H]
        else:
            h_prev[:-1] = o[1:, :, H:]
        h_prev = h_prev.reshape(L * N, H)
        assert _err(dw_ih[d], xs.T @ op(da[d])) <= sum_tol(xs.T, op(da[d])), ("dw_ih", d)
        assert _err(dw_hh[d], h_prev.T @ op(da[d])) <= sum_tol(h_prev.T, op(da[d])), \
            ("dw_hh", d)
        ones = torch.ones((1, L * N), device="cuda")
        assert _err(db_ih[d], da[d].sum(0)) <= sum_tol(ones, da[d]), ("db", d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [20, 48])
def test_k6_refused_shape_raises_before_any_launch(hidden, dtype):
    """H = 20 and 48: neither design takes them; K6 raises ValueError naming
    both reasons and launches nothing, and no plain version runs in its
    place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(16, hidden, 11, dt)
    out, c, gates = bilstm_vjp.bilstm_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    bilstm_vjp.cuda_launches = 0
    plain = bilstm_vjp.plain_calls
    with pytest.raises(ValueError, match="K6 takes no design for H={}: simt".format(hidden)):
        bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    with pytest.raises(ValueError, match="no design for H={}".format(hidden)):
        bilstm_vjp.bilstm_layer_bwd(dout, x, wih, whh, out, c, gates, dt)
    assert bilstm_vjp.cuda_launches == 0 and bilstm_vjp.plain_calls == plain


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


# sha256 of K6's forward (out, c, gates) and backward (five gradients) on
# ``_case(rows, hidden, cin, dtype)``, taken on an H100 from the kernels as
# they were before the simt forward recurrence of csrc/rnn_train_rec.cuh took
# its inference switch (K1's and K2's simt design): the switch leaves every
# bit of K6 as it was.
K6_DIGESTS = {
    (13, 16, 11, 'float32'): "27a5333ee06e32a6d8eae62be3969d3185ddf3f1279ab080a424b9d0d158f059",
    (13, 16, 11, 'bfloat16'): "35a56af56f78ee6ea72a52a31b5b0063ceea004c0de06eec2759d62ee0538748",
    (65, 32, 11, 'float32'): "daa9a63bbf73acd22573854597cf331459178de08b8ee46aa34930447055f6d5",
    (65, 32, 11, 'bfloat16'): "833e69ab225ed454a6aa42ee1e55fcceb8a853182e03a59bb569d83609da1fa5",
    (300, 64, 128, 'float32'): "6d8593209e7fa43be1040e7e788f76dae8b73f955f74149b91a61f32b55eb96a",
    (300, 64, 128, 'bfloat16'): "b55bf5e09ea4d6a38cec629b0a2f74d8eb32b100609474306838354ca69a6613",
    (1000, 256, 512, 'float32'): "a47aa601557fb0f5ae267f720e73331c69226840b16a4e4e1d72c58e619ee5bc",
    (1000, 256, 512, 'bfloat16'): "0d6119ede16b996464209ee16e5e9007c5c2d98241b92d0792632db8131183ab",
    (1024, 256, 11, 'float32'): "8642d22c68a0ac3647a3e3016743a776c0d6ee37328cdea8a14a71543e904d4c",
    (1024, 256, 11, 'bfloat16'): "7a55a851fe90b202265ce333c41a260dd16339d32611ab99eb3b0ebba573b212",
}


def k6_digest(rows, hidden, cin, dtype):
    """sha256 over the bytes of K6's forward and backward outputs on one
    case."""
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, dt)
    res = bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    grads = bilstm_vjp.bilstm_layer_bwd(dout, x, wih, whh, *res, dt)
    h = hashlib.sha256()
    for t in tuple(res) + tuple(grads):
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K6_DIGESTS))
def test_k6_outputs_bit_equal_to_before_the_inference_switch(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows, hidden, cin, dtype = case
    assert k6_digest(rows, hidden, cin, dtype) == K6_DIGESTS[case]

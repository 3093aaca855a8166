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
    its CUDA launches (recurrence, dx, weight gradients, and the sums:
    ``bigru_vjp.bwd_cuda_launches``) and a bit-equal rerun."""
    dname = str(dt).split(".")[-1]
    L, N, C = x.shape
    H = whh.shape[1]
    plan = bigru_vjp.k45_plan(H, dt, "lstm")
    args = (dout, x, wih, whh) + tuple(residuals) + (dt,)
    before = bilstm_vjp.launches_bwd
    bilstm_vjp.cuda_launches = 0
    got = bilstm_vjp.bilstm_layer_bwd(*args)
    assert bilstm_vjp.cuda_launches == bigru_vjp.bwd_cuda_launches(
        plan, L * N, C, torch.cuda.get_device_properties(0).multi_processor_count)
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


def _fwd_reruns_bit_equal(x, wih, bih, whh, bhh, dt):
    """K6's forward against its plain version (``_fwd_matches_plain``) and
    against a rerun, bit for bit."""
    _fwd_matches_plain(x, wih, bih, whh, bhh, dt)
    got = bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    again = bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "c", "gates"), got, again):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["R-1", "R+1", "512", "1000", "1029", "part-filled last wave"])
def test_k6_simt_forward_at_the_tile_edges(edge):
    """The simt forward at H = 256 on row counts at its tile's edges (72
    rows, the GRU's): one row short of a tile, one row past it, the 1s
    families' 512 rows (on the 80-row tile, one wave), the train path's
    ragged 1,000 and 1,029 rows, and two tiles a direction past a
    full wave (half the clusters the card holds at once) and 5 rows.
    Against the plain version, bit-equal on a rerun, in two CUDA launches;
    the library's tile rows and shared memory are the planner's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = bigru_vjp.k45_plan(256, torch.float32, "lstm")
    R = plan["rows_fwd"]
    occ = bigru_vjp.fwd_rec_occupancy(plan, torch.float32)
    assert (occ["rows"], occ["smem"]) == (R, plan["smem_fwd"])
    rows = {"R-1": R - 1, "R+1": R + 1, "1000": 1000, "1029": 1029,
            "part-filled last wave": R * (occ["clusters"] // 2 + 2) + 5, "512": 512}[edge]
    # the tile of the call: the plan's, or one more row a thread where that
    # saves a wave (the 1s families' 512 rows: 80), by the clusters read
    # when the library was loaded
    tile = bigru_vjp.fwd_rows(plan, rows)
    assert bigru_vjp.fwd_clusters["lstm"] == occ["clusters"]
    assert tile == bigru_vjp.simt_fwd_rows(plan, rows, occ["clusters"]) in (R, R + 8)
    _fwd_reruns_bit_equal(*_case(rows, 256, 11, torch.float32)[:5], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,dtype", [(16, "float32"), (16, "bfloat16"), (32, "float32"),
                                          (64, "float32"), (128, "float32"),
                                          (256, "float32")])
def test_k6_simt_forward_at_every_width(hidden, dtype):
    """Every H the simt design takes (clusters of 1, 2, 4 and 8; bf16 at
    H = 16, which tc refuses) at its forward tile's rows + 3 (a ragged
    second tile), C = 28: the simt design, against the plain version,
    bit-equal on a rerun, in two CUDA launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    plan = bigru_vjp.k45_plan(hidden, dt, "lstm")
    assert plan["design"] == "simt"
    assert bigru_vjp.fwd_rec_occupancy(plan, dt)["rows"] == plan["rows_fwd"]
    before = bilstm_vjp.design_calls["simt"]
    _fwd_reruns_bit_equal(*_case(plan["rows_fwd"] + 3, hidden, 28, dt)[:5], dt)
    assert bilstm_vjp.design_calls["simt"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["R-1", "R+1", "part-filled last wave"])
def test_k6_simt_backward_at_the_tile_edges(edge):
    """The simt backward at H = 256 on row counts at its tile's edges (72
    rows): one row short of a tile, one row past it (a second tile of one
    row), and two tiles a direction past a full wave (half the clusters the
    card holds at once, cudaOccupancyMaxActiveClusters) and 5 rows: a
    part-filled last wave ending in a ragged tile. Against the plain
    version, bit-equal on a rerun, with its CUDA launches; the library's
    tile rows and shared memory are the planner's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = bigru_vjp.k45_plan(256, torch.float32, "lstm")
    R = plan["rows_bwd"]
    occ = bigru_vjp.bwd_rec_occupancy(plan, torch.float32)
    assert (occ["rows"], occ["smem"]) == (R, plan["smem_bwd"])
    clusters = occ["clusters"]
    rows = {"R-1": R - 1, "R+1": R + 1,
            "part-filled last wave": R * (clusters // 2 + 2) + 5}[edge]
    x, wih, bih, whh, bhh, dout = _case(rows, 256, 11, torch.float32)
    residuals = bilstm_vjp.bilstm_layer_train_fwd_plain(x, wih, bih, whh, bhh, torch.float32)
    _bwd_matches_plain(dout, x, wih, whh, residuals, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,dtype", [(16, "float32"), (16, "bfloat16"), (32, "float32"),
                                          (64, "float32"), (128, "float32"),
                                          (256, "float32")])
def test_k6_simt_backward_at_every_width(hidden, dtype):
    """Every H the simt design takes (clusters of 1, 2, 4 and 8; bf16 at
    H = 16, which tc refuses) at its tile's rows + 3 (a ragged second tile),
    C = 28: the simt design, against the plain version, bit-equal on a
    rerun, with its CUDA launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    plan = bigru_vjp.k45_plan(hidden, dt, "lstm")
    assert plan["design"] == "simt"
    x, wih, bih, whh, bhh, dout = _case(plan["rows_bwd"] + 3, hidden, 28, dt)
    residuals = bilstm_vjp.bilstm_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    before = bilstm_vjp.design_calls["simt"]
    _bwd_matches_plain(dout, x, wih, whh, residuals, dt)
    assert bilstm_vjp.design_calls["simt"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", [(65, 32, 11), (1000, 256, 512),
                                             (1024, 256, 11)])
def test_each_k6_phase_matches_matmul(dtype, rows, hidden, cin):
    """Each product of K6 alone, against torch.matmul in f32 on the same
    operands rounded to the operand type: the projection (all of b_hh
    folded), dx, dW_ih, dW_hh and the bias sum of the unrounded da (simt's
    f32 da, tc's row-tile partials of it); and the backward recurrence's da
    against the plain step's gate gradients (tc stores da as bf16: against
    the reference rounded to bf16, where one bf16 ulp apart means the two
    f32 values lie on both sides of a rounding boundary)."""
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
    da, part = bilstm_vjp.k6_bwd_recurrence(dout, c, gates, whh, plan, dt)
    assert da.dtype == (torch.bfloat16 if plan["design"] == "tc" else torch.float32)
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
        got = da[d].view(L, N, 4 * H)[t].float()
        if da.dtype == torch.float32:
            assert _err(got, ref) <= 1e-5, ("da", d)
        else:
            want = ref.to(torch.bfloat16).float()
            # one bf16 ulp of each value: 2^-7 of its power of two
            ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
            diff = (got - want).abs()
            assert bool(((diff <= 1e-5) | (diff <= ulp)).all()), ("da", d)

    dx = bigru_vjp.k5_dx(da, wih, plan, dt)
    a = torch.cat([op(da[0]), op(da[1])], dim=1)
    b = torch.cat([op(wih[0]).T, op(wih[1]).T], dim=0)
    assert _err(dx, a @ b) <= sum_tol(a, b), "dx"
    dw_ih, db_ih, dw_hh, db_hh = bigru_vjp.k5_weight_grads(x, out, da, da, plan, dt, part)
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
        if part is None:
            ones = torch.ones((1, L * N), device="cuda")
            assert _err(db_ih[d], da[d].sum(0)) <= sum_tol(ones, da[d]), ("db", d)
        else:
            ones = torch.ones((1, part.shape[0]), device="cuda")
            assert _err(db_ih[d], part[:, 0, d].sum(0)) <= sum_tol(ones, part[:, 0, d]), \
                ("db", d)


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [11, 28, 512])
@pytest.mark.parametrize("rows,hidden", [(13, 32), (1000, 256), (1029, 256)])
def test_k6_tc_products_match_matmul_and_count_by_kernel(rows, hidden, cin):
    """K6's tc products alone, on a seeded bf16 da (both operands of the
    LSTM's products): dx, dW_ih and dW_hh on wgmma at every width
    (``bigru_vjp.gemm_calls``; X's rows by plain loads at C % 8 != 0); each
    against torch.matmul in f32 on the same bf16 operands, the bias gradient
    (once: db_hh is db_ih) against the sum of the tile partials, and
    bit-equal on a rerun, at ragged rows (13, 1000, 1029)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = torch.bfloat16
    x, wih, _, _, _, _ = _case(rows, hidden, cin, dt)
    plan = bigru_vjp.k45_plan(hidden, dt, "lstm")
    assert plan["design"] == "tc"
    L, N, H, G = 21, rows, hidden, 4 * hidden
    rng = np.random.RandomState(rows + cin + hidden)

    def seeded(shape, dtype=dt):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to("cuda", dtype)

    def sum_tol(a, b):
        return 1e-5 * (a.abs() @ b.abs()).max().item() + 1e-6

    da = seeded((2, L * N, G))
    out = seeded((L, N, 2 * H))
    part = seeded((-(-N // plan["rows_bwd"]), 1, 2, G), torch.float32)
    calls = dict(bigru_vjp.gemm_calls)
    dx = bigru_vjp.k5_dx(da, wih, plan, dt)
    grads = bigru_vjp.k5_weight_grads(x, out, da, da, plan, dt, part)
    assert bigru_vjp.gemm_calls == {"wgmma": calls["wgmma"] + 3}
    dx2 = bigru_vjp.k5_dx(da, wih, plan, dt)
    grads2 = bigru_vjp.k5_weight_grads(x, out, da, da, plan, dt, part)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    a = torch.cat([da[0].float(), da[1].float()], dim=1)
    b = torch.cat([wih[0].float().T, wih[1].float().T], dim=0)
    assert dx.shape == (L * N, cin) and _err(dx, a @ b) <= sum_tol(a, b), "dx"
    dw_ih, db_ih, dw_hh, db_hh = grads
    assert db_hh.data_ptr() == db_ih.data_ptr()
    xs, o = x.float().reshape(L * N, cin), out.float()
    ones = torch.ones((1, part.shape[0]), device="cuda")
    for d in (0, 1):
        h_prev = torch.zeros((L, N, H), device="cuda")
        if d == 0:
            h_prev[1:] = o[:-1, :, :H]
        else:
            h_prev[:-1] = o[1:, :, H:]
        h_prev = h_prev.reshape(L * N, H)
        g = da[d].float()
        assert _err(dw_ih[d], xs.T @ g) <= sum_tol(xs.T, g), ("dw_ih", d)
        assert _err(dw_hh[d], h_prev.T @ g) <= sum_tol(h_prev.T, g), ("dw_hh", d)
        assert _err(db_ih[d], part[:, 0, d].sum(0)) <= sum_tol(ones, part[:, 0, d]), ("db", d)


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


# sha256 of K6's forward (out, c, gates) and, apart, of its backward (five
# gradients) on ``_case(rows, hidden, cin, dtype)``, taken on an H100. The
# forward parts, and the backward parts of the simt design (fp32, and bf16 at
# H = 16), are the kernels' bits from before the tc backward's products moved
# to wgmma (taken on the parent tree); they pin the forward and the simt
# backward, which that move leaves as they were. The tc backward parts (bf16,
# H >= 32) were retaken on the wgmma products after they matched the plain
# version within the bf16 tolerances.
K6_DIGESTS = {
    (13, 16, 11, 'bfloat16'): ("9df2d8a6bad4ce195479a504ba69ba8db7d4e280b4ef1801a38e62ea638645f3",
                                "8c6081b9161e55c09a114c63d8e2d3399df0c7a77aeba1a01f7e3322d5598459"),
    (13, 16, 11, 'float32'): ("9f8043cf5378c22c38a16d9cd590ae6fb5a8db82239b5d7f845c43ac3459cddc",
                               "67f093464ab19e9bec8b01620a5417a747b20b60bea21cacad3c80a0905be72b"),
    (65, 32, 11, 'bfloat16'): ("5f94b96b9e09d210b915da2bc8313417d04e018ab26dfeb0e1e51c44ccc8ec6c",
                                "cd73ee9bec7aaeee11aa8d179d8259ee5019191954df816ef48888b6aeb9a210"),
    (65, 32, 11, 'float32'): ("f017d1b15be0533c254992fb22b82525071c8fa4317e18b0ba6f92dfbace1fa1",
                               "72dad1b664133a37c1517cf9bb8806ce3a207799848df1a7114e518cfe504b58"),
    (300, 64, 128, 'bfloat16'): ("d63db2849c4875a8d189fd8b5a6683eedc5fe625ee94a25ea43262c7b320d87a",
                                  "2724a64b8fc0a5600ab75b12c2673e3560871d22740f6ef812b0ce0331d258aa"),
    (300, 64, 128, 'float32'): ("56f53826469abcf35823f706c3191ea8f427ea14035cdb09083df6d0c790dc04",
                                 "c6e639f68aee0fb5eda3d0d1ea89589fc725c097fdef19ca1423aa28e52453ec"),
    (1000, 256, 512, 'bfloat16'): ("7c2a4afb5752cb900c5b37ac2c0bcc9c91d29743a8b20dfa8d0a3103ecbd9eb6",
                                    "8c8fbb6614f254b333a0ec059cc55d140bcabb1255ca2ca5b15e034ec2f6f857"),
    (1000, 256, 512, 'float32'): ("f744aff1022f857872dc4d33e1da5cb1593ee8f4f984a3c6989b5d56c99f79d0",
                                   "2c222736afc7af0321b51d3af30567d8dab25293066975306cca58d0f7123aef"),
    (1024, 256, 11, 'bfloat16'): ("7e646ab33bd58824c015e491bdb34a66305fdfb4ef24172d879bdb816df6f463",
                                   "3675e752b46c18940bb16fc4ec5059331ced1e6e711b31872233b07bc2b97720"),
    (1024, 256, 11, 'float32'): ("870aba40ebe54b1710e5cb90ab20b9cb911397ad999d9820b6a8cfd44977731d",
                                  "aaac39aa548762df7f8362f8a578bb1d31740767c7e7fc07fbef1ca79de98365"),
}


def k6_digests(rows, hidden, cin, dtype):
    """sha256 over the bytes of K6's forward outputs and, apart, over its
    backward's on one case: (forward, backward)."""
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, dt)
    res = bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    grads = bilstm_vjp.bilstm_layer_bwd(dout, x, wih, whh, *res, dt)
    parts = []
    for ts in (tuple(res), tuple(grads)):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
        parts.append(h.hexdigest())
    return tuple(parts)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K6_DIGESTS))
def test_k6_outputs_bit_equal_to_before_the_inference_switch(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows, hidden, cin, dtype = case
    assert k6_digests(rows, hidden, cin, dtype) == K6_DIGESTS[case]

"""Kernels K4 and K5 (ccsmeth_tpu_torch/ops/csrc/bigru_train.cu) against their
plain PyTorch versions on the card, in both designs that ``k45_plan`` picks
(simt for fp32 and bf16 H = 16, tc for bf16 H = 32, 64, 256), at the model's
shape and at row counts that leave the last tile of each design ragged (65,
300, 1000 against tiles of 32, 64, 128 and 512 rows). Needs a CUDA device and
skips without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_train_kernels_cuda.py
(tests/conftest.py imports JAX).
"""

import hashlib

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
SHAPES = [(13, 16, 11), (65, 32, 11), (300, 64, 128), (1000, 256, 512),
          (1024, 256, 11), (1024, 256, 512)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the references below


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


def _sum_tol(a, b):
    """An f32 sum of exact products in another order: 1e-5 of the largest
    sum of the products' magnitudes, a @ b taken on |a| and |b|."""
    return 1e-5 * (a.abs() @ b.abs()).max().item() + 1e-6


def _design(hidden, dt):
    return bigru_vjp.k45_plan(hidden, dt)["design"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", SHAPES)
def test_k4_matches_plain(dtype, rows, hidden, cin):
    _need_card()
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, _ = _case(rows, hidden, cin, dt)
    design = _design(hidden, dt)
    before, designs = bigru_vjp.launches_fwd, dict(bigru_vjp.design_calls)
    bigru_vjp.cuda_launches = 0
    out, gates = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    assert bigru_vjp.cuda_launches == 2  # the projection, the recurrence
    out2, gates2 = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    torch.cuda.synchronize()
    assert bigru_vjp.launches_fwd == before + 2
    assert bigru_vjp.design_calls[design] == designs[design] + 2
    assert torch.equal(out, out2) and torch.equal(gates, gates2)
    ref_out, ref_gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh,
                                                               bhh, dt)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert out.dtype == dt and gates.shape == (2, 21, rows, 4 * hidden)
    assert _err(out, ref_out) <= tol
    assert _err(gates, ref_gates) <= tol


def _k4_fwd_matches_plain(x, wih, bih, whh, bhh, dt):
    """K4 against its plain version, with its two CUDA launches (projection,
    recurrence) and a bit-equal rerun."""
    bigru_vjp.cuda_launches = 0
    got = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    assert bigru_vjp.cuda_launches == 2
    again = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    torch.cuda.synchronize()
    ref = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    for name, a, b, r in zip(("out", "gates"), got, again, ref):
        assert a.dtype == dt and a.shape == r.shape, name
        assert torch.equal(a, b), name
        assert _err(a, r) <= tol, (name, _err(a, r), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["R-1", "R+1", "512", "1000", "1029", "part-filled last wave"])
def test_k4_simt_forward_at_the_tile_edges(edge):
    """The simt forward at H = 256 on row counts at its tile's edges (72
    rows): one row short of a tile, one row past it (a second tile of one
    row), the 1s families' 512 rows (on the 80-row tile, one wave), the
    train path's ragged 1,000 and 1,029 rows, and two tiles a
    direction past a full wave (half the clusters the card holds at once,
    cudaOccupancyMaxActiveClusters) and 5 rows: a part-filled last wave
    ending in a ragged tile. Against the plain version, bit-equal on a
    rerun, in two CUDA launches; the library's tile rows and shared memory
    are the planner's."""
    _need_card()
    plan = bigru_vjp.k45_plan(256, torch.float32)
    R = plan["rows_fwd"]
    occ = bigru_vjp.fwd_rec_occupancy(plan, torch.float32)
    assert (occ["rows"], occ["smem"]) == (R, plan["smem_fwd"])
    rows = {"R-1": R - 1, "R+1": R + 1, "1000": 1000, "1029": 1029,
            "part-filled last wave": R * (occ["clusters"] // 2 + 2) + 5, "512": 512}[edge]
    # the tile of the call: the plan's, or one more row a thread where that
    # saves a wave (the 1s families' 512 rows: 80), by the clusters read
    # when the library was loaded
    tile = bigru_vjp.fwd_rows(plan, rows)
    assert bigru_vjp.fwd_clusters["gru"] == occ["clusters"]
    assert tile == bigru_vjp.simt_fwd_rows(plan, rows, occ["clusters"]) in (R, R + 8)
    _k4_fwd_matches_plain(*_case(rows, 256, 11, torch.float32)[:5], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,dtype", [(16, "float32"), (16, "bfloat16"), (32, "float32"),
                                          (64, "float32"), (128, "float32"),
                                          (256, "float32")])
def test_k4_simt_forward_at_every_width(hidden, dtype):
    """Every H the simt design takes (clusters of 1, 2, 4 and 8; bf16 at
    H = 16, which tc refuses) at its forward tile's rows + 3 (a ragged
    second tile), C = 28: the simt design, against the plain version,
    bit-equal on a rerun, in two CUDA launches."""
    _need_card()
    dt = getattr(torch, dtype)
    plan = bigru_vjp.k45_plan(hidden, dt)
    assert plan["design"] == "simt"
    assert (bigru_vjp.fwd_rec_occupancy(plan, dt)["rows"], plan["rows_fwd"]) == (
        bigru_vjp.simt_fwd_geometry(hidden)["R"],) * 2
    before = bigru_vjp.design_calls["simt"]
    _k4_fwd_matches_plain(*_case(plan["rows_fwd"] + 3, hidden, 28, dt)[:5], dt)
    assert bigru_vjp.design_calls["simt"] == before + 2


def _k5_matches_plain(x, wih, bih, whh, bhh, dout, dt):
    """K5 on the plain forward's residuals against its plain version, with its
    CUDA launches and a bit-equal rerun."""
    L, rows, cin = x.shape
    out, gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    before = bigru_vjp.launches_bwd
    bigru_vjp.cuda_launches = 0
    got = bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, out, gates, dt)
    # recurrence, dx, weight gradients (tc: dW_ih apart at C % 8 != 0), and
    # the sum of slices (simt: when S > 1) and of the tc bias partials
    assert bigru_vjp.cuda_launches == bigru_vjp.bwd_cuda_launches(
        bigru_vjp.k45_plan(whh.shape[1], dt), L * rows, cin,
        torch.cuda.get_device_properties(0).multi_processor_count)
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", SHAPES)
def test_k5_matches_plain_and_is_deterministic(dtype, rows, hidden, cin):
    _need_card()
    dt = getattr(torch, dtype)
    _k5_matches_plain(*_case(rows, hidden, cin, dt), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["R-1", "R+1", "part-filled last wave"])
def test_k5_simt_backward_at_the_tile_edges(edge):
    """The simt backward at H = 256 on row counts at its tile's edges (72
    rows): one row short of a tile, one row past it (a second tile of one
    row), and two tiles a direction past a full wave (half the clusters the
    card holds at once, cudaOccupancyMaxActiveClusters) and 5 rows: a
    part-filled last wave ending in a ragged tile. Against the plain
    version, bit-equal on a rerun, with its CUDA launches; the library's
    tile rows and shared memory are the planner's."""
    _need_card()
    plan = bigru_vjp.k45_plan(256, torch.float32)
    R = plan["rows_bwd"]
    occ = bigru_vjp.bwd_rec_occupancy(plan, torch.float32)
    assert (occ["rows"], occ["smem"]) == (R, plan["smem_bwd"])
    clusters = occ["clusters"]
    rows = {"R-1": R - 1, "R+1": R + 1,
            "part-filled last wave": R * (clusters // 2 + 2) + 5}[edge]
    _k5_matches_plain(*_case(rows, 256, 11, torch.float32), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,dtype", [(16, "float32"), (16, "bfloat16"), (32, "float32"),
                                          (64, "float32"), (128, "float32"),
                                          (256, "float32")])
def test_k5_simt_backward_at_every_width(hidden, dtype):
    """Every H the simt design takes (clusters of 1, 2, 4 and 8; bf16 at
    H = 16, which tc refuses) at its tile's rows + 3 (a ragged second tile),
    C = 28: the simt design, against the plain version, bit-equal on a
    rerun, with its CUDA launches."""
    _need_card()
    dt = getattr(torch, dtype)
    plan = bigru_vjp.k45_plan(hidden, dt)
    assert plan["design"] == "simt"
    before = bigru_vjp.design_calls["simt"]
    _k5_matches_plain(*_case(plan["rows_bwd"] + 3, hidden, 28, dt), dt)
    assert bigru_vjp.design_calls["simt"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", [(65, 32, 11), (1000, 256, 512),
                                             (1024, 256, 11)])
def test_each_phase_product_matches_matmul(dtype, rows, hidden, cin):
    """Each product of K4 and K5 alone, against torch.matmul in f32 on the
    same operands rounded to the operand type: the input projection, dx,
    dW_ih, dW_hh and the bias sums (of the unrounded gate gradients: simt's
    f32 dxg and dhg, tc's row-tile partials of them)."""
    _need_card()
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, dt)
    plan = bigru_vjp.k45_plan(hidden, dt)
    L, N, C, H, G = 21, rows, cin, hidden, 3 * hidden

    def op(t):
        return t.to(dt).float()

    xs = op(x).reshape(L * N, C)
    xg = bigru_vjp.k4_projection(x, wih, bih, bhh, plan, dt)
    for d in (0, 1):
        fold = bhh[d].clone()
        fold[2 * H:] = 0.0
        ref = xs @ op(wih[d]) + (bih[d] + fold)
        assert _err(xg[d], ref) <= _sum_tol(xs, op(wih[d])), ("xg", d)

    out, gates = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    dxg, dhg, part = bigru_vjp.k5_recurrence(dout, out, gates, whh, plan, dt)
    assert dxg.dtype == (torch.bfloat16 if plan["design"] == "tc" else torch.float32)
    dx = bigru_vjp.k5_dx(dxg, wih, plan, dt)
    a = torch.cat([op(dxg[0]), op(dxg[1])], dim=1)
    b = torch.cat([op(wih[0]).T, op(wih[1]).T], dim=0)
    assert _err(dx, a @ b) <= _sum_tol(a, b), "dx"

    dw_ih, db_ih, dw_hh, db_hh = bigru_vjp.k5_weight_grads(x, out, dxg, dhg, plan, dt, part)
    o = out.float().reshape(L, N, 2 * H)
    for d in (0, 1):
        h_prev = torch.zeros((L, N, H), device="cuda")
        if d == 0:
            h_prev[1:] = o[:-1, :, :H]
        else:
            h_prev[:-1] = o[1:, :, H:]
        h_prev = h_prev.reshape(L * N, H)
        assert _err(dw_ih[d], xs.T @ op(dxg[d])) <= _sum_tol(xs.T, op(dxg[d])), ("dw_ih", d)
        assert _err(dw_hh[d], h_prev.T @ op(dhg[d])) <= _sum_tol(h_prev.T, op(dhg[d])), \
            ("dw_hh", d)
        if part is None:
            ones = torch.ones((1, L * N), device="cuda")
            assert _err(db_ih[d], dxg[d].sum(0)) <= _sum_tol(ones, dxg[d]), ("db_ih", d)
            assert _err(db_hh[d], dhg[d].sum(0)) <= _sum_tol(ones, dhg[d]), ("db_hh", d)
        else:
            ones = torch.ones((1, part.shape[0]), device="cuda")
            for k, db in enumerate((db_ih, db_hh)):
                assert _err(db[d], part[:, k, d].sum(0)) <= _sum_tol(ones, part[:, k, d]), \
                    ("db", k, d)


def products_ref(x, out, dxg, dhg, wih):
    """dx, dW_ih and dW_hh in f32 (torch.matmul) on the operands as the tc
    products see them (x, out, W_ih and the gate gradients bf16; h_prev the
    output one step back in each direction's own time, zero at its first
    step), with the tolerance of each (``_sum_tol``)."""
    L, N, C = x.shape
    H = out.shape[2] // 2
    xs = x.float().reshape(L * N, C)
    o = out.float()
    a = torch.cat([dxg[0].float(), dxg[1].float()], dim=1)
    b = torch.cat([wih[0].float().T, wih[1].float().T], dim=0)
    ref = {"dx": (a @ b, _sum_tol(a, b)), "dw_ih": [], "dw_hh": []}
    for d in (0, 1):
        h_prev = torch.zeros((L, N, H), device=x.device)
        if d == 0:
            h_prev[1:] = o[:-1, :, :H]
        else:
            h_prev[:-1] = o[1:, :, H:]
        h_prev = h_prev.reshape(L * N, H)
        ref["dw_ih"].append((xs.T @ dxg[d].float(), _sum_tol(xs.T, dxg[d].float())))
        ref["dw_hh"].append((h_prev.T @ dhg[d].float(), _sum_tol(h_prev.T, dhg[d].float())))
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [11, 28, 512])
@pytest.mark.parametrize("rows,hidden", [(13, 32), (1000, 256), (1029, 256)])
def test_tc_products_match_matmul_and_count_by_kernel(rows, hidden, cin):
    """The tc design's products alone, on seeded bf16 gate gradients: dx,
    dW_ih and dW_hh on wgmma at every width (``gemm_calls``; X's rows by
    plain loads at C % 8 != 0, by TMA elsewhere); each against torch.matmul
    in f32 on the same bf16 operands, the bias gradients against the sum of
    the tile partials, and bit-equal on a rerun. Ragged rows: 13, 1000 and
    1029 are no multiple of the 128-row tiles or the 64-row k tiles."""
    _need_card()
    dt = torch.bfloat16
    x, wih, _, _, _, _ = _case(rows, hidden, cin, dt)
    plan = bigru_vjp.k45_plan(hidden, dt)
    assert plan["design"] == "tc"
    L, N, H, G = 21, rows, hidden, 3 * hidden
    rng = np.random.RandomState(rows + cin + hidden)

    def seeded(shape, dtype=dt):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to("cuda", dtype)

    dxg, dhg = seeded((2, L * N, G)), seeded((2, L * N, G))
    out = seeded((L, N, 2 * H))
    part = seeded((-(-N // plan["rows_bwd"]), 2, 2, G), torch.float32)
    calls = dict(bigru_vjp.gemm_calls)
    dx = bigru_vjp.k5_dx(dxg, wih, plan, dt)
    grads = bigru_vjp.k5_weight_grads(x, out, dxg, dhg, plan, dt, part)
    assert bigru_vjp.gemm_calls == {"wgmma": calls["wgmma"] + 3}
    dx2 = bigru_vjp.k5_dx(dxg, wih, plan, dt)
    grads2 = bigru_vjp.k5_weight_grads(x, out, dxg, dhg, plan, dt, part)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    ref = products_ref(x, out, dxg, dhg, wih)
    assert dx.shape == (L * N, cin) and _err(dx, ref["dx"][0]) <= ref["dx"][1], "dx"
    dw_ih, db_ih, dw_hh, db_hh = grads
    ones = torch.ones((1, part.shape[0]), device="cuda")
    for d in (0, 1):
        for name, got in (("dw_ih", dw_ih[d]), ("dw_hh", dw_hh[d])):
            want, tol = ref[name][d]
            assert _err(got, want) <= tol, (name, d, _err(got, want), tol)
        for k, db in enumerate((db_ih, db_hh)):
            assert _err(db[d], part[:, k, d].sum(0)) <= _sum_tol(ones, part[:, k, d]), \
                ("db", k, d)


@pytest.mark.cuda
def test_layer_fn_runs_the_kernels():
    _need_card()
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
    _need_card()
    x, wih, bih, whh, bhh, _ = _case(8, 16, 11, torch.float32)
    with pytest.raises(ValueError):  # operand type differs from compute type
        bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, torch.bfloat16)
    with pytest.raises(ValueError):  # not contiguous
        bigru_vjp.bigru_layer_train_fwd(x.transpose(0, 1).contiguous().transpose(0, 1),
                                        wih, bih, whh, bhh, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [20, 48])
def test_refused_shape_raises_before_any_launch(hidden, dtype):
    """H = 20 and 48: neither design takes them; K4 and K5 raise ValueError
    and launch nothing, and no plain version runs in their place."""
    _need_card()
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(16, hidden, 11, dt)
    out, gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    bigru_vjp.cuda_launches = 0
    plain = bigru_vjp.plain_calls
    with pytest.raises(ValueError, match="no design for H={}".format(hidden)):
        bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    with pytest.raises(ValueError, match="no design for H={}".format(hidden)):
        bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, out, gates, dt)
    assert bigru_vjp.cuda_launches == 0 and bigru_vjp.plain_calls == plain


# sha256 of K4's (out, gates) and, apart, of K5's five gradients on
# ``_case(rows, hidden, cin, dtype)``, taken on an H100. The forward parts,
# and the backward parts of the simt design (fp32, and bf16 at H = 16), are
# the kernels' bits from before K5's tc products moved to wgmma (taken on the
# parent tree); they pin K4 and the simt backward, which that move leaves as
# they were. The tc backward parts (bf16, H >= 32) were retaken on the wgmma
# products after they matched the plain version within the bf16 tolerances.
K45_DIGESTS = {
    (13, 16, 11, 'bfloat16'): ("b3fe1244f26d6a388116e1c5512d57ef0ea50bc672da415eeda829f36306b7f5",
                                "8e980db092aa7a183e246eec83bb7e7e1ad520d3895b58a16e559af4bb4fb6b3"),
    (13, 16, 11, 'float32'): ("08897ee9f403dd58ce2ecec61f2a0857c8adce74f7bb8960ad4c6cbe63a288f5",
                               "ca9d97368b5df4c9732e7864f6a4c50bf7d7cff5405f110fda55333da4aa5e75"),
    (65, 32, 11, 'bfloat16'): ("ee1f65d4d511666204e521d404ce11288cad648832c87d6ac98639998f108328",
                                "bf0c29b306a1fea2ef5d276131926e292f209360c2542930d7464bb9ec68d102"),
    (65, 32, 11, 'float32'): ("95630944f57f7360ad4c307032296cc17fdbcc224e7e1f8f902ce2cfbb969c7d",
                               "feb0bb04a4c661f0d548cf6ae99aee74fe4e50489b71a4ecf3150b07c38dbd1a"),
    (300, 64, 128, 'bfloat16'): ("d62eb4ac8ac9ce3d1003a74d19725dc08ab5676661a8d5d9dc6162f5c7de0129",
                                  "86402702b88bff310238f1226f7010bdd3881ba7c7aa5c12a49285edba0e7e18"),
    (300, 64, 128, 'float32'): ("35e05a0eb8340b6fbda8eb3d8553b6c3321e7d021a10cd15199f9d46e1d89dff",
                                 "b3432170d6b2a361f734d661fab13aa4bb45b3a20f717d2ad29195279a725a07"),
    (1000, 256, 512, 'bfloat16'): ("ef1067dc45fdf68e06269388c30cf00a826465e26ca6a3627c9b62e2abc38876",
                                    "63c21868bfbafe52ed8b531b0c217f2a874afdec1bfb0a7342a322402e712ab3"),
    (1000, 256, 512, 'float32'): ("43d0e41237b6a0bccda9944ed7aaa034c88bad40cbe0a1ed1754beddcea7fdef",
                                   "2fa9c11e2543966fec5d982e787ab4f753e5387246e55c509ac2a77020fa08ff"),
}


def k45_digests(rows, hidden, cin, dtype):
    """sha256 over the bytes of K4's outputs and, apart, over K5's on one
    case: (forward, backward)."""
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, dt)
    out, gates = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    grads = bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, out, gates, dt)
    parts = []
    for ts in ((out, gates), tuple(grads)):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
        parts.append(h.hexdigest())
    return tuple(parts)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K45_DIGESTS))
def test_k45_outputs_bit_equal_to_before_the_shared_header(case):
    _need_card()
    rows, hidden, cin, dtype = case
    assert k45_digests(rows, hidden, cin, dtype) == K45_DIGESTS[case]


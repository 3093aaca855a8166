"""K6's shape rule and its backward's staged layout, on the CPU (no card): the
planner ``k45_plan(H, dtype, "lstm")``, the one rule of K4/K5 and K6, for the
LSTM's four gates; a model of the K6 backward recurrence's W_hh staging, its
reduce-scatter of dh across the cluster (simt: through the operand images
and the owners' buffers of tests/test_torch_train_layouts.py's
``simt_bwd_step``) and its dc kept by one owner (csrc/rnn_train_rec.cuh
stages W_hh in shared memory itself), held to the kernel source and,
through a plain backward in that layout, to ``bilstm_layer_bwd_plain`` and
the JAX package's ``fused_bilstm_layer_tm`` (interpret mode); the
weight-gradient slices at G = 4H; and the launch counters, which a CPU call
leaves alone."""

import os

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp
from ccsmeth_tpu_torch.ops.kernel_args import SMEM_LIMIT
from tests.test_torch_train_layouts import (check_f32_products, check_wgmma_products, gf_dx_tn,
                                            gf_owners, simt_bwd_step, simt_fwd_layer,
                                            simt_fwd_maps, stage_fwd, sum_tol, tile_bias_sums,
                                            wgrad_residency)

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once


@pytest.mark.parametrize("hidden", [16, 32, 64, 256])
def test_lstm_plan_takes_fp32_on_simt(hidden):
    plan = bigru_vjp.k45_plan(hidden, torch.float32, "lstm")
    assert plan["design"] == "simt" and "fp32" in plan["why"]
    assert (plan["cell"], plan["gates"]) == ("lstm", 4)
    U, cn = plan["U"], plan["CN"]
    assert U == min(hidden, 32) and U * cn == hidden and cn in (1, 2, 4, 8)
    # a forward thread owns one unit's 4 gates of RT rows (R = NGR NQ RT rows
    # a tile), a backward thread the partial of RT rows x 8 units (R = NR RT
    # rows a tile); both tiles are the GRU's
    f = bigru_vjp.simt_fwd_geometry(hidden)
    assert plan["rows_fwd"] == f["R"] == f["NGR"] * f["NQ"] * f["RT"]
    assert f["NGR"] * f["NQ"] * U == 256
    assert plan["rows_fwd"] == bigru_vjp.k45_plan(hidden, torch.float32)["rows_fwd"]
    g = bigru_vjp.simt_bwd_geometry(hidden)
    assert plan["rows_bwd"] == g["R"] == g["NR"] * g["RT"]
    assert plan["rows_bwd"] == bigru_vjp.k45_plan(hidden, torch.float32)["rows_bwd"]
    assert max(plan["smem_fwd"], plan["smem_bwd"]) <= SMEM_LIMIT


@pytest.mark.parametrize("hidden,U,cn", [(32, 32, 1), (64, 64, 1), (128, 64, 2),
                                         (256, 64, 4)])
def test_lstm_plan_takes_bf16_on_tc(hidden, U, cn):
    plan = bigru_vjp.k45_plan(hidden, torch.bfloat16, "lstm")
    assert (plan["design"], plan["U"], plan["CN"]) == ("tc", U, cn)
    assert (plan["rows_fwd"], plan["rows_bwd"]) == (64, 32)
    assert plan["smem_fwd"] == (4 * U + 128) * (hidden + 8) * 2
    assert plan["smem_bwd"] == bigru_vjp.k5_smem("tc", hidden, U, 32, 4)
    assert max(plan["smem_fwd"], plan["smem_bwd"]) <= SMEM_LIMIT


def test_lstm_plan_at_the_model_width():
    """H = 256, the reckoning of csrc/bilstm_train.cu's header: tc CTAs of
    202,752 (forward) and 65,536 + 8,192 + 135,168 + 16,896 = 225,792
    (backward) bytes in clusters of 4; simt of 131,072 + 73,728 + 32 =
    204,832 (72-row forward tiles: the W_hh slice, h of the tile's rows,
    four barriers; a 64-row tile of the double-buffered [k][row] h would
    need 262,144) and 131,072 + 73,728
    + 21,120 + 32 = 225,952 (72-row backward tiles: the W_hh slice, the 8 x
    72 x 32 f32 partials received, the 40 x 132 operand of a row half, four
    barriers) in clusters of 8. The GRU's plan at the same width: 98,304 +
    73,728 + 32 = 172,064 and 188,064."""
    tc = bigru_vjp.k45_plan(256, torch.bfloat16, "lstm")
    simt = bigru_vjp.k45_plan(256, torch.float32, "lstm")
    assert (tc["U"], tc["CN"], tc["smem_fwd"], tc["smem_bwd"]) == (64, 4, 202752, 225792)
    assert tc["smem_bwd"] == 65536 + 8192 + 135168 + 16896 <= SMEM_LIMIT
    assert (simt["U"], simt["CN"], simt["smem_fwd"], simt["smem_bwd"]) == \
        (32, 8, 204832, 225952)
    assert simt["smem_fwd"] == 131072 + 256 * 72 * 4 + 32 <= SMEM_LIMIT
    assert simt["smem_bwd"] == 131072 + 8 * 72 * 32 * 4 + 40 * 132 * 4 + 32
    assert (simt["rows_fwd"], simt["rows_bwd"]) == (72, 72)
    assert (256 * 4 * 32 + 2 * 256 * 64) * 4 == 262144 > SMEM_LIMIT
    gru = bigru_vjp.k45_plan(256, torch.float32)
    assert (gru["rows_fwd"], gru["smem_fwd"], gru["smem_bwd"]) == (72, 172064, 188064)


def test_lstm_plan_cuts_the_simt_backward_tile_to_fit():
    """The simt backward's tile fits with four gates at every H it takes, so
    nothing is cut: at H = 16 and 32 (a cluster of one) the 128- and 64-row
    tiles take 47,136 and 58,400 bytes, where the old design's 8192 / H rows
    with double-buffered partials (235,520 and 246,784 bytes) had to halve.
    The GRU's tiles have the same rows."""
    for hidden, rows, smem in ((16, 128, 47136), (32, 64, 58400), (64, 64, 66080),
                               (128, 64, 115232), (256, 72, 225952)):
        plan = bigru_vjp.k45_plan(hidden, torch.float32, "lstm")
        assert (plan["rows_bwd"], plan["smem_bwd"]) == (rows, smem) and smem <= SMEM_LIMIT
        assert bigru_vjp.k45_plan(hidden, torch.float32)["rows_bwd"] == rows
    for hidden, U, old in ((16, 16, 235520), (32, 32, 246784)):
        R = 8192 // hidden
        cn, ug = hidden // U, 4 * U
        assert 2 * cn * R * U * 4 + R * U * 4 + ug * hidden * 4 + R * (ug + 1) * 4 == old
        assert old > SMEM_LIMIT


@pytest.mark.parametrize("hidden,dtype,reasons", [
    (20, torch.float32, ["simt: H must be 16 or a multiple of 32", "fp32"]),
    (48, torch.bfloat16, ["simt: H must be 16 or a multiple of 32", "tc: H % 32"]),
    (96, torch.bfloat16, ["simt: a cluster of 3 CTAs", "tc: a cluster of 3 CTAs"]),
    (512, torch.bfloat16, ["simt: a cluster of 16 CTAs", "tc: 426496 bytes"]),
])
def test_lstm_plan_names_why_it_refuses(hidden, dtype, reasons):
    with pytest.raises(ValueError) as err:
        bigru_vjp.k45_plan(hidden, dtype, "lstm")
    msg = str(err.value)
    assert msg.startswith("K6 takes no design for H={}".format(hidden))
    for r in reasons:
        assert r in msg, (r, msg)


def test_plan_refuses_an_unknown_cell():
    with pytest.raises(ValueError, match="cell must be gru or lstm"):
        bigru_vjp.k45_plan(64, torch.float32, "rnn_tanh")


def own_columns(H, U, c, ng=4):
    """The W_hh columns of CTA c in the backward recurrence, in staged order:
    k = gate*U + u holds column gate*H + c*U + u."""
    gate = torch.arange(ng).view(-1, 1)
    u = torch.arange(U).view(1, -1)
    return (gate * H + c * U + u).reshape(-1)


def stage(whh, U, design):
    """One direction's W_hh (H, 4H) -> each CTA's shared-memory image: simt
    [4U][H] (row k, unit j contiguous), tc [H][4U] (unit j, k contiguous;
    the kernel pads each row by 8)."""
    H = whh.shape[0]
    slices = [whh[:, own_columns(H, U, c)] for c in range(H // U)]
    return torch.stack([s.T if design == "simt" else s for s in slices])


@pytest.mark.parametrize("hidden,design", [(16, "simt"), (256, "simt"), (64, "tc"),
                                           (256, "tc")])
def test_k6_staging_holds_each_ctas_four_gates(hidden, design):
    U = bigru_vjp.k45_plan(hidden, torch.float32 if design == "simt" else torch.bfloat16,
                           "lstm")["U"]
    whh = torch.from_numpy(np.random.RandomState(hidden).randn(hidden, 4 * hidden)
                           .astype(np.float32))
    staged = stage(whh, U, design)
    cn = hidden // U
    assert staged.shape == ((cn, 4 * U, hidden) if design == "simt" else (cn, hidden, 4 * U))
    for c, gate, u, j in ((0, 0, 0, 0), (cn - 1, 3, U - 1, hidden - 1), (cn // 2, 2, 3, 5)):
        k = gate * U + u
        v = staged[c, k, j] if design == "simt" else staged[c, j, k]
        assert v == whh[j, gate * hidden + c * U + u]
    # every column of W_hh is staged once, by the CTA that owns its unit
    cols = torch.cat([own_columns(hidden, U, c) for c in range(cn)])
    assert torch.equal(cols.sort().values, torch.arange(4 * hidden))


def _k6_staged(dout, x, w_ih, w_hh, out, c, gates, compute_dtype, U, design):
    """K6's backward in plain PyTorch, in the kernel's layout: per step, the
    owner of each (row, unit) computes da from the residuals and its own dc
    (elementwise, never exchanged); each CTA c multiplies its own 4U columns
    of op(da) by its staged W_hh slice into a partial dh for all H units, and
    the owner of units [c'U, (c'+1)U) adds the CN partials in rank order. dx
    and the weight gradients as single products after the recurrence, the
    bias sum of da once."""
    L, N, C = x.shape
    H = w_hh.shape[1]
    cn = H // U

    def op(t):
        return t.to(compute_dtype).float()

    dx = torch.zeros((L * N, C))
    grads = []
    xs = x.float().reshape(L * N, C)
    for d in (0, 1):
        g = gates[d].float()
        ig, fg, gg, og = (g[..., k * H:(k + 1) * H] for k in range(4))
        cd = c[d].float()
        c_prev = torch.zeros_like(cd)
        o = out[..., d * H:(d + 1) * H].float()
        h_prev = torch.zeros_like(o)
        if d == 0:
            c_prev[1:], h_prev[1:] = cd[:-1], o[:-1]
        else:
            c_prev[:-1], h_prev[:-1] = cd[1:], o[1:]
        staged = op(stage(w_hh[d], U, design))
        da_all = torch.empty((L, N, 4 * H))
        dh = torch.zeros((N, H))
        dc = torch.zeros((N, H))
        for s in range(L):
            t = L - 1 - s if d == 0 else s
            tc = torch.tanh(cd[t])
            dt = dout[t, :, d * H:(d + 1) * H].float() + dh
            dcv = dt * og[t] * (1.0 - tc * tc) + dc
            da = torch.cat([dcv * gg[t] * ig[t] * (1.0 - ig[t]),
                            dcv * c_prev[t] * fg[t] * (1.0 - fg[t]),
                            dcv * ig[t] * (1.0 - gg[t] * gg[t]),
                            dt * tc * og[t] * (1.0 - og[t])], dim=1)
            dc = dcv * fg[t]
            da_all[t] = da
            dh = torch.zeros((N, H))
            if design == "simt":  # the operand images, buffers and owners' sums
                dh = simt_bwd_step(op(da), staged, dh, H)
                continue
            for r in range(cn):  # rank order
                a = op(da[:, own_columns(H, U, r)])
                dh = dh + a @ staged[r].T
        da_all = da_all.reshape(L * N, 4 * H)
        dx += op(da_all) @ op(w_ih[d]).T
        grads.append((xs.T @ op(da_all), da_all.sum(0),
                      h_prev.reshape(L * N, H).T @ op(da_all)))
    dw_ih, db, dw_hh = (torch.stack([gr[i] for gr in grads]) for i in range(3))
    return dx.reshape(L, N, C), dw_ih, db, dw_hh, db


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,U,design", [(16, 16, "simt"), (64, 32, "simt"),
                                             (64, 64, "tc"), (128, 64, "tc")])
def test_k6_staged_backward_equals_plain(hidden, U, design, dtype):
    """fp32 to 1e-5 (1e-5 of max|ref| for the sums over L*N rows); bf16 to
    1e-2 of max|ref|, where an f32 sum in another order rounds a gate
    gradient operand to the neighbouring bf16 value."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(hidden + U)
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, 11, hidden, 1, "lstm")[0], dt)
    x = torch.from_numpy(rng.randn(6, 5, 11).astype(np.float32)).to(dt)
    dout = torch.from_numpy(rng.randn(6, 5, 2 * hidden).astype(np.float32)).to(dt)
    out, c, gates = bilstm_vjp.bilstm_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    got = _k6_staged(dout, x, wih, whh, out, c, gates, dt, U, design)
    ref = bilstm_vjp.bilstm_layer_bwd_plain(dout, x, wih, whh, out, c, gates, dt)
    for name, a, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), got, ref):
        scale = max(1.0, r.abs().max().item())
        tol = (1e-5 if dt == torch.float32 else 1e-2) * scale
        assert a.shape == r.shape and (a - r).abs().max().item() <= tol, name


def test_k6_staging_model_follows_the_kernel_source():
    """The model above is the kernel's: W_hh row j, column gate*H + u0 + u
    goes to shared row k = gate*U + u (simt, [k][j]) or to row j, column k
    (tc, [j][k]) over the NG U = 4U columns of a CTA, u0 = rank * U; dh is the
    sum of the partials of ranks 0 .. CN-1 in order, with no carry term for
    the LSTM; dc stays with the thread that owns the (row, unit) (simt: in
    its registers, the product dc f rounded once; tc: in the dh slot) and
    is read back there at the next step."""
    path = os.path.join(os.path.dirname(bigru_vjp.__file__), "csrc", "rnn_train_rec.cuh")
    with open(path) as f:
        src = " ".join(f.read().split())
    for line in ("constexpr int NG = LSTM ? 4 : 3;",
                 "const int H = p.H, G = NG * H, L = p.L, N = p.N, U = p.U, R = p.R, "
                 "UG = NG * U;",
                 "const int j = i % H, k4 = (i / H) * 4;",
                 "const int gate = k4 / U, u = k4 % U;",
                 "for (int e = 0; e < 4; ++e) ws[(k4 + e) * H + j] = v[e];",
                 "const int j = i / (UG / 8), k8 = (i % (UG / 8)) * 8;",
                 "if constexpr (!LSTM) dh = dh_s[q];",
                 "for (uint32_t c = 0; c < cn; ++c) dh += rcv[(size_t)c * R * U + q];",
                 "const float dc = dt * og * (1.0f - tc * tc) + (s > 0 ? dh_s[q] : 0.0f);",
                 "dh_s[q] = dc * fg;",
                 "for (int c = 0; c < CN; ++c) dh += f4_at(part[c], e);",
                 "const float dc = dt * og * (1.0f - tc * tc) + carry[h][j][e];",
                 "carry[h][j][e] = __fmul_rn(dc, fg);",
                 "const int u0 = crank * U;"):
        assert line in src, line
    # the K6 entries run the LSTM's instantiations of those templates
    with open(os.path.join(os.path.dirname(path), bilstm_vjp.SRC)) as f:
        k6 = " ".join(f.read().split())
    assert "fwd_rec_run<true>(" in k6 and "bwd_rec_run<true>(" in k6


@pytest.mark.parametrize("hidden", [16, 64])
def test_k6_simt_staged_backward_equals_the_jax_layer(hidden):
    """The simt model (``_k6_staged``) against the JAX package's
    ``fused_bilstm_layer_tm`` (through ``birnn_apply_pallas_trainable``,
    cell 'lstm', one layer, b_tile 8, interpret mode) on the same numpy
    weights, inputs and cotangent: tests/test_torch_bilstm_vjp.py's gate,
    atol 2e-4 / rtol 1e-3 (f32 sums in other orders)."""
    import jax
    import jax.numpy as jnp

    from ccsmeth_tpu.ops.bigru_pallas_vjp import birnn_apply_pallas_trainable

    rng = np.random.RandomState(hidden + 9)
    layers = init_rnn_params(rng, 11, hidden, 1, "lstm")
    x = rng.randn(5, 6, 11).astype(np.float32)  # (N, L, C)
    cot = rng.randn(5, 6, 2 * hidden).astype(np.float32)

    def loss(x_, ls):
        out, _ = birnn_apply_pallas_trainable(ls, x_, b_tile=8, interpret=True, cell="lstm")
        return jnp.sum(out * cot)

    gx, gl = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), layers)
    wih, bih, whh, bhh = layer_weights(layers[0])
    xt = torch.from_numpy(x).transpose(0, 1).contiguous()
    dout = torch.from_numpy(cot).transpose(0, 1).contiguous()
    out, c, gates = bilstm_vjp.bilstm_layer_train_fwd_plain(xt, wih, bih, whh, bhh)
    dx, dw_ih, db_ih, dw_hh, db_hh = _k6_staged(dout, xt, wih, whh, out, c, gates,
                                                torch.float32, min(hidden, 32), "simt")
    np.testing.assert_allclose(dx.transpose(0, 1).numpy(), np.asarray(gx), atol=2e-4, rtol=1e-3)
    for d, name in enumerate(("fwd", "bwd")):
        want = gl[0][name]
        for got, key, tr in ((dw_ih[d], "w_ih", True), (dw_hh[d], "w_hh", True),
                             (db_ih[d], "b_ih", False), (db_hh[d], "b_hh", False)):
            np.testing.assert_allclose((got.T if tr else got).numpy(), np.asarray(want[key]),
                                       atol=2e-4, rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("cin,kernel,slices", [
    (512, "gemm_simt_kernel", 11), (11, "gemm_simt_kernel", 11),
    (512, "wgemm_kernel", 11), (11, "wgemm_kernel", 11),
    (512, "f32_tma_kernel", 11), (11, "f32_tma_kernel", 11)])
def test_k6_wgrad_slices_at_four_gates(cin, kernel, slices):
    """1024 rows, H = 256, 132 SMs, G = 4H = 1024 columns: 2 x 8 x (C/128 + 2)
    tiles of 128 x 128 (96 at C = 512, 48 at C = 11); the slices that fill
    whole waves of blocks (2 an SM for either design's kernel, simt
    f32_tma_kernel on f32 and gemm_simt_kernel on bf16, tc wgemm_kernel), the fewest on a tie: 11 x 96
    tiles = 4 waves of 264 blocks."""
    assert wgrad_residency(kernel) == 2
    S = bigru_vjp.k5_wgrad_slices(21 * 1024, cin, 256, 132, 4)
    tiles = 2 * 8 * (-(-cin // 128) + 2)
    slots = 2 * 132
    assert S == slices and (S * tiles) % slots == 0
    assert bigru_vjp.k5_wgrad_slices(21 * 13, 11, 16, 132, 4) == 1


@pytest.mark.parametrize("C,H", [(11, 256), (21, 32), (28, 256), (52, 128), (512, 256)])
def test_f32_lstm_products_own_every_element_once(C, H):
    """K6's products at four gates, G = 4H columns: dx (L N, C) with its
    column tile by C, and the weight-gradient jobs dW_ih (C, G) and dW_hh
    (H, G); every element one owner (f32_tma_kernel's thread map)."""
    assert (gf_owners(21 * 13, C, True, True, gf_dx_tn(C)) == 1).all()
    for M in (C, H):
        assert (gf_owners(M, 4 * H, False, False, 16) == 1).all()


@pytest.mark.parametrize("L,N,C,H,S", [(5, 7, 11, 16, 3), (4, 13, 21, 32, 2), (3, 40, 28, 16, 4)])
def test_f32_lstm_products_sum_as_the_simt_gemm(L, N, C, H, S):
    """K6's products on its one gate gradient da (passed as both dxg and
    dhg): one column sum a slice, no db_hh slot; the new kernel's chains and
    residue partials equal gemm_simt_kernel's bit for bit, at slice edges
    (an empty last slice), h_prev's shifted rows and layer-0 widths."""
    check_f32_products(L, N, C, H, S, 4, L * N + C + 1)


def _counts():
    return (bilstm_vjp.launches_fwd, bilstm_vjp.launches_bwd, bilstm_vjp.cuda_launches,
            dict(bilstm_vjp.design_calls), bigru_vjp.cuda_launches,
            dict(bigru_vjp.design_calls))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_k6_launches_nothing(dtype):
    """On CPU tensors K6 runs its plain versions: two plain calls and no
    kernel call, design or CUDA launch, of K6 or of K4/K5."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(9)
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, 11, 16, 1, "lstm")[0], dt)
    x = torch.from_numpy(rng.randn(4, 3, 11).astype(np.float32)).to(dt)
    dout = torch.from_numpy(rng.randn(4, 3, 32).astype(np.float32)).to(dt)
    before, plain = _counts(), bilstm_vjp.plain_calls
    out, c, gates = bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    grads = bilstm_vjp.bilstm_layer_bwd(dout, x, wih, whh, out, c, gates, dt)
    assert _counts() == before and bilstm_vjp.plain_calls == plain + 2
    assert len(grads) == 5 and all(bool(torch.isfinite(g).all()) for g in grads)


def lstm_gate_grads(dout, x, w_hh, out, c, gates, compute_dtype):
    """The f32 gate gradient da (2, L N, 4H) of ``bilstm_layer_bwd_plain``'s
    loop, in its order: what the tc recurrence rounds to bf16 for the
    products (both operands of the LSTM's) and sums unrounded for the
    bias."""
    from ccsmeth_tpu_torch.ops.kernel_args import op

    L, N, _ = x.shape
    H = w_hh.shape[1]
    da_all = torch.empty((2, L, N, 4 * H))
    for d in (0, 1):
        g = gates[d].float()
        ig, fg, gg, og = (g[..., k * H:(k + 1) * H] for k in range(4))
        cd = c[d].float()
        c_prev = torch.zeros_like(cd)
        if d == 0:
            c_prev[1:] = cd[:-1]
        else:
            c_prev[:-1] = cd[1:]
        w_hhT = op(w_hh[d], compute_dtype).T
        dh = torch.zeros((N, H))
        dc = torch.zeros((N, H))
        for s in range(L):
            t = L - 1 - s if d == 0 else s
            tc = torch.tanh(cd[t])
            dt = dout[t, :, d * H:(d + 1) * H].float() + dh
            dc = dt * og[t] * (1.0 - tc * tc) + dc
            da = torch.cat([dc * gg[t] * ig[t] * (1.0 - ig[t]),
                            dc * c_prev[t] * fg[t] * (1.0 - fg[t]),
                            dc * ig[t] * (1.0 - gg[t] * gg[t]),
                            dt * tc * og[t] * (1.0 - og[t])], dim=1)
            dc = dc * fg[t]
            dh = op(da, compute_dtype) @ w_hhT
            da_all[d, t] = da
    return da_all.reshape(2, L * N, 4 * H)


@pytest.mark.parametrize("cin", [11, 28, 512])
@pytest.mark.parametrize("hidden", [32, 256])
def test_k6_wgmma_operand_images_give_the_plain_gradients(hidden, cin):
    """K6's tc products from the images TMA writes of the bf16 da (both
    operands), W_ih, X and the shifted h_prev, read as wgmma's descriptors
    address them, tile by tile as wgemm_kernel runs them (two row slices, a
    ragged last k tile), against ``bilstm_layer_bwd_plain`` at bf16; the bias
    gradient (db_ih = db_hh) from the recurrence's row-tile partials."""
    dt = torch.bfloat16
    L, N = 4, 40
    rng = np.random.RandomState(hidden + cin)
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, cin, hidden, 1, "lstm")[0], dt)
    x = torch.from_numpy(rng.randn(L, N, cin).astype(np.float32)).to(dt)
    dout = torch.from_numpy(rng.randn(L, N, 2 * hidden).astype(np.float32)).to(dt)
    out, c, gates = bilstm_vjp.bilstm_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    ref = bilstm_vjp.bilstm_layer_bwd_plain(dout, x, wih, whh, out, c, gates, dt)
    da = lstm_gate_grads(dout, x, whh, out, c, gates, dt)
    da16 = da.to(dt).float()
    check_wgmma_products(x, out, wih, da16, da16, ref)
    got = tile_bias_sums(da, N)
    ones = torch.ones(1, L * N)
    for d in (0, 1):
        assert (got[d] - ref[2][d]).abs().max().item() <= sum_tol(ones, da[d]), ("db", d)


# ---- K6's simt forward: the GRU's recurrence (tests/test_torch_train_layouts.py's
# model of csrc/rnn_train_rec.cuh::fwd_rec_simt_kernel) with four gates

@pytest.mark.parametrize("hidden", [16, 256])
def test_k6_fwd_staging_holds_each_units_four_gates(hidden):
    """The simt forward's W_hh image of each CTA, [c][k][gate][u], holds the
    i, f, g, o columns of its units, the GRU's image its r, z, n; the LSTM's
    tile and map are the GRU's, its shared memory the GRU's and one more
    gate's slice (H x U f32)."""
    whh = torch.from_numpy(np.random.RandomState(hidden).randn(hidden, 4 * hidden)
                           .astype(np.float32))
    plan = bigru_vjp.k45_plan(hidden, torch.float32, "lstm")
    U = plan["U"]
    img = stage_fwd(whh, U, 4)
    assert img.shape == (hidden // U, hidden, 4, U)
    for c in range(hidden // U):
        for gate in range(4):
            assert torch.equal(img[c, :, gate], whh[:, gate * hidden + c * U:
                                                     gate * hidden + (c + 1) * U])
    gwhh = whh[:, :3 * hidden].contiguous()
    assert torch.equal(stage_fwd(gwhh, U, 3), img[:, :, :3])
    gplan = bigru_vjp.k45_plan(hidden, torch.float32)
    assert plan["rows_fwd"] == gplan["rows_fwd"] == simt_fwd_maps(hidden)["R"]
    assert plan["smem_fwd"] == gplan["smem_fwd"] + hidden * U * 4


@pytest.mark.parametrize("hidden,rows,dtype", [(16, 131, "float32"), (16, 131, "bfloat16"),
                                               (64, 70, "float32"), (256, 75, "float32")])
def test_k6_simt_fwd_model_equals_plain(hidden, rows, dtype):
    """The forward in the kernel's layout (``simt_fwd_layer`` with four
    gates) against ``bilstm_layer_train_fwd_plain`` at a ragged last tile:
    out, c and the gates to 1e-5 in fp32 (the same products summed in
    another order) and 1e-2 in bf16 (one bf16 ulp where an f32 sum in
    another order rounds the other way), times max|ref| where that exceeds
    1, as the cell state may."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(hidden + rows)
    wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, 11, hidden, 1, "lstm")[0], dt)
    x = torch.from_numpy(rng.randn(3, rows, 11).astype(np.float32)).to(dt)
    got = simt_fwd_layer(x, wih, bih, whh, bhh, dt, "lstm")
    ref = bilstm_vjp.bilstm_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    for name, a, r in zip(("out", "c", "gates"), got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        tol = (1e-5 if dt == torch.float32 else 1e-2) * max(1.0, r.float().abs().max().item())
        assert (a.float() - r.float()).abs().max().item() <= tol, name


@pytest.mark.parametrize("hidden", [16, 64])
def test_k6_simt_fwd_model_equals_the_jax_layer(hidden):
    """The model against the JAX package's ``fused_bilstm_layer_tm`` forward
    (``birnn_apply_pallas_trainable(cell="lstm")``, one layer, b_tile 8,
    interpret mode) on the same numpy weights and inputs:
    tests/test_torch_bilstm_vjp.py's forward gate, atol 3e-5 / rtol 1e-5."""
    import jax.numpy as jnp

    from ccsmeth_tpu.ops.bigru_pallas_vjp import birnn_apply_pallas_trainable

    rng = np.random.RandomState(hidden + 13)
    layers = init_rnn_params(rng, 11, hidden, 1, "lstm")
    x = rng.randn(5, 6, 11).astype(np.float32)  # (N, L, C)
    out_j, _ = birnn_apply_pallas_trainable(layers, jnp.asarray(x), b_tile=8, interpret=True,
                                            cell="lstm")
    wih, bih, whh, bhh = layer_weights(layers[0])
    out, _c, _gates = simt_fwd_layer(torch.from_numpy(x).transpose(0, 1).contiguous(), wih,
                                     bih, whh, bhh, cell="lstm")
    np.testing.assert_allclose(out.transpose(0, 1).numpy(), np.asarray(out_j),
                               atol=3e-5, rtol=1e-5)

"""Layouts and shape rules of the bf16 tensor-core kernels, on the CPU: a
model of K1's gate-interleaved W_hh staging (csrc/birnn_tc.cu stages it in
shared memory itself), held to the kernel source and, through a plain
recurrence in that layout, to models/rnn.py; the planners that pick each
kernel's design; and the launch counters, which a CPU call leaves alone."""

import os
import re

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import (birnn_tm, gru_cell, init_rnn_params, layer_weights,
                                          lstm_cell, n_gates)
from ccsmeth_tpu_torch.ops import bigru, bigru_vjp, transenc
from ccsmeth_tpu_torch.ops.kernel_args import SMEM_LIMIT

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

HIDDEN = (16, 64, 256)


def staged_columns(H, U, cell):
    """(CN, NG*U): the W_hh column that each shared-memory row of
    ``rnn_rec_kernel`` holds. Row (ub*NG + gate)*8 + i of CTA c holds column
    gate*H + c*U + 8*ub + i, so an mma tile of 8 rows is one gate of 8 units
    and a thread's accumulators hold every gate of its units."""
    ng = n_gates(cell)
    c = torch.arange(H // U).view(-1, 1, 1, 1)
    ub = torch.arange(U // 8).view(1, -1, 1, 1)
    gate = torch.arange(ng).view(1, 1, -1, 1)
    i = torch.arange(8).view(1, 1, 1, -1)
    return (gate * H + c * U + ub * 8 + i).reshape(H // U, ng * U)


def stage_whh(whh, U, cell):
    """One direction's W_hh (H, G) -> (CN, NG*U, H), the shared-memory image
    of each CTA of a recurrence cluster (k contiguous)."""
    return whh.T[staged_columns(whh.shape[0], U, cell)]


def unstage_whh(staged, cell):
    """The inverse of ``stage_whh``: (CN, NG*U, H) -> W_hh (H, G)."""
    cn, _nc, H = staged.shape
    cols = staged_columns(H, H // cn, cell).reshape(-1)
    w = staged.new_empty((n_gates(cell) * H, H))
    w[cols] = staged.reshape(-1, H)
    return w.T.contiguous()


def _birnn_tm_staged(layers, x, compute_dtype, cell, U):
    """K1-tc's arithmetic in plain PyTorch, in the kernel's layouts: the input
    projection once per layer with b_ih and the b_hh parts outside the reset
    product folded in; then per step and CTA c of the cluster, h (bf16) times
    c's staged W_hh slice, whose column j is gate (j // 8) % NG of unit
    c*U + 8*(j // (8*NG)) + j % 8."""
    L, N, _ = x.shape
    H = layers[0][2].shape[1]
    ng = n_gates(cell)
    cn = H // U

    def op(t):
        return t.to(compute_dtype).float()

    inp, h_ns = x, []
    for wih, bih, whh, bhh in layers:
        flat = op(inp).reshape(L * N, -1)
        outs = []
        for d in (0, 1):
            fold = bhh[d].clone()
            if cell == "gru":
                fold[2 * H:] = 0.0
            xg = (flat @ op(wih[d]) + (bih[d] + fold)).reshape(L, N, ng, H)
            staged = op(stage_whh(whh[d], U, cell))  # (CN, NG*U, H)
            bhn = bhh[d][2 * H:]
            h = torch.zeros((N, H))
            c = torch.zeros((N, H))
            ys = [None] * L
            for s in range(L):
                t = s if d == 0 else L - 1 - s
                acc = torch.einsum("nk,cjk->ncj", op(h), staged)
                # (n, c, ub, gate, i) -> (n, gate, unit = c*U + 8*ub + i)
                acc = acc.reshape(N, cn, U // 8, ng, 8).permute(0, 3, 1, 2, 4)
                acc = acc.reshape(N, ng, H)
                xt = xg[t]
                if cell == "gru":
                    r = torch.sigmoid(xt[:, 0] + acc[:, 0])
                    z = torch.sigmoid(xt[:, 1] + acc[:, 1])
                    n = torch.tanh(xt[:, 2] + r * (acc[:, 2] + bhn))
                    h = (1.0 - z) * n + z * h
                else:
                    pre = xt + acc
                    c = torch.sigmoid(pre[:, 1]) * c + torch.sigmoid(pre[:, 0]) * torch.tanh(pre[:, 2])
                    h = torch.sigmoid(pre[:, 3]) * torch.tanh(c)
                ys[t] = h
            h_ns.append(h)
            outs.append(torch.stack(ys))
        inp = torch.cat(outs, dim=-1).to(compute_dtype)
    return inp, torch.stack(h_ns)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", HIDDEN)
def test_whh_staging_round_trip(hidden, cell):
    plan = bigru.k1_plan(hidden, cell)
    U, cn, ng = plan["U"], plan["CN"], n_gates(cell)
    whh = torch.from_numpy(np.random.RandomState(hidden).randn(hidden, ng * hidden)
                           .astype(np.float32))
    staged = stage_whh(whh, U, cell)
    assert staged.shape == (cn, ng * U, hidden)
    # the row that the kernel's mma tile (ub, gate) reads at lane row i
    for c, ub, gate, i in ((0, 0, 0, 0), (cn - 1, U // 8 - 1, ng - 1, 7), (cn // 2, 1, 1, 3)):
        row = staged[c, (ub * ng + gate) * 8 + i]
        assert torch.equal(row, whh[:, gate * hidden + c * U + 8 * ub + i])
    assert torch.equal(unstage_whh(staged, cell), whh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", HIDDEN)
def test_staged_recurrence_equals_birnn_tm(hidden, cell, dtype):
    """fp32 to 1e-5 (sums in another order); bf16 to 1e-2, one bf16 ulp on
    [0.5, 1) plus margin, where an f32 sum in another order rounds an
    activation the other way."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(hidden + len(cell))
    layers = [layer_weights(ld, dt) for ld in init_rnn_params(rng, 11, hidden, 2, cell)]
    x = torch.from_numpy(rng.randn(21, 5, 11).astype(np.float32)).to(dt)
    U = bigru.k1_plan(hidden, cell)["U"]
    out, hn = _birnn_tm_staged(layers, x, dt, cell, U)
    ref_out, ref_hn = birnn_tm(layers, x, None, dt, cell)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert out.dtype == ref_out.dtype and hn.shape == ref_hn.shape
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (hn - ref_hn).abs().max().item() <= tol


def test_staging_model_follows_the_kernel_source():
    """The model above is the kernel's staging loop: W_hh row k, column
    gate*H + u0 + 8*ub + j goes to shared row (ub*NG + gate)*8 + j, column k."""
    path = os.path.join(os.path.dirname(bigru.__file__), "csrc", bigru.TC_SRC)
    with open(path) as f:
        src = " ".join(f.read().split())
    for line in ("const int k = i % H, ub = (i / H) % UB, gate = i / (H * UB);",
                 "W + (size_t)k * G + gate * H + u0 + ub * 8));",
                 "bf16* dst = ws + (ub * NG + gate) * 8 * HP + k;",
                 "for (int j = 0; j < 8; ++j) dst[j * HP] = e[j];",
                 "const int u0 = crank * U;"):
        assert line in src, line


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", HIDDEN)
def test_k1_plan_takes_the_model_shapes(hidden, cell):
    """The rule reads H, the cell and the dtype; any row count takes the
    design it picks (the recurrence grid covers ceil(N / 64) row tiles)."""
    plan = bigru.k1_plan(hidden, cell)
    assert plan["design"] == "tc", plan
    U, cn = plan["U"], plan["CN"]
    assert U in (16, 32, 64) and U * cn == hidden and cn in (1, 2, 4, 8)
    assert plan["smem"] == (n_gates(cell) * U + 2 * bigru.TC_ROWS) * (hidden + 8) * 2
    assert plan["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("hidden,cell,U,cn", [(32, "gru", 32, 1), (128, "lstm", 64, 2),
                                             (128, "gru", 64, 2), (48, "lstm", 16, 3)])
def test_k1_plan_splits_the_units(hidden, cell, U, cn):
    """U is the largest of 64, 32, 16 that divides H; CN = H / U CTAs a
    cluster, which must be 1, 2, 4 or 8. H = 48 is refused by the simt
    design too (U = 32 does not divide it), so it takes l2."""
    plan = bigru.k1_plan(hidden, cell)
    if cn in (1, 2, 4, 8):
        assert (plan["design"], plan["U"], plan["CN"]) == ("tc", U, cn)
    else:
        assert plan["design"] == "l2" and plan["why"] == "a cluster of {} CTAs".format(cn)


@pytest.mark.parametrize("hidden,layers,cell,dtype,why", [
    (256, 3, "gru", torch.float32, "fp32"),
    (16, 3, "lstm", torch.float32, "fp32"),
    (20, 3, "gru", torch.bfloat16, "H % 16"),
    (48, 3, "gru", torch.bfloat16, "cluster of 3"),
    (512, 3, "lstm", torch.bfloat16, "shared memory"),
    (80, 9, "gru", torch.bfloat16, "cluster of 5"),
])
def test_k1_plan_sends_other_shapes_to_the_f32_kernel(hidden, layers, cell, dtype, why):
    """fp32 takes the simt design; the bf16 shapes here are refused by tc and
    by simt (H = 20, 48, 80: neither 16 nor a multiple of 32; 512: a cluster
    of 16) and take l2. ``layers``: l2 takes up to 8; the rule does not read
    it."""
    plan = bigru.k1_plan(hidden, cell, dtype)
    want = "simt" if dtype == torch.float32 else "l2"
    assert plan["design"] == want and why in plan["why"]
    if want == "l2":
        assert plan["why_not_simt"].startswith("simt: ")


def _simt_source():
    path = os.path.join(os.path.dirname(bigru.__file__), "csrc", bigru.SIMT_SRC)
    with open(path) as f:
        return " ".join(f.read().split())


def simt_geometries(src):
    """{cell: [(U, R, NB), ...]}: the f32 recurrence's instantiations in
    csrc/birnn_simt.cu (its GRU_GEOMETRIES and LSTM_GEOMETRIES lists)."""
    found = {"gru": [], "lstm": []}
    for lstm, *geo in re.findall(r"X\((false|true), (\d+), (\d+), (\d+)\)", src):
        found["lstm" if lstm == "true" else "gru"].append(tuple(int(v) for v in geo))
    return found


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [16, 32, 64, 128, 256])
def test_k1_plan_simt_geometry_follows_the_kernel_source(hidden, cell):
    """fp32 K1 and K2 run csrc/birnn_simt.cu's own recurrence: the rule's
    geometry is one that the source instantiates for the cell (at H = 256
    the first of its list), with the source's thread count, shared-memory
    formula and layout constraints, within the 227 KB and on clusters of
    1, 2, 4 or 8 CTAs."""
    src = _simt_source()
    plan = bigru.k1_plan(hidden, cell, torch.float32)
    U, R, NB = plan["U"], plan["rows"], plan["NB"]
    geos = simt_geometries(src)[cell]
    assert plan["design"] == "simt" and (U, R, NB) in geos
    if hidden == 256:
        assert (U, R, NB) == geos[0] == bigru.SIMT_GEOMETRY[cell]
    else:
        assert U == min(hidden, 32)
    assert U * plan["CN"] == hidden and plan["CN"] in (1, 2, 4, 8)
    assert "if (cn != 1 && cn != 2 && cn != 4 && cn != 8) return nullptr;" in src
    assert "__launch_bounds__((R / 4) * (U / 2), 1) birnn_rec_kernel" in src
    assert plan["threads"] == (R // 4) * (U // 2) <= 1024
    assert plan["threads"] % 128 == 0  # whole warps on each of the 4 schedulers
    assert "static_assert(UG % 8 == 0 && R % 16 == 0 && (NB == 1 || NB == 2)" in src
    assert (U // 2) % 8 == 0 and R % 16 == 0 and NB in (1, 2)
    assert "return ((size_t)H * ng * U + (size_t)NB * H * R) * 4 + 32;" in src
    assert plan["smem"] == (hidden * n_gates(cell) * U + NB * hidden * R) * 4 + 32
    assert plan["smem"] <= SMEM_LIMIT
    assert "(N + R - 1) / R" in src  # clusters a direction


def simt_ownership(plan, cn):
    """The kernel's thread -> work map (birnn_rec_kernel's index arithmetic):
    for CTA rank c and thread t, the tile rows 4 rg + i (i < 4) and the
    units u0 + 2 ug + e (e < 2) it owns, as arrays (CN, THREADS, 4) and
    (CN, THREADS, 2)."""
    U = plan["U"]
    uw = U // 2 // 8
    tid = np.arange(plan["threads"])
    warp, lane = tid >> 5, tid & 31
    ug = (warp % uw) * 8 + (lane & 7)
    rg = (warp // uw) * 4 + (lane >> 3)
    rows = np.broadcast_to(rg[None, :, None] * 4 + np.arange(4), (cn, len(tid), 4))
    units = (np.arange(cn)[:, None, None] * U + (2 * ug)[None, :, None]
             + np.arange(2)[None, None, :])
    return rows, units


def test_simt_ownership_model_follows_the_kernel_source():
    """The model above is the kernel's: the thread's unit and row groups;
    W_hh staged as [k][gate][u]; for k ascending from 0, h of its 4 rows and
    W of its 2 units of each gate; and the exchange: unit e of its 4 rows
    into its own buffer, the CTA's block [u0, u0 + U) x R copied whole to
    the same place in every other CTA."""
    src = _simt_source()
    for line in ("const int ug = (warp % UW) * 8 + (lane & 7);",
                 "const int rg = (warp / UW) * 4 + (lane >> 3);",
                 "const int u0 = crank * U;",
                 "const int unit = u0 + 2 * ug;",
                 "const int row0 = (blockIdx.x / cn) * R;",
                 "const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;",
                 "const int row = row0 + rg * 4 + i;",
                 "*reinterpret_cast<float4*>(ws + k * NG * U + gate * U + u4 * 4) = "
                 "__ldg(reinterpret_cast<const float4*>(W + (size_t)k * G + gate * H + u0 + u4 * 4));",
                 "for (int k = 0; k < H; ++k) {",
                 "const float4 hv = *reinterpret_cast<const float4*>(hc + k * R + rg * 4);",
                 "const float* wk = ws + k * NG * U + 2 * ug;",
                 "const float2 w = *reinterpret_cast<const float2*>(wk + gate * U);",
                 "acc[i][gate][0] = fmaf(h[i], w.x, acc[i][gate][0]); "
                 "acc[i][gate][1] = fmaf(h[i], w.y, acc[i][gate][1]);",
                 "*reinterpret_cast<float4*>(hx + (size_t)(unit + e) * R + rg * 4) = "
                 "make_float4(hnew[0][e], hnew[1][e], hnew[2][e], hnew[3][e]);",
                 "const uint32_t src = smem_u32(hx + (size_t)u0 * R);",
                 "const uint32_t block_bytes = U * R * 4;",
                 "for (uint32_t r = 1; r < cn; ++r) bulk_to_peer(src, block_bytes, bar, "
                 "(crank + r) % cn);"):
        assert line in src, line


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [16, 32, 64, 128, 256])
def test_simt_ownership_covers_every_output_once(hidden, cell):
    """Across a cluster, the (row, unit) pairs that the threads own, each
    with every gate, cover the tile's R rows by H units once; the units a
    CTA owns are its own [c U, (c+1) U), whose h is the one contiguous block
    [c U R, (c+1) U R) of its buffer that the CTA copies out; and together
    the blocks fill every (unit, row) of each CTA's buffer once."""
    plan = bigru.k1_plan(hidden, cell, torch.float32)
    cn, U, R = plan["CN"], plan["U"], plan["rows"]
    rows, units = simt_ownership(plan, cn)
    count = np.zeros((R, hidden), dtype=np.int64)
    r_idx = np.broadcast_to(rows[:, :, :, None], rows.shape + (2,))
    u_idx = np.broadcast_to(units[:, :, None, :], r_idx.shape)
    np.add.at(count, (r_idx.ravel(), u_idx.ravel()), 1)
    assert (count == 1).all()
    offsets = u_idx * R + r_idx  # unit u of row r at offset u R + r of the buffer
    for c in range(cn):
        assert units[c].min() == c * U and units[c].max() == (c + 1) * U - 1
        assert sorted(offsets[c].ravel().tolist()) == list(range(c * U * R, (c + 1) * U * R))
    assert sorted(offsets.ravel().tolist()) == list(range(hidden * R))


def simt_model(layers, x, cell, plan):
    """K1's fp32 simt design on the CPU, structured as the kernel: per layer
    and direction, tiles of R rows; each CTA of the cluster keeps the tile's
    h in its own buffer [k][row], filled by the exchange; a step's gate sums
    of the tile come from that buffer, and each thread takes the (rows,
    units, gates) it owns (``simt_ownership``), runs the cell on them, stores
    its outputs and sends its new h to every CTA's buffer. The sums and the
    gate math are the plain version's (``op(h) @ w_hh + b_hh``,
    ``gru_cell`` / ``lstm_cell``), so the model differs from
    ``birnn_stack_plain`` only where the ownership or the exchange does."""
    L, N, _C = x.shape
    H, ng = layers[0][2].shape[1], n_gates(cell)
    cn, R = plan["CN"], plan["rows"]
    rows, units = simt_ownership(plan, cn)
    r_idx = np.broadcast_to(rows[:, :, :, None], rows.shape + (2,)).ravel()
    u_idx = np.broadcast_to(units[:, :, None, :], rows.shape + (2,)).ravel()
    inp, h_ns = x, []
    for wih, bih, whh, bhh in layers:
        flat = inp.float().reshape(L * N, -1)
        outs = []
        for d in (0, 1):
            xg = (flat @ wih[d].float() + bih[d]).reshape(L, N, ng * H)
            out = torch.zeros((L, N, H))
            hlast = torch.zeros((N, H))
            for row0 in range(0, N, R):
                nr = min(R, N - row0)
                hs = torch.zeros((cn, H, R))  # each CTA's h buffer, h0 = 0
                state = torch.zeros((nr, H))  # the LSTM's c, owned like h
                for s in range(L):
                    t = s if d == 0 else L - 1 - s
                    hnew = torch.zeros((R, H))
                    cnew = torch.zeros((R, H))
                    for c in range(cn):
                        h_tile = hs[c].T[:nr].contiguous()
                        hg = h_tile @ whh[d].float() + bhh[d]
                        if cell == "gru":
                            hc = gru_cell(xg[t, row0:row0 + nr], hg, h_tile)[0]
                            cc = state
                        else:
                            hc, cc = lstm_cell(xg[t, row0:row0 + nr] + hg, state)[:2]
                        # the threads of CTA c own units [c U, (c+1) U) of these rows
                        own = (u_idx >= c * plan["U"]) & (u_idx < (c + 1) * plan["U"])
                        own &= r_idx < nr
                        hnew[r_idx[own], u_idx[own]] = hc[r_idx[own], u_idx[own]]
                        cnew[r_idx[own], u_idx[own]] = cc[r_idx[own], u_idx[own]]
                    state = cnew[:nr]
                    out[t, row0:row0 + nr] = hnew[:nr]
                    # the exchange: unit u of row r to offset u R + r of every buffer
                    hs[:] = hnew.T
                hlast[row0:row0 + nr] = out[L - 1 if d == 0 else 0, row0:row0 + nr]
            h_ns.append(hlast)
            outs.append(out)
        inp = torch.cat(outs, dim=-1)
    return inp, torch.stack(h_ns)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden,rows", [(16, 13), (32, 70), (64, 5)])
def test_simt_model_is_bit_equal_to_the_plain_version(hidden, rows, cell):
    """In fp32 on the CPU the model of the kernel's ownership and exchange,
    over ragged row tiles and clusters of 1 and 2 CTAs, gives the plain
    version's out and h_n bit for bit."""
    rng = np.random.RandomState(hidden + rows)
    layers = [layer_weights(ld) for ld in init_rnn_params(rng, 11, hidden, 2, cell)]
    x = torch.from_numpy(rng.randn(7, rows, 11).astype(np.float32))
    plan = bigru.k1_plan(hidden, cell, torch.float32)
    out, hn = simt_model(layers, x, cell, plan)
    ref_out, ref_hn = bigru.birnn_stack_plain(layers, x, torch.float32, cell)
    assert torch.equal(out, ref_out) and torch.equal(hn, ref_hn)


@pytest.mark.parametrize("seq_len,d,ff,nhead", [(21, 256, 512, 4), (21, 64, 128, 4),
                                               (32, 256, 512, 8), (1, 32, 32, 2)])
def test_k3_plan_takes_the_model_shapes(seq_len, d, ff, nhead):
    plan = transenc.k3_plan(seq_len, d, ff, nhead)
    assert plan["design"] == "tc", plan
    assert plan["S"] == transenc.TC_ROWS // seq_len and plan["S"] * seq_len <= 64
    assert plan["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("seq_len,d,ff,nhead,dtype,why", [
    (21, 256, 512, 4, torch.float32, "fp32"),
    (33, 256, 512, 4, torch.bfloat16, "L >"),
    (21, 48, 128, 4, torch.bfloat16, "multiple of 32"),
    (21, 96, 128, 32, torch.bfloat16, "head width"),
    (21, 64, 128, 16, torch.bfloat16, "head width"),
    (21, 512, 1024, 8, torch.bfloat16, "shared memory"),
])
def test_k3_plan_sends_other_shapes_to_the_f32_kernel(seq_len, d, ff, nhead, dtype, why):
    """fp32 takes the simt design (f32 FMAs, tests/test_torch_transenc_layouts.py
    holds its own rule); the bf16 shapes here are refused by tc and take l2,
    the first f32-FMA kernel, in bf16."""
    plan = transenc.k3_plan(seq_len, d, ff, nhead, dtype)
    want = "simt" if dtype == torch.float32 else "l2"
    assert plan["design"] == want and why in plan["why"]


def _counts():
    return (bigru.launches, bigru.cuda_launches, dict(bigru.design_calls),
            transenc.launches, transenc.cuda_launches, dict(transenc.design_calls))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_cpu_stack_launches_nothing(cell, dtype):
    """On a CPU tensor birnn_stack runs the plain version: it counts a plain
    call and no kernel call, design or CUDA launch."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(7)
    layers = [layer_weights(ld, dt) for ld in init_rnn_params(rng, 11, 16, 2, cell)]
    x = torch.from_numpy(rng.randn(5, 3, 11).astype(np.float32)).to(dt)
    before, plain = _counts(), bigru.plain_calls
    out, hn = bigru.birnn_stack(layers, x, dt, cell)
    assert _counts() == before and bigru.plain_calls == plain + 1
    ref_out, ref_hn = birnn_tm(layers, x, None, dt, cell)
    assert torch.equal(out, ref_out) and torch.equal(hn, ref_hn)


def _layer_counts():
    return (bigru.launches, bigru.cuda_launches, dict(bigru.design_calls),
            bigru.layer_launches, bigru.layer_cuda_launches,
            dict(bigru.layer_design_calls))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_cpu_layers_launch_nothing(cell, dtype):
    """On a CPU tensor K2 runs its plain version once a layer: it counts no
    K2 call, CUDA launch or design call, and nothing of K1's."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(9)
    layers = [layer_weights(ld, dt) for ld in init_rnn_params(rng, 11, 16, 2, cell)]
    x = torch.from_numpy(rng.randn(5, 3, 11).astype(np.float32)).to(dt)
    before, plain, k1_plain = _layer_counts(), bigru.layer_plain_calls, bigru.plain_calls
    out, hn = bigru.birnn_layers(layers, x, dt, cell)
    assert _layer_counts() == before
    assert (bigru.layer_plain_calls, bigru.plain_calls) == (plain + 2, k1_plain)
    ref_out, _ref_hn = birnn_tm(layers, x, None, dt, cell)
    assert torch.equal(out, ref_out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_encoder_launches_nothing(dtype):
    """On a CPU tensor encoder_pooled runs the plain version: it counts a
    plain call and no kernel call, design or CUDA launch."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(8)
    NL, L, D, FF = 2, 5, 32, 64
    shapes = {"wqkv": (NL, D, 3 * D), "wo": (NL, D, D), "w1": (NL, D, FF),
              "w2": (NL, FF, D), "bqkv": (NL, 3 * D), "bo": (NL, D), "b1": (NL, FF),
              "b2": (NL, D), "ln1s": (NL, D), "ln1b": (NL, D), "ln2s": (NL, D),
              "ln2b": (NL, D)}
    st = {k: torch.from_numpy(0.2 * rng.randn(*v).astype(np.float32))
          .to(dt if k.startswith("w") else torch.float32) for k, v in shapes.items()}
    x = torch.from_numpy(rng.randn(3, L, D).astype(np.float32)).to(dt)
    before, plain = _counts(), transenc.plain_calls
    got = transenc.encoder_pooled(st, x, dt, nhead=4)
    assert _counts() == before and transenc.plain_calls == plain + 1
    assert got.shape == (3, D) and bool(torch.isfinite(got).all())
